"""Speculative decoding for the port's serving hot path.

Port of ``localai_tpu/spec``: pluggable drafters (:mod:`.drafter`: a
co-located draft model, or self-drafting n-gram prompt lookup needing no
second model), a verify dispatch of gamma+1 tokens a slot
(``ModelRunner.verify_async``) and per-slot accept/rollback.
:class:`.engine.SpecEngine` is the scheduler-facing lane;
``engine.speculative.SpecDecoder`` stays as a thin shim over it."""

from localai_tpu_torch.engine.runner import SKIP
from localai_tpu_torch.spec.drafter import Drafter, ModelDrafter, NGramDrafter
from localai_tpu_torch.spec.engine import SpecEngine, build_spec_engine

__all__ = [
    "SKIP",
    "Drafter",
    "ModelDrafter",
    "NGramDrafter",
    "SpecEngine",
    "build_spec_engine",
]
