"""Compatibility shim over :mod:`localai_tpu_torch.spec`.

Port of ``localai_tpu/engine/speculative.py``: keeps the historical import
surface of the draft-model engine — :data:`SKIP`, the verify write
policy and mask, and :class:`SpecDecoder`, a SpecEngine that pairs a
target with a draft ModelRunner (the ``.draft`` attribute) — over the one
speculation path of :class:`localai_tpu_torch.spec.SpecEngine`."""

from __future__ import annotations

from localai_tpu_torch.engine.kvcache import verify_mask, verify_write  # noqa: F401
from localai_tpu_torch.engine.runner import SKIP, ModelRunner  # noqa: F401
from localai_tpu_torch.spec.drafter import ModelDrafter
from localai_tpu_torch.spec.engine import SpecEngine, build_spec_engine


class SpecDecoder(SpecEngine):
    """Target + draft-model speculation (the historical constructor).

    ``draft`` is a contiguous ModelRunner for the draft model; the target
    may use either KV layout. Each dispatch returns [gamma+1, S] token
    rows where SKIP (-1) marks positions past a slot's accepted window."""

    def __init__(self, target: ModelRunner, draft: ModelRunner,
                 gamma: int = 4):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft.cfg.vocab_size} != target vocab "
                f"{target.cfg.vocab_size} — speculative decoding needs a "
                "shared tokenizer")
        if draft.num_slots != target.num_slots:
            raise ValueError("draft and target must have equal slot counts")
        if draft.paged:
            raise ValueError(
                "the draft runner must be contiguous (its window steps "
                "run over slot rows; build it with paged=False)")
        super().__init__(target, ModelDrafter(draft, gamma), gamma=gamma)

    @property
    def draft(self) -> ModelRunner:
        return self.drafter.runner


def build_spec_decoder(target: ModelRunner, draft_ref: str, *,
                       model_path="models", gamma: int = 4,
                       dtype: str = "bfloat16") -> SpecEngine:
    """Resolve ``draft_ref`` and couple it to ``target`` (the legacy
    entry; new callers use :func:`localai_tpu_torch.spec.build_spec_engine`)."""
    return build_spec_engine(
        target, drafter="model", draft_ref=draft_ref,
        model_path=model_path, gamma=gamma, dtype=dtype)
