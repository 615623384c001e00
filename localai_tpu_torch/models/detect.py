"""Backend auto-detection: checkpoint layout → engine family.

Port of ``localai_tpu/models/detect.py``: when a config names no
backend, its checkpoint's layout says which engine serves it (a
diffusers pipeline, whisper, vits, mamba, rwkv, or a bert-class encoder —
a cross-encoder when it has a ``classifier.weight``, else a sentence
encoder); otherwise the LLM engine serves it and its chat defaults are
guessed from the family (``config.guesser``). The safetensors keys are
read with the port's own reader (``models.loader.read_safetensors_index``).
The config loader refuses a detected backend the port has no engine for.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

# bert-class checkpoints split on the scoring head: with a classifier
# they're cross-encoders (rerank), without one they're sentence encoders
# (embeddings).
_BERT_TYPES = ("bert", "roberta", "xlm-roberta")

_DEBUG_BACKENDS = [
    ("sd-", "diffusers"),
    ("whisper", "whisper"),
    ("reranker", "reranker"),
    ("bert", "bert-embeddings"),
    ("mamba", "mamba"),
    ("rwkv", "rwkv"),
]


def detect_backend(ref: str, model_path: str | Path = "models"
                   ) -> Optional[str]:
    """Sniff a checkpoint ref; returns a backend name ("diffusers",
    "whisper", "reranker", ...) or None for the default LLM engine / when
    the files are not present yet."""
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        for prefix, backend in _DEBUG_BACKENDS:
            if name.startswith(prefix):
                return backend
        return None
    for cand in (Path(ref), Path(model_path) / ref):
        if not cand.is_dir():
            continue
        # diffusers pipeline layout beats everything: its config.json (if
        # any) describes a component, not the pipeline
        if (cand / "model_index.json").exists() or (cand / "unet").is_dir():
            return "diffusers"
        cj = cand / "config.json"
        if cj.exists():
            try:
                hf = json.loads(cj.read_text())
            except ValueError:
                return None
            mt = str(hf.get("model_type", ""))
            if mt == "whisper":
                return "whisper"
            if mt == "vits":
                return "vits"
            if mt in ("mamba", "mamba2"):
                return "mamba"
            if mt == "rwkv":
                return "rwkv"
            if mt in _BERT_TYPES:
                return (
                    "reranker" if _has_classifier(cand)
                    else "bert-embeddings"
                )
            return None
    return None


def _has_classifier(model_dir: Path) -> bool:
    try:
        from localai_tpu_torch.models.loader import read_safetensors_index

        for fp in sorted(model_dir.glob("*.safetensors")):
            if "classifier.weight" in read_safetensors_index(fp):
                return True
    except Exception as e:  # noqa: BLE001 — sniff failure → embedder
        log.debug("classifier sniff failed for %s: %s", model_dir, e)
    return False


def autodetect_config(cfg, model_path: str | Path) -> None:
    """Fill ModelConfig.backend for a bare `model:` YAML so endpoint
    routing lands on the right engine; for the LLM engine, guess chat
    defaults by family."""
    if not cfg.backend:
        detected = detect_backend(cfg.model or cfg.name, model_path)
        if detected:
            log.info("model %s: detected %s checkpoint", cfg.name, detected)
            cfg.backend = detected
    if not cfg.backend:  # LLM engine: guess chat defaults by family
        from localai_tpu_torch.config.guesser import guess_chat_defaults

        guess_chat_defaults(cfg, model_path)
