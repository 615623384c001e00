"""Model resolution: a model ref → (config, params, tokenizer).

Port of ``localai_tpu/models/registry.py``. Refs:
  * a local dir with config.json + *.safetensors  → HF checkpoint
  * "debug:tiny" / "debug:small" / "debug:llama3-8b" ... → random-weight
    presets made on the target device from a seeded ``torch.Generator``
    (byte tokenizer; tests and synthetic serving)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from localai_tpu_torch.models.llama import LlamaConfig, init_params
from localai_tpu_torch.utils.device import resolve_device
from localai_tpu_torch.utils.tokenizer import (
    ByteTokenizer,
    Tokenizer,
    load_tokenizer,
)

# Synthetic presets: shapes only, random weights. "llama3-8b" matches
# Llama-3-8B's dimensions (own copy of the JAX package's table).
DEBUG_PRESETS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_position_embeddings=512,
        rope_theta=10000.0,
    ),
    "small": LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=4,
        num_heads=8, num_kv_heads=4, max_position_embeddings=2048,
    ),
    "tiny-moe": LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=96, num_layers=2,
        num_heads=4, num_kv_heads=2, max_position_embeddings=512,
        num_experts=4, num_experts_per_tok=2,
    ),
    "1b": LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
        tie_word_embeddings=True,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
    ),
}


@dataclasses.dataclass
class LoadedModel:
    cfg: LlamaConfig
    params: dict
    tokenizer: Tokenizer
    ref: str


def resolve_model(
    ref: str,
    model_path: str | Path = "models",
    dtype: str = "bfloat16",
    seed: int = 0,
    device: str | torch.device | None = "cuda",
) -> LoadedModel:
    dev = resolve_device(device)
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        if name not in DEBUG_PRESETS:
            raise ValueError(
                f"unknown debug preset {name!r}; have {sorted(DEBUG_PRESETS)}"
            )
        cfg = dataclasses.replace(DEBUG_PRESETS[name], dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return LoadedModel(cfg, init_params(cfg, gen, dev), ByteTokenizer(),
                           ref)

    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            from localai_tpu_torch.models.loader import (
                load_llama_params,
                read_hf_config,
            )

            hf = read_hf_config(cand)
            cfg, params = load_llama_params(cand, dtype=dtype, device=dev,
                                            hf=hf)
            cfg = dataclasses.replace(cfg, dtype=dtype)
            return LoadedModel(cfg, params, load_tokenizer(cand), ref)
    raise FileNotFoundError(
        f"model ref {ref!r} not found (looked for config.json under {ref} and "
        f"{Path(model_path) / ref})"
    )
