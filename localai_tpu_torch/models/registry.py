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
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    param_shapes,
    torch_dtype,
)
from localai_tpu_torch.models.quant import (
    QUANT_MODES,
    QuantizedTensor,
    _group_size,
    quantize_params,
)
from localai_tpu_torch.ops.qmatmul import pack_w4
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
    model_dir: Optional[Path] = None
    hf_type: str = ""                  # config.json model_type ("llava", ...)
    image_token_id: Optional[int] = None  # HF image_token_index when present


def resolve_model(
    ref: str,
    model_path: str | Path = "models",
    dtype: str = "bfloat16",
    seed: int = 0,
    device: str | torch.device | None = "cuda",
    quantization: str = "",
    mesh=None,
) -> LoadedModel:
    """``quantization`` ("int8" / "int8_w8a8" / "int4") gives the weights of
    ``quant.quantize_params``: a debug preset's drawn tree is quantized on
    the device, a checkpoint's layers as they are read (the bf16 tree of
    Mixtral-8x7B would not fit the card). With ``mesh`` (a
    tensor-parallel rank, ``parallel.mesh.Mesh``) the weights are this
    rank's slices, cut as each tensor is drawn or read (and quantized
    whole before it is cut, as the JAX package shards its quantized
    tree): the full tree never exists on one card."""
    dev = resolve_device(device)
    from localai_tpu_torch.parallel.pipeline import stage_layers
    from localai_tpu_torch.parallel.sharding import cuts

    full = resolve_config(ref, model_path)
    shard = _shard_fn(full, mesh, quantization, dev) if cuts(mesh) else None
    layers = stage_layers(full, mesh)
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        cfg = dataclasses.replace(DEBUG_PRESETS[name], dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev, shard=shard, layers=layers)
        if quantization and shard is None:
            params = quantize_params(params, quantization, device=dev)
        return LoadedModel(cfg, params, ByteTokenizer(), ref)

    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            from localai_tpu_torch.models.loader import (
                load_llama_params,
                read_hf_config,
            )

            hf = read_hf_config(cand)
            cfg, params = load_llama_params(cand, dtype=dtype, device=dev,
                                            hf=hf, quantization=quantization,
                                            shard=shard, layers=layers)
            cfg = dataclasses.replace(cfg, dtype=dtype)
            return LoadedModel(cfg, params, load_tokenizer(cand), ref,
                               model_dir=cand,
                               hf_type=hf.get("model_type", ""),
                               image_token_id=hf.get("image_token_index"))
    raise FileNotFoundError(
        f"model ref {ref!r} not found (looked for config.json under {ref} and "
        f"{Path(model_path) / ref})"
    )


def resolve_config(ref: str, model_path: str | Path = "models"
                   ) -> LlamaConfig:
    """A model ref's LlamaConfig without its weights (a debug preset's, or
    a checkpoint's config.json): the mesh is sized before anything
    loads."""
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        if name not in DEBUG_PRESETS:
            raise ValueError(
                f"unknown debug preset {name!r}; have {sorted(DEBUG_PRESETS)}"
            )
        return DEBUG_PRESETS[name]
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            from localai_tpu_torch.models.loader import load_hf_config

            return load_hf_config(cand)
    raise FileNotFoundError(
        f"model ref {ref!r} not found (looked for config.json under {ref} and "
        f"{Path(model_path) / ref})"
    )


def _shard_fn(cfg: LlamaConfig, mesh, quantization: str,
              device: torch.device):
    """``shard(path, tensor)`` for ``init_params`` and the loader: the
    leaf quantized whole as ``quantize_params`` would (when asked), then
    this rank's slice."""
    from localai_tpu_torch.models.quant import (
        quantize_layer,
        quantize_table,
    )
    from localai_tpu_torch.parallel import sharding as shd

    top = shd.make_shard_fn(cfg, mesh)
    layer = shd.layer_shard_fn(cfg, mesh)

    def shard(path: tuple, t):
        t = t.to(device)
        if path[0] == "layers":
            if quantization:
                t = quantize_layer(path[1], t, quantization)
            return layer(path[1], t)
        if quantization and path[0] in ("embed", "lm_head"):
            t = quantize_table(t, 1 if path[0] == "embed" else 0,
                               quantization)
        return top(path, t)

    return shard


def synthetic_quantized_params(
        cfg: LlamaConfig, mode: str = "int8", group: int = 128,
        seed: int = 0, device: str | torch.device | None = "cuda") -> dict:
    """Random weights drawn directly in quantized form, as the JAX
    package's ``synthetic_quantized_params``: a model whose bf16 tree does
    not fit the card (Mixtral-8x7B: 93 GB) does in int8 (46.7 GB).

    Shapes, dtypes, axes and scales are the JAX package's: every matmul
    weight is uniform random int8 bits clamped to [-127, 127] (``mode``
    "int8", or "int8_w8a8" with embed, lm_head and the layer matmuls in
    mode w8a8), or their arithmetic high nibble clamped to [-7, 7] in
    groups of ``group`` (``"int4"``, packed by ``pack_w4``), with the
    constant
    scale 0.02 / 127 (or / 7), so activations stay in the range of
    ``init_params``' N(0, 0.02) draws; embed is per-row int8 in both
    modes; expert stacks [L, E, K, N] are per-channel int8 over K in both;
    norms are ones, qkv biases zeros, and the router N(0, 0.02) in the
    compute dtype. The values are drawn by a seeded ``torch.Generator`` on
    ``device``, so they differ from the JAX package's. Each stack is drawn
    one [K, N] matrix at a time into its int8 storage: no f32 or int64
    temporary of a whole stack exists."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unsupported synthetic quant mode {mode!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    shapes = param_shapes(cfg)

    def bits(shape) -> torch.Tensor:
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8, device=dev)

    mm8 = "w8a8" if mode == "int8_w8a8" else "w8"

    def qweight(shape, axis, nbits, mm="w8"):
        lead = int(np.prod(shape[:-2], dtype=np.int64))
        if nbits == 4:
            K = shape[axis]
            g = _group_size(K, group)
            qshape = shape[:axis] + (K // 2,) + shape[axis + 1:]
            sshape = shape[:axis] + (K // g,) + shape[axis + 1:]
            q = torch.empty(qshape, dtype=torch.uint8, device=dev)
            for r in q.view(lead, *qshape[-2:]):
                r.copy_(pack_w4((bits(shape[-2:]) >> 4).clamp_(min=-7),
                                axis - len(shape) + 2))
            return QuantizedTensor(q, torch.full(sshape, 0.02 / 7,
                                                 device=dev), axis, "w4", g)
        q = torch.empty(shape, dtype=torch.int8, device=dev)
        for r in q.view(lead, *shape[-2:]):
            r.copy_(bits(shape[-2:]).clamp_(min=-127))
        sshape = shape[:axis] + shape[axis + 1:]
        return QuantizedTensor(q, torch.full(sshape, 0.02 / 127, device=dev),
                               axis, mm)

    def router(shape) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=dev)
        for r in out:
            r.copy_(torch.randn(r.shape, generator=gen, device=dev) * 0.02)
        return out

    bits_mm = 4 if mode == "int4" else 8
    params: dict = {
        # embeddings stay int8 in int4 mode too (quant.quantize_params)
        "embed": qweight(shapes["embed"], 1, 8, mm8),
        "final_norm": torch.ones(shapes["final_norm"], dtype=dtype,
                                 device=dev),
    }
    if "lm_head" in shapes:
        params["lm_head"] = qweight(shapes["lm_head"], 0, bits_mm, mm8)
    layers = {}
    for name, shape in shapes["layers"].items():
        if name in ("attn_norm", "mlp_norm"):
            layers[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif name in ("bq", "bk", "bv"):
            layers[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif name == "moe_gate":   # the router stays in the compute dtype
            layers[name] = router(shape)
        elif len(shape) == 4:      # expert stacks: int8 in every mode
            layers[name] = qweight(shape, 2, 8)
        else:
            layers[name] = qweight(shape, 1, bits_mm, mm8)
    params["layers"] = layers
    return params


def resolve_tokenizer(ref: str, model_path: str | Path = "models"
                      ) -> Tokenizer:
    """Tokenizer-only resolution, never touching weights (the tokenize
    CLI must not read gigabytes of parameters to encode a string)."""
    if ref.startswith("debug:"):
        return ByteTokenizer()
    for cand in (Path(ref), Path(model_path) / ref):
        if cand.is_dir():
            return load_tokenizer(cand)
    raise FileNotFoundError(f"model ref {ref!r} not found under {model_path}")
