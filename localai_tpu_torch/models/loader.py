"""Weight ingestion: HF safetensors → stacked torch parameter dicts.

Port of ``localai_tpu/models/loader.py``: read the HF safetensors layout,
transpose to right-multiply convention, and stack per-layer tensors along
a leading axis. The ``safetensors`` package is not a dependency of the
port: :func:`read_safetensors_index` parses the format itself (an 8-byte
little-endian header length, a JSON header, then raw little-endian
tensor bytes) and each tensor is read on demand through
``torch.frombuffer``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional

import torch

from localai_tpu_torch.models.llama import (
    LlamaConfig,
    param_shapes,
    torch_dtype,
)
from localai_tpu_torch.utils.device import resolve_device

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_hf_config(model_dir: str | Path) -> dict:
    with open(Path(model_dir) / "config.json") as f:
        return json.load(f)


def read_safetensors_index(path: str | Path) -> dict[str, tuple]:
    """name → (path, byte offset, byte count, torch dtype, shape) for every
    tensor of one .safetensors file."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        try:
            dt = _ST_DTYPES[info["dtype"]]
        except KeyError:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{info['dtype']}") from None
        out[name] = (path, 8 + n + begin, end - begin, dt,
                     tuple(info["shape"]))
    return out


def read_tensor(entry: tuple) -> torch.Tensor:
    """Read one indexed tensor into a CPU tensor."""
    path, offset, nbytes, dt, shape = entry
    if nbytes == 0:
        return torch.empty(shape, dtype=dt)
    buf = bytearray(nbytes)
    with open(path, "rb") as f:
        f.seek(offset)
        f.readinto(buf)
    return torch.frombuffer(buf, dtype=dt).reshape(shape)


def _open_safetensors(model_dir: Path) -> dict[str, tuple]:
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    tensors: dict[str, tuple] = {}
    for fp in files:
        tensors.update(read_safetensors_index(fp))
    return tensors


def load_llama_params(
    model_dir: str | Path,
    cfg: Optional[LlamaConfig] = None,
    dtype: str = "bfloat16",
    device: str | torch.device = "cuda",
    hf: Optional[dict] = None,
) -> tuple[LlamaConfig, dict]:
    """Load an HF llama/mistral/qwen2 checkpoint into the stacked
    parameter dict, in ``dtype`` on ``device``."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    if hf is None:
        hf = read_hf_config(model_dir)
    body, head = "model.", "lm_head.weight"
    if cfg is None:
        cfg = LlamaConfig.from_hf(hf)
    tensors = _open_safetensors(model_dir)
    dt = torch_dtype(dtype)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = read_tensor(tensors[name]).to(device=device, dtype=dt)
        return t.T.contiguous() if transpose else t

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return torch.stack([get(fmt.format(i=i), transpose)
                            for i in range(cfg.num_layers)])

    param_shapes(cfg)  # MoE checkpoints raise here: not ported yet
    L = body + "layers.{i}."
    layers = {
        "attn_norm": stack(L + "input_layernorm.weight", False),
        "wq": stack(L + "self_attn.q_proj.weight", True),
        "wk": stack(L + "self_attn.k_proj.weight", True),
        "wv": stack(L + "self_attn.v_proj.weight", True),
        "wo": stack(L + "self_attn.o_proj.weight", True),
        "mlp_norm": stack(L + "post_attention_layernorm.weight", False),
        "w_gate": stack(L + "mlp.gate_proj.weight", True),
        "w_up": stack(L + "mlp.up_proj.weight", True),
        "w_down": stack(L + "mlp.down_proj.weight", True),
    }
    if cfg.attention_bias:
        layers["bq"] = stack(L + "self_attn.q_proj.bias", False)
        layers["bk"] = stack(L + "self_attn.k_proj.bias", False)
        layers["bv"] = stack(L + "self_attn.v_proj.bias", False)
    params: dict = {
        "embed": get(body + "embed_tokens.weight"),
        "final_norm": get(body + "norm.weight"),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        if head in tensors:
            params["lm_head"] = get(head, transpose=True)
        else:
            cfg = LlamaConfig(**{**cfg.__dict__, "tie_word_embeddings": True})
    _check_shapes(cfg, params)
    return cfg, params


def _check_shapes(cfg: LlamaConfig, params: dict) -> None:
    for name, v in param_shapes(cfg).items():
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for k, shape in items:
            t = params[name] if k is None else params[name][k]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"param {name}.{k}: shape "
                                 f"{tuple(t.shape)} != expected {shape}")
