"""Weight ingestion: HF safetensors → stacked torch parameter dicts.

Port of ``localai_tpu/models/loader.py``: read the HF safetensors layout,
transpose to right-multiply convention, and stack per-layer tensors along
a leading axis. The ``safetensors`` package is not a dependency of the
port: :func:`read_safetensors_index` parses the format itself (an 8-byte
little-endian header length, a JSON header, then raw little-endian
tensor bytes) and each tensor is read on demand through
``torch.frombuffer``; :func:`write_safetensors` writes the format one
tensor at a time, and :func:`write_llama_checkpoint` the checkpoint
layout. Mixtral checkpoints (``block_sparse_moe.gate`` and
``experts.{j}.w1/w3/w2``) stack into the expert layout [L, E, K, N].

With ``quantization`` set, :func:`load_llama_params` quantizes each
layer's weights as they are read (``quant.quantize_layer``), so the
compute-dtype tree never exists whole on the device: Mixtral-8x7B is 93 GB
in bf16 and 46.7 GB in int8, and the card holds 80. The JAX package
quantizes the loaded tree; per-channel and per-group scales depend on
one layer's slice alone, so the bytes are the same.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

from localai_tpu_torch.models import quant
from localai_tpu_torch.models.llama import (
    LlamaConfig,
    param_shapes,
    torch_dtype,
)
from localai_tpu_torch.utils.device import resolve_device

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_hf_config(model_dir: str | Path) -> dict:
    with open(Path(model_dir) / "config.json") as f:
        return json.load(f)


def load_hf_config(model_dir: str | Path) -> LlamaConfig:
    """The language model's config: a llava composite checkpoint describes
    it in ``text_config``."""
    hf = read_hf_config(model_dir)
    if hf.get("model_type") == "llava":
        return LlamaConfig.from_hf(hf.get("text_config", {}))
    return LlamaConfig.from_hf(hf)


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
            dt = SAFETENSORS_DTYPES[info["dtype"]]
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
    quantization: str = "",
    group: int = 128,
    shard: Optional[Callable] = None,
    layers: Optional[range] = None,
) -> tuple[LlamaConfig, dict]:
    """Load an HF llama/mistral/qwen2/mixtral checkpoint into the
    stacked parameter dict, in ``dtype`` on ``device``. ``quantization``
    ("int8" / "int8_w8a8" / "int4") quantizes each layer's weights as they
    are read,
    giving what ``quant.quantize_params`` gives for the whole tree.
    ``shard(path, tensor)`` (a meshed rank's, from ``models.registry``;
    it quantizes too) takes each tensor as it is read — a top-level one
    whole (``("embed",)``), a layer weight one layer at a time
    (``("layers", name)``) — and returns what the rank keeps.
    ``layers`` (a pipeline stage's block, ``pipeline.stage_layers``; all
    of them when None) are the layers read."""
    model_dir = Path(model_dir)
    device = resolve_device(device)
    if hf is None:
        hf = read_hf_config(model_dir)
    # tensor-name layout: plain llama vs llava composite (the classic
    # language_model.model.* layout, or model.language_model.* in
    # transformers >= 4.52 exports)
    body, head = "model.", "lm_head.weight"
    is_llava = hf.get("model_type") == "llava"
    if is_llava:
        body, head = "language_model.model.", "language_model.lm_head.weight"
    if cfg is None:
        cfg = LlamaConfig.from_hf(hf.get("text_config", {}) if is_llava
                                  else hf)
    tensors = _open_safetensors(model_dir)
    if body + "embed_tokens.weight" not in tensors and \
            "model.language_model.embed_tokens.weight" in tensors:
        body, head = "model.language_model.", "lm_head.weight"
    dt = torch_dtype(dtype)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = read_tensor(tensors[name]).to(device=device, dtype=dt)
        return t.T.contiguous() if transpose else t

    def one_layer(key: str, i: int) -> torch.Tensor:
        L = f"{body}layers.{i}."
        if key in _MOE_EXPERTS and cfg.num_experts:
            # Mixtral: experts.{j}.w1/w3/w2 (gate/up/down) → [E, K, N]
            return torch.stack([
                get(f"{L}block_sparse_moe.experts.{j}."
                    f"{_MOE_EXPERTS[key]}.weight", True)
                for j in range(cfg.num_experts)])
        hf_name, transpose = _HF_LAYER_NAMES[key]
        return get(L + hf_name, transpose)

    keep = range(cfg.num_layers) if layers is None else layers

    def stack(key: str):
        if shard is not None:
            return quant.stack_layers(
                (shard(("layers", key), one_layer(key, i)) for i in keep),
                len(keep))
        return quant.stack_layers((
            quant.quantize_layer(key, one_layer(key, i), quantization,
                                 group) if quantization
            else one_layer(key, i) for i in keep), len(keep))

    keys = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    if cfg.num_experts:
        keys.append("moe_gate")
    keys += ["w_gate", "w_up", "w_down"]
    if cfg.attention_bias:
        keys += ["bq", "bk", "bv"]
    layers = {key: stack(key) for key in keys}
    embed = get(body + "embed_tokens.weight")
    params: dict = {
        "embed": (shard(("embed",), embed) if shard is not None
                  else quant.quantize_table(embed, 1, quantization, group)
                  if quantization else embed),
        "final_norm": get(body + "norm.weight"),
        "layers": layers,
    }
    del embed
    if not cfg.tie_word_embeddings:
        if head in tensors:
            w = get(head, transpose=True)
            params["lm_head"] = (
                shard(("lm_head",), w) if shard is not None
                else quant.quantize_table(w, 0, quantization, group)
                if quantization else w)
            del w
        else:
            cfg = LlamaConfig(**{**cfg.__dict__, "tie_word_embeddings": True})
    if shard is None:
        _check_shapes(cfg, params)
    return cfg, params


_HF_LAYER_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "moe_gate": ("block_sparse_moe.gate.weight", True),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
}
# Mixtral's per-expert names of the expert stacks (MixtralSparseMoeBlock:
# w1 gate, w3 up, w2 down)
_MOE_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def write_safetensors(path: str | Path,
                      tensors: Iterable[tuple[str, tuple, torch.dtype,
                                              Callable[[], torch.Tensor]]]
                      ) -> int:
    """Write a ``.safetensors`` file from (name, shape, dtype, getter)
    entries in file order: the header from the shapes, then each getter's
    tensor, cast to its dtype, one at a time, so the file never sits whole
    in host memory. Returns the bytes written."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    entries = list(tensors)
    header, offset = {}, 0
    for name, shape, dt, _get in entries:
        n = dt.itemsize
        for d in shape:
            n *= d
        header[name] = {"dtype": names[dt], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, shape, dt, get in entries:
            t = get().detach().to(dt).contiguous().to("cpu")
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != the "
                                 f"header's {tuple(shape)}")
            # flattened first: a 0-d tensor (a LoRA's alpha) has no byte view
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def write_llama_checkpoint(model_dir: str | Path, cfg: LlamaConfig,
                           params: dict, dtype: str = "float32") -> Path:
    """Write a stacked float parameter dict as an HF llama checkpoint
    (``config.json`` + one ``model.safetensors`` in ``dtype``, float32 or
    bfloat16), the layout :func:`load_llama_params` reads: so
    weights drawn once (a debug preset on the CPU) load identically on
    every device. Tensors are written one at a time, so a checkpoint
    never sits whole in host memory."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    dt = torch_dtype(dtype)
    tensors = {"model.embed_tokens.weight": lambda: params["embed"],
               "model.norm.weight": lambda: params["final_norm"]}
    for key, stacked in params["layers"].items():
        for i in range(cfg.num_layers):
            prefix = f"model.layers.{i}."
            if key in _MOE_EXPERTS and stacked.dim() == 4:
                for j in range(cfg.num_experts):
                    tensors[f"{prefix}block_sparse_moe.experts.{j}."
                            f"{_MOE_EXPERTS[key]}.weight"] = (
                        lambda t=stacked, i=i, j=j: t[i, j].T)
                continue
            hf, transpose = _HF_LAYER_NAMES[key]
            tensors[prefix + hf] = (
                lambda t=stacked, i=i, tr=transpose: t[i].T if tr else t[i])
    if "lm_head" in params:
        tensors["lm_head.weight"] = lambda: params["lm_head"].T
    write_safetensors(model_dir / "model.safetensors",
                      [(name, tuple(get().shape), dt, get)
                       for name, get in tensors.items()])
    extra = ({"model_type": "mixtral", "num_local_experts": cfg.num_experts,
              "num_experts_per_tok": cfg.num_experts_per_tok}
             if cfg.num_experts else {"model_type": "llama"})
    (model_dir / "config.json").write_text(json.dumps({
        **extra, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
        "rope_scaling": cfg.rope_scaling,
        "sliding_window": cfg.sliding_window}))
    return model_dir


def _check_shapes(cfg: LlamaConfig, params: dict) -> None:
    for name, v in param_shapes(cfg).items():
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for k, shape in items:
            t = params[name] if k is None else params[name][k]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"param {name}.{k}: shape "
                                 f"{tuple(t.shape)} != expected {shape}")


def read_checkpoint_tensors(model_dir: str | Path, dtype: str,
                            device: torch.device,
                            keep_f32: Callable[[str, torch.Tensor], bool]
                            ) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory by its HF name, on
    ``device``: float32 where ``keep_f32(name, tensor)`` holds, else
    ``dtype`` (the recurrent models' loaders)."""
    dt = torch_dtype(dtype)
    out = {}
    for name, entry in _open_safetensors(Path(model_dir)).items():
        t = read_tensor(entry)
        out[name] = t.to(device=device, dtype=torch.float32
                         if keep_f32(name, t) else dt)
    return out


def write_checkpoint(model_dir: str | Path, hf_config: dict,
                     params: dict[str, torch.Tensor]) -> Path:
    """``config.json`` + one ``model.safetensors`` holding ``params`` by
    name, each tensor in its own dtype (the recurrent models' HF layout
    is their parameter dict's)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(hf_config))
    write_safetensors(model_dir / "model.safetensors", [
        (name, tuple(t.shape), t.dtype, (lambda t=t: t))
        for name, t in params.items()])
    return model_dir
