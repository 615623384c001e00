"""GGUF ingestion for the port: read llama.cpp checkpoints and convert
them to the checkpoint layout the port serves.

Port of ``localai_tpu/utils/gguf.py`` (the port imports nothing of the
JAX package, and the card's machine has neither ``gguf``, ``safetensors``
nor ``ml_dtypes``): :class:`GGUFFile` reads the header, metadata and
tensor descriptors of a GGUF v2/v3 file; the block dequantizers
(f32/f16/q8_0/q4_0/q4_1/q4_k/q6_k, vectorized numpy) are the JAX
package's, byte for byte; :func:`convert_gguf` un-permutes llama.cpp's
rotary rows, splits Mixtral's stacked experts into per-expert names and
writes ``config.json``, ``model.safetensors``, ``tokenizer.json`` and
``tokenizer_config.json`` as the JAX package does.

One divergence, intended: the JAX package gathers every converted tensor
in one dict before ``safetensors`` writes it (93 GB of host memory for
Mixtral-8x7B in bf16). Here ``models.loader.write_safetensors`` writes
the file from its header, reading and converting one tensor at a time
(one expert stack at a time for a MoE), through torch, which rounds f32
to bf16 to nearest even as ``ml_dtypes`` does: the tensors are equal bit
for bit.

Format reference: the public ggml/GGUF spec (v2/v3 little-endian): header
(magic 'GGUF', version, tensor count, kv count), metadata KVs, tensor
descriptors (name, dims, dtype, offset), then alignment-padded data.
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

log = logging.getLogger(__name__)

MAGIC = b"GGUF"

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 \
    = range(13)
_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}

# tensor dtypes (ggml_type)
F32, F16, Q4_0, Q4_1, Q8_0 = 0, 1, 2, 3, 8
Q4_K, Q6_K = 12, 14
_BLOCK = {  # dtype → (elements per block, bytes per block)
    F32: (1, 4), F16: (1, 2),
    Q4_0: (32, 18), Q4_1: (32, 20), Q8_0: (32, 34),
    Q4_K: (256, 144), Q6_K: (256, 210),
}


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype in _SCALAR_FMT:
        return _read(f, _SCALAR_FMT[vtype])
    if vtype == _BOOL:
        return bool(_read(f, "<B"))
    if vtype == _STR:
        return _read_string(f)
    if vtype == _ARR:
        etype = _read(f, "<I")
        n = _read(f, "<Q")
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown GGUF metadata type {vtype}")


class GGUFFile:
    """Parsed GGUF: ``metadata`` dict + ``tensors`` name → (dtype, shape,
    absolute data offset). ``load_tensor`` dequantizes to float32."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, tuple[int, tuple[int, ...], int]] = {}
        with open(self.path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            self.version = _read(f, "<I")
            if self.version < 2:
                raise ValueError(f"GGUF v{self.version} not supported (v2+)")
            n_tensors = _read(f, "<Q")
            n_kv = _read(f, "<Q")
            for _ in range(n_kv):
                key = _read_string(f)
                vtype = _read(f, "<I")
                self.metadata[key] = _read_value(f, vtype)
            infos = []
            for _ in range(n_tensors):
                name = _read_string(f)
                n_dims = _read(f, "<I")
                # GGUF dims are stored innermost-first (ggml ne[]); numpy
                # shape is the reverse
                dims = [_read(f, "<Q") for _ in range(n_dims)]
                dtype = _read(f, "<I")
                offset = _read(f, "<Q")
                infos.append((name, dtype, tuple(reversed(dims)), offset))
            align = int(self.metadata.get("general.alignment", 32))
            base = f.tell()
            base = (base + align - 1) // align * align
            for name, dtype, shape, offset in infos:
                self.tensors[name] = (dtype, shape, base + offset)

    def load_tensor(self, name: str) -> np.ndarray:
        dtype, shape, offset = self.tensors[name]
        if dtype not in _BLOCK:
            raise ValueError(f"{name}: unsupported ggml dtype {dtype}")
        n = int(np.prod(shape))
        per, nbytes = _BLOCK[dtype]
        if n % per:
            raise ValueError(f"{name}: {n} elements not divisible by {per}")
        blocks = n // per
        with open(self.path, "rb") as f:
            f.seek(offset)
            raw = f.read(blocks * nbytes)
        return _DEQUANT[dtype](raw, blocks).reshape(shape)


# -- block dequantizers (vectorized numpy) ----------------------------------


def _dq_f32(raw: bytes, blocks: int) -> np.ndarray:
    return np.frombuffer(raw, np.float32).copy()


def _dq_f16(raw: bytes, blocks: int) -> np.ndarray:
    return np.frombuffer(raw, np.float16).astype(np.float32)


def _dq_q8_0(raw: bytes, blocks: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(blocks, 34)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)   # [B, 1]
    q = b[:, 2:].view(np.int8).astype(np.float32)             # [B, 32]
    return (d * q).reshape(-1)


def _nibbles(qs: np.ndarray) -> np.ndarray:
    """[B, 16] bytes → [B, 32] values: low nibbles then high nibbles
    (llama.cpp q4 layout: element j pairs with j+16)."""
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1)


def _dq_q4_0(raw: bytes, blocks: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(blocks, 18)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    q = _nibbles(b[:, 2:])
    return (d * (q - 8.0)).reshape(-1)


def _dq_q4_1(raw: bytes, blocks: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(blocks, 20)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _nibbles(b[:, 4:])
    return (d * q + m).reshape(-1)


def _q4k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 packed bytes → (8 six-bit scales, 8 six-bit mins) per block
    (ggml get_scale_min_k4)."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for i in range(4):
        sc[..., i] = (s[..., i] & 63)
        mn[..., i] = (s[..., i + 4] & 63)
        sc[..., i + 4] = (s[..., i + 8] & 0x0F) | ((s[..., i] >> 6) << 4)
        mn[..., i + 4] = (s[..., i + 8] >> 4) | ((s[..., i + 4] >> 6) << 4)
    return sc, mn


def _dq_q4_k(raw: bytes, blocks: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(blocks, 144)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)       # [B,1]
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _q4k_scale_min(b[:, 4:16])                           # [B,8]
    qs = b[:, 16:]                                                # [B,128]
    out = np.empty((blocks, 256), np.float32)
    # 4 chunks of 64 values; chunk c uses scales 2c (low nibbles) and
    # 2c+1 (high nibbles) over the same 32 bytes
    for c in range(4):
        chunk = qs[:, 32 * c: 32 * (c + 1)]
        lo = (chunk & 0x0F).astype(np.float32)
        hi = (chunk >> 4).astype(np.float32)
        out[:, 64 * c: 64 * c + 32] = \
            d * sc[:, 2 * c: 2 * c + 1] * lo - dmin * mn[:, 2 * c: 2 * c + 1]
        out[:, 64 * c + 32: 64 * c + 64] = \
            d * sc[:, 2 * c + 1: 2 * c + 2] * hi \
            - dmin * mn[:, 2 * c + 1: 2 * c + 2]
    return out.reshape(-1)


def _dq_q6_k(raw: bytes, blocks: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(blocks, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)           # [B,16]
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)  # [B,1]
    out = np.empty((blocks, 256), np.float32)
    # two 128-value halves, each from 64 ql bytes + 32 qh bytes
    for half in range(2):
        qlh = ql[:, 64 * half: 64 * (half + 1)]
        qhh = qh[:, 32 * half: 32 * (half + 1)]
        base = 128 * half
        q1 = (qlh[:, :32] & 0x0F) | ((qhh & 0x03) << 4)
        q2 = (qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 0x03) << 4)
        q3 = (qlh[:, :32] >> 4) | (((qhh >> 4) & 0x03) << 4)
        q4 = (qlh[:, 32:] >> 4) | (((qhh >> 6) & 0x03) << 4)
        for j, q in enumerate((q1, q2, q3, q4)):
            vals = q.astype(np.float32) - 32.0
            for s in range(2):  # each 32-value span covers 2 sub-scales
                si = 8 * half + 2 * j + s
                seg = vals[:, 16 * s: 16 * (s + 1)]
                out[:, base + 32 * j + 16 * s: base + 32 * j + 16 * (s + 1)] \
                    = d * sc[:, si: si + 1] * seg
    return out.reshape(-1)


_DEQUANT = {
    F32: _dq_f32, F16: _dq_f16, Q8_0: _dq_q8_0,
    Q4_0: _dq_q4_0, Q4_1: _dq_q4_1, Q4_K: _dq_q4_k, Q6_K: _dq_q6_k,
}


# -- conversion -------------------------------------------------------------

_OUT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
               "float16": torch.float16}


def _unpermute(w: np.ndarray, n_head: int) -> np.ndarray:
    """Invert llama.cpp's rotary row permutation on wq/wk. The HF→GGUF
    convert script applies P = reshape(head, 2, hd/2).swapaxes(1, 2); P is
    not an involution, so the inverse reads the permuted rows as
    (head, hd/2, 2) and swaps back."""
    out_dim = w.shape[0]
    return (w.reshape(n_head, out_dim // n_head // 2, 2, *w.shape[1:])
            .swapaxes(1, 2).reshape(w.shape))


def gguf_to_hf_config(meta: dict) -> dict:
    """GGUF llama metadata → HF config.json dict (the converse of the
    GGUF guesser of LocalAI, core/config/guesser.go)."""
    arch = meta.get("general.architecture", "llama")

    def g(key, default=None):
        return meta.get(f"{arch}.{key}", default)

    heads = int(g("attention.head_count", 32))
    cfg = {
        "model_type": arch,
        "vocab_size": int(meta.get(
            f"{arch}.vocab_size",
            len(meta.get("tokenizer.ggml.tokens", [])) or 32000)),
        "hidden_size": int(g("embedding_length", 4096)),
        "intermediate_size": int(g("feed_forward_length", 11008)),
        "num_hidden_layers": int(g("block_count", 32)),
        "num_attention_heads": heads,
        "num_key_value_heads": int(g("attention.head_count_kv", heads)),
        "max_position_embeddings": int(g("context_length", 4096)),
        "rope_theta": float(g("rope.freq_base", 10000.0)),
        "rms_norm_eps": float(
            g("attention.layer_norm_rms_epsilon", 1e-5)),
        "tie_word_embeddings": False,
    }
    # special token ids: stopping + the family guesser
    # (config.guesser.identify_family keys on them, as guesser.go does)
    for hf_key, gg_key in (("bos_token_id", "tokenizer.ggml.bos_token_id"),
                           ("eos_token_id", "tokenizer.ggml.eos_token_id")):
        if gg_key in meta:
            cfg[hf_key] = int(meta[gg_key])
    # Mixtral-class MoE ({arch}.expert_count / expert_used_count)
    ec = g("expert_count")
    if ec:
        cfg["num_local_experts"] = int(ec)
        cfg["num_experts_per_tok"] = int(g("expert_used_count", 2))
    # non-default head_dim ({arch}.attention.key_length — e.g. gemma-style
    # wide heads): without it the converted checkpoint gets wrong shapes
    key_len = g("attention.key_length")
    if key_len is not None and int(key_len) != cfg["hidden_size"] // heads:
        cfg["head_dim"] = int(key_len)
    # rope scaling ({arch}.rope.scaling.*): a Llama-3.1-class GGUF converted
    # without this serves silently wrong RoPE beyond the base context
    stype = g("rope.scaling.type")
    if stype and stype != "none":
        rope_type = {"linear": "linear", "yarn": "yarn",
                     "llama3": "llama3"}.get(str(stype))
        if rope_type is None:
            log.warning(
                "gguf: unsupported rope scaling type %r — emitting config "
                "without rope_scaling (long-context behavior will differ)",
                stype,
            )
        else:
            rs: dict = {"rope_type": rope_type}
            factor = g("rope.scaling.factor")
            if factor is not None:
                rs["factor"] = float(factor)
            octx = g("rope.scaling.original_context_length")
            if octx is not None:
                rs["original_max_position_embeddings"] = int(octx)
            attn_f = g("rope.scaling.attn_factor")
            if attn_f is not None:
                rs["attention_factor"] = float(attn_f)
            cfg["rope_scaling"] = rs
    return cfg


# GGUF tensor name → HF name (llama family)
def _hf_name(name: str) -> str | None:
    if name == "token_embd.weight":
        return "model.embed_tokens.weight"
    if name == "output_norm.weight":
        return "model.norm.weight"
    if name == "output.weight":
        return "lm_head.weight"
    if name.startswith("blk."):
        _, idx, rest = name.split(".", 2)
        mapping = {
            "attn_q.weight": "self_attn.q_proj.weight",
            "attn_k.weight": "self_attn.k_proj.weight",
            "attn_v.weight": "self_attn.v_proj.weight",
            "attn_output.weight": "self_attn.o_proj.weight",
            "ffn_gate.weight": "mlp.gate_proj.weight",
            "ffn_up.weight": "mlp.up_proj.weight",
            "ffn_down.weight": "mlp.down_proj.weight",
            "attn_norm.weight": "input_layernorm.weight",
            "ffn_norm.weight": "post_attention_layernorm.weight",
            "ffn_gate_inp.weight": "block_sparse_moe.gate.weight",
            # qwen2-family qkv biases
            "attn_q.bias": "self_attn.q_proj.bias",
            "attn_k.bias": "self_attn.k_proj.bias",
            "attn_v.bias": "self_attn.v_proj.bias",
        }
        if rest in mapping:
            return f"model.layers.{idx}.{mapping[rest]}"
    return None


# llama.cpp's expert-stacked MoE tensors → per-expert HF names (w1=gate,
# w3=up, w2=down, matching MixtralSparseMoeBlock)
_MOE_STACKED = {
    "ffn_gate_exps.weight": "w1",
    "ffn_up_exps.weight": "w3",
    "ffn_down_exps.weight": "w2",
}


def convert_gguf(src: str | Path, out_dir: str | Path,
                 dtype: str = "bfloat16") -> Path:
    """model.gguf → HF-shaped checkpoint dir (config.json +
    model.safetensors, plus tokenizer.json / tokenizer_config.json when
    the GGUF carries a vocabulary / chat template) that the port's loader
    serves. Tensors stream one at a time (see the module docstring).
    Returns out_dir."""
    from localai_tpu_torch.models.loader import write_safetensors

    if dtype not in _OUT_DTYPES:
        raise ValueError(f"unsupported output dtype {dtype!r} (have "
                         f"{sorted(_OUT_DTYPES)})")
    gg = GGUFFile(src)
    hf = gguf_to_hf_config(gg.metadata)
    heads = hf["num_attention_heads"]
    kv_heads = hf["num_key_value_heads"]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    unpermute = hf.get("model_type") in ("llama", "mistral")

    # (name, shape, getter) in the JAX package's order; an expert stack is
    # dequantized once, when its first expert is written
    held: dict[str, np.ndarray] = {}

    def stacked(name: str) -> np.ndarray:
        if name not in held:
            held.clear()
            held[name] = gg.load_tensor(name)
        return held[name]

    def plain(name: str) -> torch.Tensor:
        held.clear()
        w = gg.load_tensor(name)
        # llama.cpp's HF→GGUF convert permutes q/k rows ONLY for the
        # llama/mistral architectures; qwen2-class GGUFs store HF order
        if unpermute:
            if name.endswith("attn_q.weight"):
                w = _unpermute(w, heads)
            elif name.endswith("attn_k.weight"):
                w = _unpermute(w, kv_heads)
        return torch.from_numpy(np.ascontiguousarray(w))

    entries = []
    skipped = []
    for name, (_dt, shape, _off) in gg.tensors.items():
        if name.startswith("blk.") and name.split(".", 2)[2] in _MOE_STACKED:
            # expert-stacked [E, N, K] → per-expert Mixtral names
            _, idx, rest = name.split(".", 2)
            wname = _MOE_STACKED[rest]
            for j in range(shape[0]):
                entries.append((
                    f"model.layers.{idx}.block_sparse_moe."
                    f"experts.{j}.{wname}.weight", shape[1:],
                    lambda n=name, j=j: torch.from_numpy(stacked(n)[j])))
            continue
        hf_name = _hf_name(name)
        if hf_name is None:
            skipped.append(name)
            continue
        entries.append((hf_name, shape, lambda n=name: plain(n)))
    if skipped:
        log.info("convert: skipped %d non-llama tensors (%s...)",
                 len(skipped), skipped[:3])
    if "lm_head.weight" not in {e[0] for e in entries}:
        hf["tie_word_embeddings"] = True
    dt = _OUT_DTYPES[dtype]
    write_safetensors(out_dir / "model.safetensors",
                      [(n, s, dt, g) for n, s, g in entries])
    held.clear()
    with open(out_dir / "config.json", "w") as f:
        json.dump(hf, f, indent=1)

    # tokenizer: carry the GGUF vocab over as a minimal tokenizer.json so
    # ids→text decoding matches the source model (byte-level fallback when
    # the source has no vocab)
    toks = gg.metadata.get("tokenizer.ggml.tokens")
    if toks:
        vocab = {t: i for i, t in enumerate(toks)}
        with open(out_dir / "tokenizer.json", "w") as f:
            json.dump({
                "version": "1.0",
                "model": {"type": "WordLevel", "vocab": vocab,
                          "unk_token": toks[0]},
                "added_tokens": [],
            }, f)
    # carry the source's chat template so serving formats prompts the way
    # the model was trained (template-less sources fall to the family
    # guesser at config load — config/guesser.py)
    chat_tmpl = gg.metadata.get("tokenizer.chat_template")
    if chat_tmpl:
        with open(out_dir / "tokenizer_config.json", "w") as f:
            json.dump({"chat_template": chat_tmpl}, f)
    return out_dir
