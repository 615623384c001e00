"""T5 text encoder (encoder-only) in plain torch: FLUX's sequence
conditioning.

Port of ``localai_tpu/image/t5.py``: the encoder stack of HF
``T5EncoderModel`` (relative-position-bias attention without the
1/sqrt(d) scale, pre-RMSNorm, gated tanh-GELU feed-forward, no biases).
The position bias is computed once and shared by every layer, as there;
the layer loop runs over the stacked weights (``[L, ...]`` leaves,
linears [in, out]). Scores, softmax and the RMS norms run in float32;
every other product in the config's dtype (float32 in the JAX package
and here). No hand-written kernel is on this path: the JAX package runs
it in XLA.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Optional

import torch
import torch.nn.functional as F

from localai_tpu_torch.image.unet import torch_dtype

PyTree = Any


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 512
    dtype: str = "float32"

    @classmethod
    def from_hf(cls, hf: dict) -> "T5Config":
        return cls(
            vocab_size=hf.get("vocab_size", 32128),
            d_model=hf.get("d_model", 4096),
            d_kv=hf.get("d_kv", 64),
            d_ff=hf.get("d_ff", 10240),
            num_layers=hf.get("num_layers", 24),
            num_heads=hf.get("num_heads", 64),
            relative_attention_num_buckets=hf.get(
                "relative_attention_num_buckets", 32),
            relative_attention_max_distance=hf.get(
                "relative_attention_max_distance", 128),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-6),
        )


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def relative_buckets(rel_pos: torch.Tensor, num_buckets: int,
                     max_dist: int) -> torch.Tensor:
    """HF T5's bidirectional relative-position bucketing."""
    nb = num_buckets // 2
    ret = torch.where(rel_pos > 0, nb, 0)
    n = rel_pos.abs()
    max_exact = nb // 2
    is_small = n < max_exact
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / float(math.log(max_dist / max_exact)) * (nb - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return ret + torch.where(is_small, n, large)


def position_bias(cfg: T5Config, rel_embed: torch.Tensor, T: int
                  ) -> torch.Tensor:
    """[H, T, T] float32, shared by every layer."""
    pos = torch.arange(T, device=rel_embed.device)
    buckets = relative_buckets(
        pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    return rel_embed[buckets].permute(2, 0, 1).float()


def encode(cfg: T5Config, params: PyTree, tokens: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, T] → hidden states [B, T, D]. ``mask`` [B, T] bool
    (True = a real token); None attends everywhere, as diffusers' FLUX
    text encoding does over the padded sequence."""
    H, dk = cfg.num_heads, cfg.d_kv
    dt = torch_dtype(cfg.dtype)
    eps = cfg.layer_norm_epsilon
    x = params["embed"][tokens].to(dt)
    B, T = tokens.shape
    bias = position_bias(cfg, params["rel_embed"], T)[None]   # [1, H, T, T]
    if mask is not None:
        bias = torch.where(mask[:, None, None, :].to(bias.device), bias,
                           torch.full((), -1e9, device=bias.device))
    lp = params["layers"]

    def heads(t):
        return t.reshape(B, T, H, dk).transpose(1, 2)

    for i in range(cfg.num_layers):
        a_in = _rms(x, lp["ln1"][i], eps)
        q = heads(a_in @ lp["wq"][i].to(dt))
        k = heads(a_in @ lp["wk"][i].to(dt))
        v = heads(a_in @ lp["wv"][i].to(dt))
        # no 1/sqrt(d): T5's initialisation absorbs it
        scores = torch.matmul(q, k.transpose(-1, -2)).float() + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        att = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * dk)
        x = x + att @ lp["wo"][i].to(dt)
        f_in = _rms(x, lp["ln2"][i], eps)
        gelu = F.gelu(f_in @ lp["wi0"][i].to(dt), approximate="tanh")
        x = x + (gelu * (f_in @ lp["wi1"][i].to(dt))) @ lp["wo2"][i].to(dt)
    return _rms(x, params["final_ln"], eps)


def param_shapes(cfg: T5Config) -> dict:
    L, D, F_, HK = cfg.num_layers, cfg.d_model, cfg.d_ff, \
        cfg.num_heads * cfg.d_kv
    return {
        "embed": (cfg.vocab_size, D),
        "rel_embed": (cfg.relative_attention_num_buckets, cfg.num_heads),
        "final_ln": (D,),
        "layers": {
            "ln1": (L, D), "wq": (L, D, HK), "wk": (L, D, HK),
            "wv": (L, D, HK), "wo": (L, HK, D), "ln2": (L, D),
            "wi0": (L, D, F_), "wi1": (L, D, F_), "wo2": (L, F_, D),
        },
    }


# HF T5EncoderModel names of each stacked leaf (transposed: [out, in] on
# disk, [in, out] here), the norm gains as they are
T5_LAYER_NAMES = {
    "ln1": ("0.layer_norm.weight", False),
    "wq": ("0.SelfAttention.q.weight", True),
    "wk": ("0.SelfAttention.k.weight", True),
    "wv": ("0.SelfAttention.v.weight", True),
    "wo": ("0.SelfAttention.o.weight", True),
    "ln2": ("1.layer_norm.weight", False),
    "wi0": ("1.DenseReluDense.wi_0.weight", True),
    "wi1": ("1.DenseReluDense.wi_1.weight", True),
    "wo2": ("1.DenseReluDense.wo.weight", True),
}
T5_REL_EMBED = ("encoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight")


def init_params(cfg: T5Config, seed: int = 0,
                device: str | torch.device = "cuda") -> PyTree:
    """Random weights keyed by leaf name as the JAX package's debug preset
    draws them: norm gains 1, every other leaf N(0, 0.05²), float32."""
    from localai_tpu_torch.image.unet import map_shapes
    from localai_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def mk(path, shape):
        if str(path[-1]).startswith(("ln", "final_ln")):
            return torch.ones(shape, device=device)
        return torch.randn(shape, generator=g, device=device) * 0.05

    return map_shapes(param_shapes(cfg), mk)


def load_hf_t5(d: str | Path, device: str | torch.device = "cuda"
               ) -> tuple[T5Config, PyTree]:
    """An HF ``T5EncoderModel`` directory (``config.json`` and every
    ``*.safetensors`` of it, so a sharded ``text_encoder_2`` loads) →
    (config, tree in the config's dtype on ``device``), each stacked leaf
    filled layer by layer on the device (``image.loader.load_entries``)."""
    import json

    from localai_tpu_torch.image.loader import load_entries, t5_entries

    d = Path(d)
    cfg = T5Config.from_hf(json.loads((d / "config.json").read_text()))
    return cfg, load_entries(d, t5_entries(cfg), cfg.dtype, device)
