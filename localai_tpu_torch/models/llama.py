"""Llama-family decoder (Llama 2/3, Mistral, Qwen2, ...) in PyTorch.

Port of ``localai_tpu/models/llama.py``. Same parameter layout — stacked
per-layer weights ``[L, ...]`` in right-multiply convention — so a JAX
parameter tree carries across unchanged (:func:`params_from_numpy`). The
layer loop is a Python loop over the stacked weights instead of
``lax.scan``; KV writes happen in place through the injected ``kv_write``
policy instead of returning a new stacked cache.

  * bfloat16 weights/activations, float32 for RMSNorm, softmax and RoPE.
  * GQA is computed grouped ([S, n_kv, q_per_kv, ...]) so the KV repeat is
    a broadcast inside the product, never materialized.
  * RoPE scaling: linear / llama3 / yarn, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import resolve_device

Params = dict


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False          # Qwen2-style qkv bias
    rope_scaling: Optional[dict] = None   # HF rope_scaling dict
    sliding_window: Optional[int] = None  # Mistral-style (mask-only)
    num_experts: int = 0                  # sparse MoE MLP (not ported yet)
    num_experts_per_tok: int = 2
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "LlamaConfig":
        """Build from an HF config.json dict (llama/mistral/qwen2 families)."""
        return cls(
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hf.get("hidden_size", 4096),
            intermediate_size=hf.get("intermediate_size", 11008),
            num_layers=hf.get("num_hidden_layers", 32),
            num_heads=hf.get("num_attention_heads", 32),
            num_kv_heads=hf.get("num_key_value_heads",
                                hf.get("num_attention_heads", 32)),
            head_dim=hf.get("head_dim"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False)
            or hf.get("model_type") == "qwen2",
            rope_scaling=hf.get("rope_scaling"),
            sliding_window=hf.get("sliding_window"),
            num_experts=hf.get("num_local_experts", 0),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        )


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` → torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _check_dense(cfg: LlamaConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "sparse MoE (num_experts > 0) is not ported to PyTorch yet")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(cfg: LlamaConfig, max_len: int,
               freq_base: Optional[float] = None,
               freq_scale: Optional[float] = None,
               device: str | torch.device = "cuda",
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin) [max_len, hd/2] in float32.

    Supports HF rope_scaling types 'linear', 'llama3', 'yarn' and raw
    rope_freq_base/rope_freq_scale overrides."""
    hd = cfg.hd
    base = freq_base or cfg.rope_theta
    f32 = torch.float32
    inv_freq = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=f32) / hd))
    sc = cfg.rope_scaling or {}
    rtype = sc.get("rope_type", sc.get("type", "default"))
    attn_factor = 1.0

    if rtype == "linear":
        inv_freq = inv_freq / float(sc.get("factor", 1.0))
    elif rtype == "llama3":
        factor = float(sc.get("factor", 8.0))
        lo = float(sc.get("low_freq_factor", 1.0))
        hi = float(sc.get("high_freq_factor", 4.0))
        old_ctx = float(sc.get("original_max_position_embeddings", 8192))
        wavelen = 2 * math.pi / inv_freq
        # three bands: scale long wavelengths, keep short, smooth in between
        smooth = ((old_ctx / wavelen - lo) / (hi - lo)).clamp(0.0, 1.0)
        scaled = inv_freq / factor
        inv_freq = (1 - smooth) * scaled + smooth * inv_freq
    elif rtype == "yarn":
        # YaRN (arXiv:2309.00071) NTK-by-parts interpolation
        factor = float(sc.get("factor", 1.0))
        old_ctx = float(sc.get("original_max_position_embeddings", 4096))
        beta_fast = float(sc.get("beta_fast", 32.0))
        beta_slow = float(sc.get("beta_slow", 1.0))
        attn_factor = float(sc.get("attention_factor") or
                            (0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0))

        def corr_dim(n_rot: float) -> float:
            return (hd * math.log(old_ctx / (n_rot * 2 * math.pi))) / (
                2 * math.log(base)
            )

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), hd // 2 - 1)
        ramp = ((torch.arange(hd // 2, dtype=f32) - low)
                / max(high - low, 1)).clamp(0.0, 1.0)
        inv_freq = inv_freq / factor * ramp + inv_freq * (1 - ramp)

    if freq_scale:
        inv_freq = inv_freq * freq_scale
    t = torch.arange(max_len, dtype=f32)
    freqs = torch.outer(t, inv_freq)  # [max_len, hd/2]
    cos = torch.cos(freqs) * attn_factor
    sin = torch.sin(freqs) * attn_factor
    device = resolve_device(device)
    return cos.to(device), sin.to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., heads, hd]; cos/sin broadcastable [..., 1, hd/2].

    HF 'rotate_half' convention (pairs are (i, i+hd/2))."""
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> dict:
    """Shapes of the stacked-parameter tree (same as the JAX package)."""
    _check_dense(cfg)
    D, F_, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, Hq * hd),
            "wk": (L, D, Hkv * hd),
            "wv": (L, D, Hkv * hd),
            "wo": (L, Hq * hd, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
    }
    if cfg.attention_bias:
        shapes["layers"]["bq"] = (L, Hq * hd)
        shapes["layers"]["bk"] = (L, Hkv * hd)
        shapes["layers"]["bv"] = (L, Hkv * hd)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Params:
    """Random init (testing / benchmarking with synthetic weights): norm
    gains 1, everything else N(0, 0.02). ``generator`` must live on
    ``device`` (default: the generator's own device); stacked layer
    weights are drawn one layer at a time so the float32 draw never
    exceeds one layer slice."""
    device = torch.device(device if device is not None else generator.device)
    dtype = torch_dtype(cfg.dtype)

    def mk(shape):
        if len(shape) == 1:  # norm gains
            return torch.ones(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(-1, *shape[-2:]) if len(shape) == 3 else [out]
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=generator,
                                dtype=torch.float32, device=device) * 0.02)
        return out

    shapes = param_shapes(cfg)
    return {k: ({kk: mk(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else mk(v)) for k, v in shapes.items()}


def params_from_numpy(tree: dict, cfg: LlamaConfig,
                      device: str | torch.device = "cuda") -> Params:
    """Carry a JAX parameter tree (nested dicts of numpy arrays) across to
    torch tensors in ``cfg.dtype`` on ``device``. bfloat16 arrays arrive
    as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: they go
    across as their int16 bit pattern and are reinterpreted."""
    _check_dense(cfg)
    dtype = torch_dtype(cfg.dtype)
    device = resolve_device(device)

    def conv(a):
        a = np.array(a)  # an own, writable, contiguous copy
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype)

    return {k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else conv(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(cfg: LlamaConfig, x, lp, cos, sin, attend):
    """One decoder layer. ``attend(q, k_new, v_new) -> attn_out`` is
    injected so prefill/decode/KV-cache policies stay out of the math."""
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if "bq" in lp:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    q = q.reshape(*q.shape[:-1], Hq, hd)
    k = k.reshape(*k.shape[:-1], Hkv, hd)
    v = v.reshape(*v.shape[:-1], Hkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    attn = attend(q, k, v)
    attn = attn.reshape(*attn.shape[:-2], Hq * hd)
    x = x + attn @ lp["wo"]

    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + gated @ lp["w_down"]


def _grouped_attn(cfg: LlamaConfig, q, keys, values, mask):
    """Grouped-query attention.

    q: [S, T, Hq, hd], keys/values head-major: [S, Hkv, Lk, hd],
    mask: [S, T, Lk] bool (True = attend). Returns [S, T, Hq, hd]."""
    S, T, Hq = q.shape[0], q.shape[1], q.shape[2]
    Hkv, hd = keys.shape[1], cfg.hd
    g = Hq // Hkv
    qg = q.reshape(S, T, Hkv, g, hd)
    scores = torch.einsum("stkgh,sklh->skgtl", qg, keys) / math.sqrt(hd)
    scores = scores.float().masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(values.dtype)
    out = torch.einsum("skgtl,sklh->stkgh", probs, values)
    return out.reshape(S, T, Hq, hd)


def forward(
    cfg: LlamaConfig,
    params: Params,
    tokens: torch.Tensor,     # [B, T] int
    positions: torch.Tensor,  # [B, T] int (absolute positions for RoPE)
    kv_write: Any,            # fn(layer_kv, k, v) -> (layer_kv, keys, values)
    kv_stack: Any,            # tuple of stacked [L, ...] KV tensors, or None
    mask: Optional[torch.Tensor],  # [B, T, Lk] bool attention mask
    rope: tuple[torch.Tensor, torch.Tensor],
    attn: Any = None,         # optional override: fn(q, keys, values, mask)
                              # (the CUDA paged kernel injects here;
                              # None = _grouped_attn)
    embeds: Optional[torch.Tensor] = None,  # [B, T, D] embeddings override
) -> tuple[torch.Tensor, Any]:
    """Shared transformer trunk: returns (hidden [B, T, D], kv_stack).

    A Python loop over layers takes the place of ``lax.scan``. The KV
    stack is updated in place by ``kv_write`` (layer i sees views
    ``t[i]`` of the stacked tensors) and returned for symmetry with the
    JAX signature. Positions past the RoPE table (padding rows of a
    bucketed chunk) read its last row, like JAX's clamped gather."""
    _check_dense(cfg)
    cos_t, sin_t = rope
    pos = positions.clamp(max=cos_t.shape[0] - 1)
    cos = cos_t[pos][:, :, None, :]  # [B, T, 1, hd/2]
    sin = sin_t[pos][:, :, None, :]
    dtype = torch_dtype(cfg.dtype)
    if embeds is None:
        x = params["embed"][tokens].to(dtype)
    else:
        x = embeds.to(dtype)
    if attn is None:
        def attn(q, keys, values, m):
            return _grouped_attn(cfg, q, keys, values, m)

    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        layer_kv = (None if kv_stack is None
                    else tuple(t[i] for t in kv_stack))

        def attend(q, k_new, v_new, layer_kv=layer_kv):
            _, keys, values = kv_write(layer_kv, k_new, v_new)
            return attn(q, keys, values, mask)

        x = _layer(cfg, x, lp, cos, sin, attend)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, kv_stack


def logits_from_hidden(cfg: LlamaConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return x @ params["lm_head"]
