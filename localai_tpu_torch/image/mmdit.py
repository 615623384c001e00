"""FLUX-class rectified-flow transformer (MMDiT) in plain torch.

Port of ``localai_tpu/image/mmdit.py``, diffusers'
``FluxTransformer2DModel``: double-stream blocks (separate image and text
streams, joint attention, AdaLN-zero modulation from the timestep, pooled
text and distilled-guidance embeddings), then single-stream blocks over
the merged sequence (parallel attention and MLP), 3-axis rotary
embeddings over (batch, y, x) ids with interleaved pairs, and the
AdaLN-continuous output head. The JAX package scans each block type over
stacked weights; the port loops over the same stacks (``[L, ...]``
leaves, linears [in, out]). The SiLU of the AdaLN inputs is applied once
to the embedding, as there. Norms, rotary products and the softmax run
in float32, every other product in the config's dtype (float32 in the
JAX package and here). The attention is ``image.unet``'s kind: whole
score matrices, no hand-written kernel (XLA in the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.image.unet import map_shapes, torch_dtype
from localai_tpu_torch.utils.device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # 16 latent channels x a 2x2 patch
    num_layers: int = 19             # double-stream blocks
    num_single_layers: int = 38      # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5's d_model
    pooled_projection_dim: int = 768 # CLIP's pooled width
    guidance_embeds: bool = True     # FLUX.1-dev's distilled guidance
    axes_dims_rope: tuple = (16, 56, 56)
    dtype: str = "float32"

    @property
    def dim(self) -> int:
        return self.attention_head_dim * self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "FluxConfig":
        return cls(
            in_channels=hf.get("in_channels", 64),
            num_layers=hf.get("num_layers", 19),
            num_single_layers=hf.get("num_single_layers", 38),
            attention_head_dim=hf.get("attention_head_dim", 128),
            num_attention_heads=hf.get("num_attention_heads", 24),
            joint_attention_dim=hf.get("joint_attention_dim", 4096),
            pooled_projection_dim=hf.get("pooled_projection_dim", 768),
            guidance_embeds=hf.get("guidance_embeds", True),
            axes_dims_rope=tuple(hf.get("axes_dims_rope", (16, 56, 56))),
        )


# -- embeddings -------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """diffusers' ``Timesteps(flip_sin_to_cos=True, shift=0)``: [B, dim]
    float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_3d(cfg: FluxConfig, ids: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [N, 3] → (cos, sin) [N, head_dim], each angle repeated for its
    interleaved pair (diffusers' ``get_1d_rotary_pos_embed`` with
    ``repeat_interleave_real``)."""
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(cfg.axes_dims_rope):
        freqs = 1.0 / (10000.0 ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=ids.device) / dim))
        angles = ids[:, axis].float()[:, None] * freqs[None]
        cos_parts.append(torch.repeat_interleave(torch.cos(angles), 2, -1))
        sin_parts.append(torch.repeat_interleave(torch.sin(angles), 2, -1))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, H, N, hd], cos/sin [N, hd] over interleaved pairs; the
    product in float32."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(x.shape)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, in float32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _rmsn(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
          ) -> torch.Tensor:
    """The per-head query/key RMSNorm (a gain over head_dim)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _lin(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _mlp2(p: dict, x: torch.Tensor) -> torch.Tensor:
    """linear_1 → SiLU → linear_2 (diffusers' ``TimestepEmbedding``)."""
    return _lin(F.silu(_lin(x, p["w1"], p["b1"])), p["w2"], p["b2"])


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, N, _ = x.shape
    return x.reshape(B, N, H, -1).transpose(1, 2)          # [B, H, N, hd]


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, hd = x.shape
    return x.transpose(1, 2).reshape(B, N, H * hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """[B, H, N, hd] dot-product attention, no mask: the scores in the
    activations' dtype, scaled and soft-maxed in float32."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    probs = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
    del scores
    return torch.matmul(probs.to(v.dtype), v)


# -- blocks -----------------------------------------------------------------

def _at(tree: dict, i: int) -> dict:
    """Layer ``i`` of a block's stacked leaves (views, no copy)."""
    return {k: v[i] for k, v in tree.items()}


def double_block(cfg: FluxConfig, p: dict, x: torch.Tensor,
                 c: torch.Tensor, temb: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One double-stream block over image tokens ``x`` and text tokens
    ``c``; ``temb`` is the SiLU'd conditioning [B, dim]."""
    H, dt, Ntxt = cfg.num_attention_heads, x.dtype, c.shape[1]
    m_x = _lin(temb, p["mod_x_w"], p["mod_x_b"]).to(dt)[:, None]
    m_c = _lin(temb, p["mod_c_w"], p["mod_c_b"]).to(dt)[:, None]
    sh_x, sc_x, g_x, shm_x, scm_x, gm_x = m_x.chunk(6, dim=-1)
    sh_c, sc_c, g_c, shm_c, scm_c, gm_c = m_c.chunk(6, dim=-1)
    xn = _ln(x) * (1 + sc_x) + sh_x
    cn = _ln(c) * (1 + sc_c) + sh_c
    q = torch.cat([_rmsn(_heads(_lin(cn, p["wq_c"], p["bq_c"]), H),
                         p["qn_c"]),
                   _rmsn(_heads(_lin(xn, p["wq_x"], p["bq_x"]), H),
                         p["qn_x"])], dim=2)
    k = torch.cat([_rmsn(_heads(_lin(cn, p["wk_c"], p["bk_c"]), H),
                         p["kn_c"]),
                   _rmsn(_heads(_lin(xn, p["wk_x"], p["bk_x"]), H),
                         p["kn_x"])], dim=2)
    v = torch.cat([_heads(_lin(cn, p["wv_c"], p["bv_c"]), H),
                   _heads(_lin(xn, p["wv_x"], p["bv_x"]), H)], dim=2)
    att = _unheads(attention(apply_rope(q, cos, sin),
                             apply_rope(k, cos, sin), v))
    del q, k, v
    a_c, a_x = att[:, :Ntxt], att[:, Ntxt:]
    x = x + g_x * _lin(a_x, p["wo_x"], p["bo_x"])
    xm = _ln(x) * (1 + scm_x) + shm_x
    x = x + gm_x * _lin(_gelu(_lin(xm, p["ff_x_w1"], p["ff_x_b1"])),
                        p["ff_x_w2"], p["ff_x_b2"])
    c = c + g_c * _lin(a_c, p["wo_c"], p["bo_c"])
    cm = _ln(c) * (1 + scm_c) + shm_c
    c = c + gm_c * _lin(_gelu(_lin(cm, p["ff_c_w1"], p["ff_c_b1"])),
                        p["ff_c_w2"], p["ff_c_b2"])
    return x, c


def single_block(cfg: FluxConfig, p: dict, s: torch.Tensor,
                 temb: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """One single-stream block over the merged [text; image] tokens."""
    H = cfg.num_attention_heads
    m = _lin(temb, p["mod_w"], p["mod_b"]).to(s.dtype)[:, None]
    sh, sc, g = m.chunk(3, dim=-1)
    sn = _ln(s) * (1 + sc) + sh
    q = _rmsn(_heads(_lin(sn, p["wq"], p["bq"]), H), p["qn"])
    k = _rmsn(_heads(_lin(sn, p["wk"], p["bk"]), H), p["kn"])
    v = _heads(_lin(sn, p["wv"], p["bv"]), H)
    att = _unheads(attention(apply_rope(q, cos, sin),
                             apply_rope(k, cos, sin), v))
    del q, k, v
    mlp = _gelu(_lin(sn, p["mlp_w"], p["mlp_b"]))
    proj = _lin(torch.cat([att, mlp], dim=-1), p["out_w"], p["out_b"])
    return s + g * proj


def conditioning(cfg: FluxConfig, params: PyTree, pooled: torch.Tensor,
                 timestep: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU(timestep + guidance + pooled-text embeddings) [B, dim],
    float32: every AdaLN input."""
    temb = _mlp2(params["time_mlp"], timestep_embedding(timestep * 1000.0))
    if cfg.guidance_embeds:
        g = guidance if guidance is not None else torch.ones_like(timestep)
        temb = temb + _mlp2(params["guid_mlp"],
                            timestep_embedding(g * 1000.0))
    temb = temb + _mlp2(params["text_mlp"], pooled.float())
    return F.silu(temb)


def forward(cfg: FluxConfig, params: PyTree,
            img: torch.Tensor,       # [B, Nimg, in_channels] packed patches
            txt: torch.Tensor,       # [B, Ntxt, joint_attention_dim]
            pooled: torch.Tensor,    # [B, pooled_projection_dim]
            timestep: torch.Tensor,  # [B] float32 sigma in [0, 1]
            img_ids: torch.Tensor,   # [Nimg, 3]
            txt_ids: torch.Tensor,   # [Ntxt, 3]
            guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Velocity prediction [B, Nimg, in_channels]."""
    dt = torch_dtype(cfg.dtype)
    Ntxt = txt.shape[1]
    temb = conditioning(cfg, params, pooled, timestep, guidance)
    x = _lin(img.to(dt), params["x_embed_w"], params["x_embed_b"])
    c = _lin(txt.to(dt), params["ctx_embed_w"], params["ctx_embed_b"])
    cos, sin = rope_3d(cfg, torch.cat([txt_ids, img_ids], dim=0))
    dbl, sgl = params["double"], params["single"]
    for i in range(cfg.num_layers):
        x, c = double_block(cfg, _at(dbl, i), x, c, temb, cos, sin)
    s = torch.cat([c, x], dim=1)
    del x, c
    for i in range(cfg.num_single_layers):
        s = single_block(cfg, _at(sgl, i), s, temb, cos, sin)
    x = s[:, Ntxt:]
    out_mod = _lin(temb, params["norm_out_w"], params["norm_out_b"])
    scale, shift = out_mod.to(dt)[:, None].chunk(2, dim=-1)
    x = _ln(x) * (1 + scale) + shift
    return _lin(x, params["proj_out_w"], params["proj_out_b"])


# -- parameters -------------------------------------------------------------

def param_shapes(cfg: FluxConfig) -> dict:
    D, Ld, Ls = cfg.dim, cfg.num_layers, cfg.num_single_layers
    hd = cfg.attention_head_dim
    F_ = 4 * D

    def mlp2(din):
        return {"w1": (din, D), "b1": (D,), "w2": (D, D), "b2": (D,)}

    shapes: dict = {
        "x_embed_w": (cfg.in_channels, D), "x_embed_b": (D,),
        "ctx_embed_w": (cfg.joint_attention_dim, D), "ctx_embed_b": (D,),
        "time_mlp": mlp2(256),
        "text_mlp": mlp2(cfg.pooled_projection_dim),
        "norm_out_w": (D, 2 * D), "norm_out_b": (2 * D,),
        "proj_out_w": (D, cfg.in_channels), "proj_out_b": (cfg.in_channels,),
    }
    if cfg.guidance_embeds:
        shapes["guid_mlp"] = mlp2(256)
    dd = {"mod_x_w": (D, 6 * D), "mod_x_b": (6 * D,),
          "mod_c_w": (D, 6 * D), "mod_c_b": (6 * D,)}
    for st in ("x", "c"):
        dd.update({
            f"wq_{st}": (D, D), f"bq_{st}": (D,),
            f"wk_{st}": (D, D), f"bk_{st}": (D,),
            f"wv_{st}": (D, D), f"bv_{st}": (D,),
            f"wo_{st}": (D, D), f"bo_{st}": (D,),
            f"qn_{st}": (hd,), f"kn_{st}": (hd,),
            f"ff_{st}_w1": (D, F_), f"ff_{st}_b1": (F_,),
            f"ff_{st}_w2": (F_, D), f"ff_{st}_b2": (D,),
        })
    shapes["double"] = {k: (Ld,) + v for k, v in dd.items()}
    ss = {"mod_w": (D, 3 * D), "mod_b": (3 * D,),
          "wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
          "wv": (D, D), "bv": (D,), "qn": (hd,), "kn": (hd,),
          "mlp_w": (D, F_), "mlp_b": (F_,),
          "out_w": (D + F_, D), "out_b": (D,)}
    shapes["single"] = {k: (Ls,) + v for k, v in ss.items()}
    return shapes


def leaf_kind(name: str) -> str:
    """The JAX package's init by leaf NAME: qk-norm gains are ones,
    biases zeros, every other leaf a 0.02-std gaussian."""
    if name.startswith(("qn", "kn")):
        return "ones"
    if name.startswith("b") or name.endswith(("_b", "b1", "b2")):
        return "zeros"
    return "normal"


def init_params(cfg: FluxConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                generator: Optional[torch.Generator] = None) -> PyTree:
    """Random float32 weights in the JAX package's scheme, drawn from
    ``generator`` (else one on ``device`` seeded with ``seed``)."""
    device = resolve_device(device)
    g = generator or torch.Generator(device=device).manual_seed(seed)

    def mk(path, shape):
        kind = leaf_kind(str(path[-1]))
        if kind == "ones":
            return torch.ones(shape, device=device)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        return torch.randn(shape, generator=g, device=device) * 0.02

    return map_shapes(param_shapes(cfg), mk)


# -- the rectified-flow schedule ---------------------------------------------

def flow_sigmas(steps: int, image_seq_len: int, *,
                base_shift: float = 0.5, max_shift: float = 1.15,
                dynamic: bool = True, shift: float = 1.0) -> np.ndarray:
    """FlowMatchEulerDiscrete sigmas, [steps + 1] with a trailing 0:
    FLUX.1-dev's resolution-dependent shift (``dynamic``), else the static
    ``shift`` the scheduler config declares (1.0 for schnell: none)."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps)
    if dynamic:
        m = (max_shift - base_shift) / (4096 - 256)
        b = base_shift - m * 256
        mu = image_seq_len * m + b
        sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    elif shift != 1.0:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return np.append(sigmas, 0.0).astype(np.float32)
