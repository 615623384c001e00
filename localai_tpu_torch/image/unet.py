"""SD-class conditional UNet in plain torch, NCHW.

Port of ``localai_tpu/image/unet.py``: the SD-1.x / SD-2.x / SDXL
``UNet2DConditionModel`` family with configurable widths, so the tiny
debug preset and real checkpoints share one code path. ResBlocks with the
timestep embedding, spatial transformers (self and cross attention over
the text context, GEGLU feed-forward; any number of blocks a level),
skip connections, a stride-2 conv down and a nearest 2x up; SDXL's
text_time MLP and ControlNet's residuals. Tensors are NCHW, torch's
layout for ``F.conv2d``, and conv kernels OIHW (the JAX package's are
NHWC / HWIO); linear weights are [in, out], right-multiplied, as there.

Numerics follow the JAX code op for op: group and layer norms run in
float32 with the population variance, softmax in float32, the time
embedding and the text_time MLP in float32 (JAX promotes ``f32 @ bf16``
to float32; the port casts the weight up), and every other product in the
activations' dtype. ``jax.nn.gelu`` is the tanh approximation. No
hand-written kernel is on this path: the JAX package runs it in XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import resolve_device

PyTree = Any

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported image model dtype {name!r}; have "
                         f"{sorted(TORCH_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: tuple[int, ...] = (0, 1, 2)   # levels with transformers
    transformer_depth: int = 1
    # SDXL: transformer blocks a level ([1, 2, 10]); the JAX package keeps
    # transformer_depth 1 for a list, and both loaders count the blocks a
    # checkpoint has, so this sizes drawn weights only
    depth_per_level: tuple[int, ...] = ()
    num_heads: int = 8
    heads_per_level: tuple[int, ...] = ()      # SDXL: per-level head counts
    context_dim: int = 768                     # CLIP hidden size
    # SDXL micro-conditioning (addition_embed_type="text_time")
    addition_embed: bool = False
    addition_time_embed_dim: int = 256
    # the text_time MLP's input width (pooled text + 6 time ids): the
    # checkpoint's projection_class_embeddings_input_dim (2816 on SDXL);
    # read only to size drawn weights (the JAX package draws none)
    addition_in_dim: int = 0
    dtype: str = "bfloat16"

    def depth_at(self, level: int) -> int:
        if self.depth_per_level:
            return self.depth_per_level[
                min(level, len(self.depth_per_level) - 1)]
        return self.transformer_depth

    def heads_at(self, level: int) -> int:
        if self.heads_per_level:
            return self.heads_per_level[
                min(level, len(self.heads_per_level) - 1)]
        return self.num_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "UNetConfig":
        """Build from a diffusers ``unet/config.json`` dict."""
        block_out = hf.get("block_out_channels", [320, 640, 1280, 1280])
        mc = block_out[0]
        down_types = hf.get("down_block_types", [])
        attn_levels = tuple(
            i for i, t in enumerate(down_types) if "CrossAttn" in t
        ) or tuple(range(len(block_out) - 1))
        # diffusers quirk: attention_head_dim holds the HEAD COUNT for
        # SD-class unets (8 for SD1.5, [5, 10, 20] for SDXL)
        heads = hf.get("num_attention_heads") or hf.get(
            "attention_head_dim", 8)
        heads_per_level: tuple[int, ...] = ()
        if isinstance(heads, (list, tuple)):
            heads_per_level = tuple(int(h) for h in heads)
            heads = heads_per_level[0]
        add = hf.get("addition_embed_type") == "text_time"
        time_dim = hf.get("addition_time_embed_dim", 256)
        depth = hf.get("transformer_layers_per_block", 1)
        return cls(
            in_channels=hf.get("in_channels", 4),
            out_channels=hf.get("out_channels", 4),
            model_channels=mc,
            channel_mult=tuple(c // mc for c in block_out),
            num_res_blocks=hf.get("layers_per_block", 2),
            attn_levels=attn_levels,
            transformer_depth=depth if isinstance(depth, int) else 1,
            depth_per_level=() if isinstance(depth, int)
            else tuple(int(d) for d in depth),
            num_heads=heads,
            heads_per_level=heads_per_level,
            context_dim=hf.get("cross_attention_dim", 768),
            addition_embed=add,
            addition_time_embed_dim=time_dim,
            addition_in_dim=int(
                hf.get("projection_class_embeddings_input_dim") or 0),
        )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: (low, high), the odd one
    on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p: dict, *, stride: int = 1,
           padding: Any = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` over NCHW / OIHW with the JAX
    package's padding: "SAME", or ((top, bottom), (left, right))."""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    if padding == "SAME":
        (t, b) = _same_pad(x.shape[2], k, stride)
        (lo, hi) = _same_pad(x.shape[3], k, stride)
    else:
        (t, b), (lo, hi) = padding
    if t == b and lo == hi:
        return F.conv2d(x, w, p["b"].to(x.dtype), stride, (t, lo))
    x = F.pad(x, (lo, hi, t, b))
    return F.conv2d(x, w, p["b"].to(x.dtype), stride)


def group_norm(x: torch.Tensor, p: dict, *, groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel groups, in float32."""
    g = min(groups, x.shape[1])
    return F.group_norm(x.float(), g, p["g"].float(), p["b"].float(),
                        eps).to(x.dtype)


def layer_norm(x: torch.Tensor, p: dict, *, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["g"].float(),
                        p["b"].float(), eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Multi-head dot-product attention over [B, N, C] / [B, M, C]: scores
    in the activations' dtype, softmax in float32."""
    B, N, C = q.shape
    M = k.shape[1]
    hd = C // num_heads
    q = q.reshape(B, N, num_heads, hd).transpose(1, 2)
    k = k.reshape(B, M, num_heads, hd).transpose(1, 2)
    v = v.reshape(B, M, num_heads, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    del scores
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(B, N, C)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim] (float32)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.astype(x.dtype) + b.astype(x.dtype)``."""
    out = x @ w.to(x.dtype)
    return out if b is None else out + b.to(x.dtype)


def mlp_f32(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The time embedding / text_time MLP: float32 throughout (JAX
    promotes the float32 features against the bf16 weights)."""
    h = x @ p["w1"].float() + p["b1"].float()
    return F.silu(h) @ p["w2"].float() + p["b2"].float()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def res_block(x: torch.Tensor, temb: torch.Tensor, p: dict) -> torch.Tensor:
    h = F.silu(group_norm(x, p["norm1"]))
    h = conv2d(h, p["conv1"])
    t = _linear(F.silu(temb), p["temb"]["w"], p["temb"]["b"])
    h = h + t.to(h.dtype)[:, :, None, None]
    h = F.silu(group_norm(h, p["norm2"]))
    h = conv2d(h, p["conv2"])
    if "skip" in p:
        x = conv2d(x, p["skip"])
    return x + h


def _geglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = _linear(x, p["w1"], p["b1"])
    a, b = h.chunk(2, dim=-1)
    h = a * F.gelu(b, approximate="tanh")
    return _linear(h, p["w2"], p["b2"])


def _attn_proj(x: torch.Tensor, ctx: torch.Tensor, p: dict,
               num_heads: int) -> torch.Tensor:
    q = _linear(x, p["wq"])
    k = _linear(ctx, p["wk"])
    v = _linear(ctx, p["wv"])
    return _linear(attention(q, k, v, num_heads), p["wo"], p["bo"])


def _pointwise(h: torch.Tensor, p: dict) -> torch.Tensor:
    """A 1x1 conv (OIHW [C, C, 1, 1]) applied to [B, N, C] rows."""
    return _linear(h, p["w"][:, :, 0, 0].t(), p["b"])


def spatial_transformer(x: torch.Tensor, context: torch.Tensor, p: dict,
                        cfg: UNetConfig, num_heads: int = 0) -> torch.Tensor:
    """GN → 1x1 in → transformer blocks (self, cross, GEGLU FF) → 1x1 out,
    residual around the whole stack."""
    heads = num_heads or cfg.num_heads
    B, C, H, W = x.shape
    h = group_norm(x, p["norm"]).permute(0, 2, 3, 1).reshape(B, H * W, C)
    h = _pointwise(h, p["proj_in"])
    for bp in p["blocks"]:
        n1 = layer_norm(h, bp["ln1"])
        h = h + _attn_proj(n1, n1, bp["attn1"], heads)
        h = h + _attn_proj(layer_norm(h, bp["ln2"]), context, bp["attn2"],
                           heads)
        h = h + _geglu(layer_norm(h, bp["ln3"]), bp["ff"])
    h = _pointwise(h, p["proj_out"])
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def downsample(x: torch.Tensor, p: dict) -> torch.Tensor:
    # stride-2 conv with the (0, 1) asymmetric padding SD uses
    return conv2d(x, p, stride=2, padding=((0, 1), (0, 1)))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x (``jax.image.resize(..., "nearest")`` at scale 2)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def upsample(x: torch.Tensor, p: dict) -> torch.Tensor:
    return conv2d(upsample2x(x), p)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def time_embedding(cfg: UNetConfig, params: PyTree, timesteps: torch.Tensor,
                   pooled_text: Optional[torch.Tensor] = None,
                   time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The timestep embedding [B, 4 * model_channels] in float32, plus
    SDXL's text_time MLP over the pooled text and the six size/crop ids."""
    temb = mlp_f32(timestep_embedding(timesteps, cfg.model_channels),
                   params["time_emb"])
    if cfg.addition_embed and pooled_text is not None:
        B = pooled_text.shape[0]
        tid = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim
        ).reshape(B, -1)
        aug = torch.cat([pooled_text.float(), tid], dim=-1)
        temb = temb + mlp_f32(aug, params["add_emb"])
    return temb


def forward(cfg: UNetConfig, params: PyTree, latents: torch.Tensor,
            timesteps: torch.Tensor, context: torch.Tensor,
            pooled_text: Optional[torch.Tensor] = None,
            time_ids: Optional[torch.Tensor] = None,
            down_residuals: Optional[list] = None,
            mid_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Denoise step: latents [B, Cin, h, w], timesteps [B], context
    [B, T, ctx] → predicted noise [B, Cout, h, w] (float32).

    SDXL (``cfg.addition_embed``): ``pooled_text`` [B, pooled] and
    ``time_ids`` [B, 6] feed the text_time MLP. ControlNet:
    ``down_residuals`` (one per skip) add onto the saved skips and
    ``mid_residual`` onto the mid block's output."""
    dtype = torch_dtype(cfg.dtype)
    x = latents.to(dtype)
    context = context.to(dtype)
    temb = time_embedding(cfg, params, timesteps, pooled_text, time_ids)

    h = conv2d(x, params["conv_in"])
    skips = [h]
    for lvl, lp in enumerate(params["down"]):
        for i, rp in enumerate(lp["res"]):
            h = res_block(h, temb, rp)
            if lp.get("attn"):
                h = spatial_transformer(h, context, lp["attn"][i], cfg,
                                        cfg.heads_at(lvl))
            skips.append(h)
        if lp.get("down"):
            h = downsample(h, lp["down"])
            skips.append(h)

    if down_residuals is not None:
        skips = [s + r.to(s.dtype) for s, r in zip(skips, down_residuals)]

    mid = params["mid"]
    n_lvls = len(params["down"])
    h = res_block(h, temb, mid["res1"])
    h = spatial_transformer(h, context, mid["attn"], cfg,
                            cfg.heads_at(n_lvls - 1))
    h = res_block(h, temb, mid["res2"])
    if mid_residual is not None:
        h = h + mid_residual.to(h.dtype)

    for lvl, lp in enumerate(params["up"]):
        for i, rp in enumerate(lp["res"]):
            h = torch.cat([h, skips.pop()], dim=1)
            h = res_block(h, temb, rp)
            if lp.get("attn"):
                h = spatial_transformer(h, context, lp["attn"][i], cfg,
                                        cfg.heads_at(n_lvls - 1 - lvl))
        if lp.get("up"):
            h = upsample(h, lp["up"])

    h = F.silu(group_norm(h, params["norm_out"]))
    return conv2d(h, params["conv_out"]).float()


# ---------------------------------------------------------------------------
# shapes / init
# ---------------------------------------------------------------------------

def conv_shape(cin: int, cout: int, k: int = 3) -> dict:
    """A conv's leaves, OIHW (the JAX package's are HWIO)."""
    return {"w": (cout, cin, k, k), "b": (cout,)}


def _res_shapes(cin, cout, tdim):
    p = {
        "norm1": {"g": (cin,), "b": (cin,)},
        "conv1": conv_shape(cin, cout),
        "temb": {"w": (tdim, cout), "b": (cout,)},
        "norm2": {"g": (cout,), "b": (cout,)},
        "conv2": conv_shape(cout, cout),
    }
    if cin != cout:
        p["skip"] = conv_shape(cin, cout, k=1)
    return p


def _st_shapes(ch, cfg: UNetConfig, depth: int):
    def attn(kv_dim):
        return {"wq": (ch, ch), "wk": (kv_dim, ch), "wv": (kv_dim, ch),
                "wo": (ch, ch), "bo": (ch,)}

    inner = ch * 4
    block = {
        "ln1": {"g": (ch,), "b": (ch,)}, "attn1": attn(ch),
        "ln2": {"g": (ch,), "b": (ch,)}, "attn2": attn(cfg.context_dim),
        "ln3": {"g": (ch,), "b": (ch,)},
        "ff": {"w1": (ch, inner * 2), "b1": (inner * 2,),
               "w2": (inner, ch), "b2": (ch,)},
    }
    return {
        "norm": {"g": (ch,), "b": (ch,)},
        "proj_in": conv_shape(ch, ch, k=1),
        "blocks": [dict(block) for _ in range(depth)],
        "proj_out": conv_shape(ch, ch, k=1),
    }


def param_shapes(cfg: UNetConfig) -> PyTree:
    mc = cfg.model_channels
    tdim = mc * 4
    shapes: dict[str, Any] = {
        "conv_in": conv_shape(cfg.in_channels, mc),
        "time_emb": {"w1": (mc, tdim), "b1": (tdim,),
                     "w2": (tdim, tdim), "b2": (tdim,)},
    }
    if cfg.addition_embed:
        ain = cfg.addition_in_dim or 1280 + 6 * cfg.addition_time_embed_dim
        shapes["add_emb"] = {"w1": (ain, tdim), "b1": (tdim,),
                             "w2": (tdim, tdim), "b2": (tdim,)}
    down = []
    ch = mc
    skip_chs = [mc]
    for lvl, mult in enumerate(cfg.channel_mult):
        out_ch = mc * mult
        lp: dict[str, Any] = {"res": [], "attn": [] if lvl in cfg.attn_levels
                              else None}
        for _ in range(cfg.num_res_blocks):
            lp["res"].append(_res_shapes(ch, out_ch, tdim))
            if lp["attn"] is not None:
                lp["attn"].append(
                    _st_shapes(out_ch, cfg, cfg.depth_at(lvl)))
            ch = out_ch
            skip_chs.append(ch)
        if lvl != len(cfg.channel_mult) - 1:
            lp["down"] = conv_shape(ch, ch)
            skip_chs.append(ch)
        down.append(lp)
    shapes["down"] = down
    shapes["mid"] = {
        "res1": _res_shapes(ch, ch, tdim),
        "attn": _st_shapes(ch, cfg, cfg.depth_at(len(down) - 1)),
        "res2": _res_shapes(ch, ch, tdim),
    }
    up = []
    for lvl in reversed(range(len(cfg.channel_mult))):
        out_ch = mc * cfg.channel_mult[lvl]
        lp = {"res": [], "attn": [] if lvl in cfg.attn_levels else None}
        for _ in range(cfg.num_res_blocks + 1):
            skip = skip_chs.pop()
            lp["res"].append(_res_shapes(ch + skip, out_ch, tdim))
            if lp["attn"] is not None:
                lp["attn"].append(
                    _st_shapes(out_ch, cfg, cfg.depth_at(lvl)))
            ch = out_ch
        if lvl != 0:
            lp["up"] = conv_shape(ch, ch)
        up.append(lp)
    shapes["up"] = up
    shapes["norm_out"] = {"g": (ch,), "b": (ch,)}
    shapes["conv_out"] = conv_shape(ch, cfg.out_channels)
    return shapes


def is_shape(v: Any) -> bool:
    return isinstance(v, tuple) and all(isinstance(d, int) for d in v)


def map_shapes(shapes: PyTree, fn, path: tuple = ()) -> PyTree:
    """``fn(path, shape)`` at every leaf of a shape tree (dicts, lists and
    None kept as they are)."""
    if is_shape(shapes):
        return fn(path, shapes)
    if isinstance(shapes, dict):
        return {k: map_shapes(v, fn, path + (k,)) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [map_shapes(v, fn, path + (i,)) for i, v in enumerate(shapes)]
    return shapes


def _is_bias(name: Any) -> bool:
    """The JAX package's zeroed leaves: biases."""
    return name in ("b", "b1", "b2", "bo", "bq", "bk", "bv")


def draw_params(shapes: PyTree, dtype: str, seed: int,
                device: str | torch.device = "cuda",
                scale=None) -> PyTree:
    """Random weights in the JAX package's init scheme from a
    ``torch.Generator``: vectors 1 (norm gains) or 0 (biases) in float32;
    every other leaf N(0, 1) times ``scale(shape)`` (default
    1/sqrt(fan_in)) in ``dtype``, drawn on ``device``'s generator (the
    CPU's for the CPU) so a full-width tree never sits on the host."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(dtype)

    def fan_in_scale(shape):
        # OIHW: fan-in is I*H*W; a linear [in, out]: in
        fan = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        return 1.0 / math.sqrt(max(fan, 1))

    scale = scale or fan_in_scale

    def mk(path, shape):
        if len(shape) == 1:
            fill = 0.0 if _is_bias(path[-1]) else 1.0
            return torch.full(shape, fill, dtype=torch.float32,
                              device=device)
        t = torch.randn(shape, generator=g, device=device)
        return t.mul_(scale(shape)).to(dt)

    return map_shapes(shapes, mk)


def init_params(cfg: UNetConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> PyTree:
    """Random UNet weights (debug presets and the smoke; real weights come
    from the diffusers-layout loader, ``image.loader``)."""
    return draw_params(param_shapes(cfg), cfg.dtype, seed, device)
