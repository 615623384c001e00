"""AutoencoderKL VAE (SD-class) in plain torch, NCHW.

Port of ``localai_tpu/image/vae.py``: the latent codec of the diffusion
pipeline, the encoder for img2img init latents and the decoder for the
final images. ResBlocks without a time embedding, one single-head spatial
attention at the bottleneck (softmax in float32), nearest-up and stride-2
down with the (0, 1) padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from localai_tpu_torch.image.unet import (
    _linear,
    conv2d,
    conv_shape,
    draw_params,
    group_norm,
    torch_dtype,
    upsample2x,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scaling_factor: float = 0.18215
    dtype: str = "bfloat16"

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    @classmethod
    def from_hf(cls, hf: dict) -> "VAEConfig":
        block_out = hf.get("block_out_channels", [128, 256, 512, 512])
        base = block_out[0]
        return cls(
            in_channels=hf.get("in_channels", 3),
            latent_channels=hf.get("latent_channels", 4),
            base_channels=base,
            channel_mult=tuple(c // base for c in block_out),
            num_res_blocks=hf.get("layers_per_block", 2),
            scaling_factor=hf.get("scaling_factor", 0.18215),
        )


def _res(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = F.silu(group_norm(x, p["norm1"]))
    h = conv2d(h, p["conv1"])
    h = F.silu(group_norm(h, p["norm2"]))
    h = conv2d(h, p["conv2"])
    if "skip" in p:
        x = conv2d(x, p["skip"])
    return x + h


def _attn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Single-head spatial self-attention at the bottleneck."""
    B, C, H, W = x.shape
    h = group_norm(x, p["norm"]).permute(0, 2, 3, 1).reshape(B, H * W, C)
    q = _linear(h, p["wq"], p["bq"])
    k = _linear(h, p["wk"], p["bk"])
    v = _linear(h, p["wv"], p["bv"])
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(C)
    probs = torch.softmax(scores.float(), -1).to(h.dtype)
    del scores
    out = _linear(torch.matmul(probs, v), p["wo"], p["bo"])
    return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def decode(cfg: VAEConfig, params: PyTree,
           latents: torch.Tensor) -> torch.Tensor:
    """Latents [B, L, h, w] (already divided by scaling_factor) → images
    [B, 3, h * downscale, w * downscale] in [-1, 1] (float32)."""
    p = params["decoder"]
    x = latents.to(torch_dtype(cfg.dtype))
    x = conv2d(x, params["post_quant_conv"])
    x = conv2d(x, p["conv_in"])
    x = _res(x, p["mid"]["res1"])
    x = _attn(x, p["mid"]["attn"])
    x = _res(x, p["mid"]["res2"])
    for lp in p["up"]:
        for rp in lp["res"]:
            x = _res(x, rp)
        if "up" in lp:
            x = conv2d(upsample2x(x), lp["up"])
    x = F.silu(group_norm(x, p["norm_out"]))
    return conv2d(x, p["conv_out"]).float()


def encode(cfg: VAEConfig, params: PyTree, images: torch.Tensor,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Images [B, 3, H, W] in [-1, 1] → latents [B, L, H/ds, W/ds] times
    scaling_factor: the posterior's mean, or a sample with ``noise``
    (a standard normal draw of the latents' shape)."""
    p = params["encoder"]
    x = images.to(torch_dtype(cfg.dtype))
    x = conv2d(x, p["conv_in"])
    for lp in p["down"]:
        for rp in lp["res"]:
            x = _res(x, rp)
        if "down" in lp:
            x = conv2d(x, lp["down"], stride=2, padding=((0, 1), (0, 1)))
    x = _res(x, p["mid"]["res1"])
    x = _attn(x, p["mid"]["attn"])
    x = _res(x, p["mid"]["res2"])
    x = F.silu(group_norm(x, p["norm_out"]))
    x = conv2d(x, p["conv_out"])              # [B, 2L, h, w]: mean ‖ logvar
    x = conv2d(x, params["quant_conv"])
    mean, logvar = x.float().chunk(2, dim=1)
    if noise is not None:
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * noise.to(mean.device, torch.float32)
    return mean * cfg.scaling_factor


# ---------------------------------------------------------------------------
# shapes / init
# ---------------------------------------------------------------------------

def _res_shapes(cin, cout):
    p = {
        "norm1": {"g": (cin,), "b": (cin,)},
        "conv1": conv_shape(cin, cout),
        "norm2": {"g": (cout,), "b": (cout,)},
        "conv2": conv_shape(cout, cout),
    }
    if cin != cout:
        p["skip"] = conv_shape(cin, cout, k=1)
    return p


def _attn_shapes(ch):
    return {
        "norm": {"g": (ch,), "b": (ch,)},
        "wq": (ch, ch), "bq": (ch,), "wk": (ch, ch), "bk": (ch,),
        "wv": (ch, ch), "bv": (ch,), "wo": (ch, ch), "bo": (ch,),
    }


def param_shapes(cfg: VAEConfig) -> PyTree:
    bc = cfg.base_channels
    chs = [bc * m for m in cfg.channel_mult]
    top = chs[-1]
    enc_down = []
    ch = bc
    for lvl, out_ch in enumerate(chs):
        lp: dict[str, Any] = {"res": []}
        for _ in range(cfg.num_res_blocks):
            lp["res"].append(_res_shapes(ch, out_ch))
            ch = out_ch
        if lvl != len(chs) - 1:
            lp["down"] = conv_shape(ch, ch)
        enc_down.append(lp)
    dec_up = []
    ch = top
    for lvl in reversed(range(len(chs))):
        out_ch = chs[lvl]
        lp = {"res": []}
        for _ in range(cfg.num_res_blocks + 1):
            lp["res"].append(_res_shapes(ch, out_ch))
            ch = out_ch
        if lvl != 0:
            lp["up"] = conv_shape(ch, ch)
        dec_up.append(lp)
    L = cfg.latent_channels
    return {
        "encoder": {
            "conv_in": conv_shape(cfg.in_channels, bc),
            "down": enc_down,
            "mid": {"res1": _res_shapes(top, top), "attn": _attn_shapes(top),
                    "res2": _res_shapes(top, top)},
            "norm_out": {"g": (top,), "b": (top,)},
            "conv_out": conv_shape(top, 2 * L),
        },
        "quant_conv": conv_shape(2 * L, 2 * L, k=1),
        "post_quant_conv": conv_shape(L, L, k=1),
        "decoder": {
            "conv_in": conv_shape(L, top),
            "mid": {"res1": _res_shapes(top, top), "attn": _attn_shapes(top),
                    "res2": _res_shapes(top, top)},
            "up": dec_up,
            "norm_out": {"g": (ch,), "b": (ch,)},
            "conv_out": conv_shape(ch, cfg.in_channels),
        },
    }


def init_params(cfg: VAEConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> PyTree:
    """Random VAE weights (gains 1, biases 0, the rest N(0, 1/fan_in))."""
    return draw_params(param_shapes(cfg), cfg.dtype, seed, device)
