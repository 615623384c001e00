"""ControlNet: condition-image guidance for the diffusion pipeline.

Port of ``localai_tpu/image/controlnet.py``: a copy of the UNet's encoder
(conv_in → down blocks → mid) plus a small conv stack that embeds the
condition image, emitting one zero-conv residual per UNet skip and one for
the mid block, which the base UNet adds in its up pass. The forward reuses
the UNet module's blocks, and the loader is the UNet loader's pieces plus
the ControlNet heads.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from localai_tpu_torch.image import unet as unet_mod
from localai_tpu_torch.image.unet import UNetConfig, conv2d, torch_dtype

PyTree = Any


def cond_embedding(p: PyTree, image: torch.Tensor) -> torch.Tensor:
    """Condition image [B, 3, H, W] in [0, 1] → [B, C, h, w] features
    (conv_in, silu conv pairs whose second conv has stride 2 and XLA's
    SAME padding, a zero conv_out)."""
    h = F.silu(conv2d(image, p["conv_in"]))
    for blk in p["blocks"]:
        h = F.silu(conv2d(h, blk["a"]))
        h = F.silu(conv2d(h, blk["b"], stride=2))
    return conv2d(h, p["conv_out"])


def forward(cfg: UNetConfig, params: PyTree, latents: torch.Tensor,
            timesteps: torch.Tensor, context: torch.Tensor,
            cond_image: torch.Tensor, conditioning_scale=1.0,
            pooled_text=None, time_ids=None):
    """ControlNet pass → (down residuals, mid residual), each scaled by
    ``conditioning_scale``, shaped to add onto the base UNet's skips."""
    dtype = torch_dtype(cfg.dtype)
    x = latents.to(dtype)
    context = context.to(dtype)
    temb = unet_mod.time_embedding(cfg, params, timesteps, pooled_text,
                                   time_ids)

    h = conv2d(x, params["conv_in"])
    h = h + cond_embedding(params["cond_emb"], cond_image.to(dtype))

    feats = [h]
    for lvl, lp in enumerate(params["down"]):
        for i, rp in enumerate(lp["res"]):
            h = unet_mod.res_block(h, temb, rp)
            if lp.get("attn"):
                h = unet_mod.spatial_transformer(
                    h, context, lp["attn"][i], cfg, cfg.heads_at(lvl))
            feats.append(h)
        if lp.get("down"):
            h = unet_mod.downsample(h, lp["down"])
            feats.append(h)

    mid = params["mid"]
    n_lvls = len(params["down"])
    h = unet_mod.res_block(h, temb, mid["res1"])
    h = unet_mod.spatial_transformer(h, context, mid["attn"], cfg,
                                     cfg.heads_at(n_lvls - 1))
    h = unet_mod.res_block(h, temb, mid["res2"])

    # the scale rounds to the compute dtype first, as the JAX code casts it
    scale = float(torch.tensor(float(conditioning_scale),
                               dtype=torch.float32).to(dtype))
    down_res = [conv2d(f, zp) * scale
                for f, zp in zip(feats, params["zero_convs"])]
    mid_res = conv2d(h, params["mid_zero"]) * scale
    return down_res, mid_res


def param_shapes(cfg: UNetConfig, cond_channels=(16, 32, 96, 256)
                 ) -> PyTree:
    """A ControlNet's leaves: the UNet's encoder half, the condition
    embedding (``conditioning_embedding_out_channels``) and the zero
    convs."""
    full = unet_mod.param_shapes(cfg)
    shapes = {k: full[k] for k in ("conv_in", "time_emb", "down", "mid")}
    if "add_emb" in full:
        shapes["add_emb"] = full["add_emb"]
    cs = unet_mod.conv_shape
    shapes["cond_emb"] = {
        "conv_in": cs(3, cond_channels[0]),
        "blocks": [{"a": cs(a, a), "b": cs(a, b)}
                   for a, b in zip(cond_channels, cond_channels[1:])],
        "conv_out": cs(cond_channels[-1], cfg.model_channels),
    }
    mc = cfg.model_channels
    skip_chs = [mc]
    for lvl, mult in enumerate(cfg.channel_mult):
        skip_chs += [mc * mult] * cfg.num_res_blocks
        if lvl != len(cfg.channel_mult) - 1:
            skip_chs.append(mc * mult)
    shapes["zero_convs"] = [cs(c, c, k=1) for c in skip_chs]
    top = mc * cfg.channel_mult[-1]
    shapes["mid_zero"] = cs(top, top, k=1)
    return shapes


def init_params(cfg: UNetConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                cond_channels=(16, 32, 96, 256)) -> PyTree:
    """Random ControlNet weights (the UNet's scheme)."""
    return unet_mod.draw_params(param_shapes(cfg, cond_channels), cfg.dtype,
                                seed, device)


def load_controlnet(d: str | Path):
    """A diffusers ControlNetModel dir → (UNetConfig, host params in the
    port's layout, in the file's dtype)."""
    from localai_tpu_torch.image.loader import _conv, _open_dir, encoder_half

    d = Path(d)
    with open(d / "config.json") as f:
        cfg = UNetConfig.from_hf(json.load(f))
    t = _open_dir(d)
    params = encoder_half(t, cfg)
    ce = "controlnet_cond_embedding"
    blocks = []
    i = 0
    while f"{ce}.blocks.{i}.weight" in t:
        blocks.append({"a": _conv(t, f"{ce}.blocks.{i}"),
                       "b": _conv(t, f"{ce}.blocks.{i + 1}")})
        i += 2
    params["cond_emb"] = {
        "conv_in": _conv(t, f"{ce}.conv_in"),
        "blocks": blocks,
        "conv_out": _conv(t, f"{ce}.conv_out"),
    }

    zero = []
    j = 0
    while f"controlnet_down_blocks.{j}.weight" in t:
        zero.append(_conv(t, f"controlnet_down_blocks.{j}"))
        j += 1
    params["zero_convs"] = zero
    params["mid_zero"] = _conv(t, "controlnet_mid_block")
    return cfg, params


def resolve_controlnet(ref: str, model_path: str | Path = "models"):
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            return load_controlnet(cand)
    raise FileNotFoundError(f"controlnet ref {ref!r} not found")
