"""LoRA adapters for the diffusion pipeline, merged into the base weights
at load.

Port of ``localai_tpu/image/lora.py``: a kohya-format safetensors file
(``lora_unet_*`` / ``lora_te_*`` keys with lora_down / lora_up / alpha) or
the diffusers/peft layout (``unet.…lora_A/lora_B``) folds
ΔW = scale · (alpha / r) · up @ down into each target layer, on the host
trees before they go to the device, as the JAX package merges. The file is
read through the port's own safetensors reader. The targets are found by
walking the port's tree (which mirrors the diffusers module tree, by the
loader's construction) and keying every site by its flattened module
name, so a lookup is exact instead of parsing underscore-ambiguous names.
The trees differ from the JAX package's only in the conv layout (OIHW
here, which is ΔW's own layout).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Site:
    """One LoRA-targetable weight: the dict holding it, its key, and its
    kind (linear [in, out]; conv1x1 or conv, OIHW)."""

    holder: dict
    key: str
    kind: str


def _attn_sites(out: dict, base: str, ap: dict) -> None:
    for ours, theirs in (("wq", "to_q"), ("wk", "to_k"), ("wv", "to_v"),
                         ("wo", "to_out.0")):
        out[f"{base}.{theirs}"] = _Site(ap, ours, "linear")


def _st_sites(out: dict, base: str, sp: dict) -> None:
    out[f"{base}.proj_in"] = _Site(sp["proj_in"], "w", "conv1x1")
    out[f"{base}.proj_out"] = _Site(sp["proj_out"], "w", "conv1x1")
    for b, bp in enumerate(sp["blocks"]):
        tb = f"{base}.transformer_blocks.{b}"
        _attn_sites(out, f"{tb}.attn1", bp["attn1"])
        _attn_sites(out, f"{tb}.attn2", bp["attn2"])
        out[f"{tb}.ff.net.0.proj"] = _Site(bp["ff"], "w1", "linear")
        out[f"{tb}.ff.net.2"] = _Site(bp["ff"], "w2", "linear")


def _res_sites(out: dict, base: str, rp: dict) -> None:
    out[f"{base}.conv1"] = _Site(rp["conv1"], "w", "conv")
    out[f"{base}.conv2"] = _Site(rp["conv2"], "w", "conv")
    if "temb" in rp:
        out[f"{base}.time_emb_proj"] = _Site(rp["temb"], "w", "linear")
    if "skip" in rp:
        out[f"{base}.conv_shortcut"] = _Site(rp["skip"], "w", "conv")


def unet_sites(params: dict) -> dict[str, _Site]:
    """Every LoRA-targetable UNet weight by its diffusers module path."""
    out: dict[str, _Site] = {}
    for lvl, lp in enumerate(params["down"]):
        base = f"down_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _res_sites(out, f"{base}.resnets.{j}", rp)
        for j, sp in enumerate(lp["attn"] or []):
            _st_sites(out, f"{base}.attentions.{j}", sp)
    _res_sites(out, "mid_block.resnets.0", params["mid"]["res1"])
    _res_sites(out, "mid_block.resnets.1", params["mid"]["res2"])
    _st_sites(out, "mid_block.attentions.0", params["mid"]["attn"])
    for lvl, lp in enumerate(params["up"]):
        base = f"up_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _res_sites(out, f"{base}.resnets.{j}", rp)
        for j, sp in enumerate(lp["attn"] or []):
            _st_sites(out, f"{base}.attentions.{j}", sp)
    return out


def text_encoder_sites(params: dict) -> dict[str, _Site]:
    out: dict[str, _Site] = {}
    for i, layer in enumerate(params["layers"]):
        base = f"text_model.encoder.layers.{i}"
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            out[f"{base}.self_attn.{theirs}"] = _Site(layer["attn"],
                                                      f"w{ours}", "linear")
        out[f"{base}.mlp.fc1"] = _Site(layer["mlp"], "w1", "linear")
        out[f"{base}.mlp.fc2"] = _Site(layer["mlp"], "w2", "linear")
    return out


# ---------------------------------------------------------------------------
# LoRA file parsing


@dataclasses.dataclass
class LoraLayer:
    down: np.ndarray   # [r, in] (or [r, in, kh, kw] for convs)
    up: np.ndarray     # [out, r] (or [out, r, 1, 1])
    alpha: Optional[float]

    def delta(self, scale: float) -> np.ndarray:
        """The [out, in(, kh, kw)] merged update."""
        r = self.down.shape[0]
        # alpha == 0 is a valid author-zeroed layer: only a MISSING alpha
        # defaults to 1.0
        weight = scale * (
            (self.alpha / r) if self.alpha is not None else 1.0)
        if self.down.ndim == 4:
            up = self.up[:, :, 0, 0]                 # [out, r]
            dw = np.einsum("or,ri...->oi...", up, self.down)
        else:
            dw = self.up @ self.down                 # [out, in]
        return (weight * dw).astype(np.float32)


def read_lora_file(path: str | Path) -> dict[tuple[str, str], LoraLayer]:
    """LoRA safetensors → {(component, flat module name): LoraLayer}, the
    component "unet" or "te"; kohya (lora_unet_* / lora_te_*, lora_down /
    lora_up / alpha) and diffusers/peft (unet. / text_encoder. prefixes,
    lora_A / lora_B) layouts."""
    from localai_tpu_torch.models.loader import (
        read_safetensors_index,
        read_tensor,
    )

    raw = {k: read_tensor(e).float().numpy()
           for k, e in read_safetensors_index(path).items()}

    groups: dict[tuple[str, str], dict] = {}

    def put(component: str, module: str, part: str, value) -> None:
        groups.setdefault((component, module.replace(".", "_")), {})[
            part] = value

    def split_component(k: str) -> tuple[str, str]:
        """A diffusers-layout key → (component, module-relative key): one
        prefix table shared by weights and alpha."""
        for pre, comp in (("unet.", "unet"), ("text_encoder.", "te"),
                          ("te.", "te")):
            if k.startswith(pre):
                return comp, k[len(pre):]
        return "unet", k

    for key, val in raw.items():
        if key.startswith(("lora_unet_", "lora_te_")):
            component = "unet" if key.startswith("lora_unet_") else "te"
            body = key.split("_", 2)[-1]
            module, _, part = body.partition(".")
            if part.startswith("lora_down"):
                put(component, module, "down", val)
            elif part.startswith("lora_up"):
                put(component, module, "up", val)
            elif part == "alpha":
                put(component, module, "alpha", float(val))
        elif ".lora_A." in key or ".lora_B." in key or \
                ".lora.down." in key or ".lora.up." in key:
            component, k = split_component(key)
            for marker, part in ((".lora_A.", "down"), (".lora_B.", "up"),
                                 (".lora.down.", "down"),
                                 (".lora.up.", "up")):
                if marker in k:
                    put(component, k.split(marker)[0], part, val)
                    break
        elif key.endswith(".alpha"):
            component, k = split_component(key[: -len(".alpha")])
            put(component, k, "alpha", float(val))

    out: dict[tuple[str, str], LoraLayer] = {}
    for gk, g in groups.items():
        if "down" in g and "up" in g:
            out[gk] = LoraLayer(g["down"], g["up"], g.get("alpha"))
        else:
            log.debug("incomplete LoRA group %s (parts: %s)", gk, sorted(g))
    return out


# ---------------------------------------------------------------------------
# merging


def apply_lora(unet_params: dict, text_params: Optional[dict],
               lora_path: str | Path, scale: float = 1.0) -> int:
    """Fold a LoRA file into the host trees in place (each merged weight
    in float32); returns the
    number of layers merged. A target no module has is skipped with a
    warning; a shape mismatch raises (a LoRA of another architecture must
    not silently corrupt the weights)."""
    layers = read_lora_file(lora_path)
    if not layers:
        raise ValueError(f"no LoRA layers found in {lora_path}")
    sites: dict[tuple[str, str], _Site] = {}
    for name, site in unet_sites(unet_params).items():
        sites[("unet", name.replace(".", "_"))] = site
    if text_params is not None:
        for name, site in text_encoder_sites(text_params).items():
            sites[("te", name.replace(".", "_"))] = site

    merged = 0
    for key, layer in layers.items():
        site = sites.get(key)
        if site is None:
            log.warning("LoRA target %s/%s has no matching module; "
                        "skipping", *key)
            continue
        dw = layer.delta(scale)
        w = site.holder[site.key]
        if site.kind == "linear":
            upd = dw.T                                   # [in, out]
        elif dw.ndim == 2:                               # a 1x1-shaped file
            upd = dw[:, :, None, None]
        elif site.kind == "conv1x1":
            upd = dw[:, :, :1, :1]
        else:
            upd = dw
        if tuple(upd.shape) != tuple(w.shape):
            raise ValueError(
                f"LoRA {key} shape {tuple(upd.shape)} does not match target "
                f"{tuple(w.shape)}: wrong base model?")
        # float32, as the JAX package merges: the device cast rounds once
        site.holder[site.key] = w.float() + torch.from_numpy(
            np.ascontiguousarray(upd))
        merged += 1
    log.info("merged %d LoRA layer(s) from %s (scale %.2f)", merged,
             lora_path, scale)
    return merged
