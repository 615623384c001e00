"""Diffusers-layout checkpoints → the port's parameter trees, and back.

Port of ``localai_tpu/image/loader.py``: reads a local diffusers directory
(``model_index.json`` + ``unet/ vae/ text_encoder/ tokenizer/``, and
SDXL's ``text_encoder_2/ tokenizer_2/``) through the port's own
safetensors reader (``models/loader.py``; no ``safetensors`` package) and
maps the state dicts onto the trees of ``image.unet``, ``image.vae`` and
``image.clip``. Tensors stay in the file's dtype on the host (a LoRA
merges there in float32, ``image.lora``), then :func:`_to_device` moves
each to the device and casts it as the JAX package casts its float32
copy: leaves with more than one dimension to the config's dtype, vectors
(biases, norm gains) to float32. Every file dtype widens to float32
exactly, so the bits are the JAX package's, without a float32 tree on
the host or twice the bytes over the bus. Conv kernels stay OIHW (the JAX
package transposes them to HWIO); linear weights [out, in] become
[in, out]; SD-2.x / SDXL's linear ``proj_in``/``proj_out`` become 1x1
convs, as there.

:func:`write_diffusers_pipeline` writes a tree back in the same layout
(the tests and ``chip_smoke.py`` write seeded checkpoints with it), and
:func:`from_jax_params` carries a JAX package tree across (HWIO → OIHW).
FLUX's ``transformer/`` (an MMDiT) and ``text_encoder_2/`` (T5's
encoder, any number of shards) go through one table of entries each
(:func:`mmdit_entries`, :func:`t5_entries`: file name, tree path, layer,
transposed), which :func:`load_entries` reads, casting every leaf on the
device as it arrives and filling each stacked leaf in place, and
:func:`write_sharded` writes.
The CLIP tokenizer is read from ``tokenizer.json``, or from ``vocab.json``
+ ``merges.txt`` as ``CLIPTokenizerFast`` converts them
(``utils.hf_tokenizer.clip_tokenizer_spec``); a directory with neither
falls back to the byte tokenizer with a warning, as the JAX package's
does.
"""

from __future__ import annotations

import functools
import json
import logging
import math
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from localai_tpu_torch.image import mmdit as _mmdit
from localai_tpu_torch.image import t5 as _t5
from localai_tpu_torch.image.clip import CLIPTextConfig
from localai_tpu_torch.image.unet import UNetConfig, torch_dtype
from localai_tpu_torch.image.vae import VAEConfig
from localai_tpu_torch.models.loader import (
    read_safetensors_index,
    read_tensor,
    write_safetensors,
)
from localai_tpu_torch.utils.device import params_from_numpy, resolve_device

log = logging.getLogger(__name__)

PyTree = Any


def _open_dir(d: Path) -> dict[str, tuple]:
    files = sorted(Path(d).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {d}")
    tensors: dict[str, tuple] = {}
    for fp in files:
        tensors.update(read_safetensors_index(fp))
    return tensors


def _np(tensors: dict, key: str) -> torch.Tensor:
    """One tensor on the host, in the file's dtype."""
    return read_tensor(tensors[key])


def _conv(tensors, prefix: str) -> dict:
    return {"w": _np(tensors, f"{prefix}.weight"),
            "b": _np(tensors, f"{prefix}.bias")}


def _lin(tensors, prefix: str, *, bias: bool = True) -> tuple:
    w = _np(tensors, f"{prefix}.weight")
    if w.dim() == 4:  # a 1x1 conv posing as a linear (older VAE attention)
        w = w[:, :, 0, 0]
    out = w.t().contiguous()
    return (out, _np(tensors, f"{prefix}.bias")) if bias else (out,)


def _norm(tensors, prefix: str) -> dict:
    return {"g": _np(tensors, f"{prefix}.weight"),
            "b": _np(tensors, f"{prefix}.bias")}


def _proj_1x1(tensors, prefix: str) -> dict:
    """proj_in / proj_out: a 1x1 conv in SD-1.x, a linear in SD-2.x and
    SDXL; either loads as the 1x1 conv [out, in, 1, 1]."""
    w = _np(tensors, f"{prefix}.weight")
    if w.dim() == 2:
        w = w[:, :, None, None]
    return {"w": w, "b": _np(tensors, f"{prefix}.bias")}


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _res_params(t, prefix: str, *, temb: bool = True) -> dict:
    p = {
        "norm1": _norm(t, f"{prefix}.norm1"),
        "conv1": _conv(t, f"{prefix}.conv1"),
        "norm2": _norm(t, f"{prefix}.norm2"),
        "conv2": _conv(t, f"{prefix}.conv2"),
    }
    if temb:
        w, b = _lin(t, f"{prefix}.time_emb_proj")
        p["temb"] = {"w": w, "b": b}
    if f"{prefix}.conv_shortcut.weight" in t:
        p["skip"] = _conv(t, f"{prefix}.conv_shortcut")
    return p


def _xattn_params(t, prefix: str) -> dict:
    (wq,) = _lin(t, f"{prefix}.to_q", bias=False)
    (wk,) = _lin(t, f"{prefix}.to_k", bias=False)
    (wv,) = _lin(t, f"{prefix}.to_v", bias=False)
    wo, bo = _lin(t, f"{prefix}.to_out.0")
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo, "bo": bo}


def _st_params(t, prefix: str) -> dict:
    blocks = []
    i = 0
    while f"{prefix}.transformer_blocks.{i}.norm1.weight" in t:
        bp = f"{prefix}.transformer_blocks.{i}"
        w1, b1 = _lin(t, f"{bp}.ff.net.0.proj")
        w2, b2 = _lin(t, f"{bp}.ff.net.2")
        blocks.append({
            "ln1": _norm(t, f"{bp}.norm1"),
            "attn1": _xattn_params(t, f"{bp}.attn1"),
            "ln2": _norm(t, f"{bp}.norm2"),
            "attn2": _xattn_params(t, f"{bp}.attn2"),
            "ln3": _norm(t, f"{bp}.norm3"),
            "ff": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        })
        i += 1
    return {
        "norm": _norm(t, f"{prefix}.norm"),
        "proj_in": _proj_1x1(t, f"{prefix}.proj_in"),
        "blocks": blocks,
        "proj_out": _proj_1x1(t, f"{prefix}.proj_out"),
    }


def _mlp(t, prefix: str) -> dict:
    w1, b1 = _lin(t, f"{prefix}.linear_1")
    w2, b2 = _lin(t, f"{prefix}.linear_2")
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


def encoder_half(t, cfg: UNetConfig) -> dict:
    """conv_in, the time MLPs (SDXL's text_time one when present), the
    down blocks and the mid block: what a UNet and a ControlNet share."""
    params: dict[str, Any] = {"conv_in": _conv(t, "conv_in"),
                              "time_emb": _mlp(t, "time_embedding")}
    if "add_embedding.linear_1.weight" in t:
        params["add_emb"] = _mlp(t, "add_embedding")
    down = []
    for lvl in range(len(cfg.channel_mult)):
        base = f"down_blocks.{lvl}"
        has_attn = f"{base}.attentions.0.norm.weight" in t
        lp: dict[str, Any] = {
            "res": [_res_params(t, f"{base}.resnets.{j}")
                    for j in range(cfg.num_res_blocks)],
            "attn": [_st_params(t, f"{base}.attentions.{j}")
                     for j in range(cfg.num_res_blocks)] if has_attn
            else None,
        }
        if f"{base}.downsamplers.0.conv.weight" in t:
            lp["down"] = _conv(t, f"{base}.downsamplers.0.conv")
        down.append(lp)
    params["down"] = down
    params["mid"] = {
        "res1": _res_params(t, "mid_block.resnets.0"),
        "attn": _st_params(t, "mid_block.attentions.0"),
        "res2": _res_params(t, "mid_block.resnets.1"),
    }
    return params


def load_unet(d: Path) -> tuple[UNetConfig, PyTree]:
    with open(Path(d) / "config.json") as f:
        cfg = UNetConfig.from_hf(json.load(f))
    t = _open_dir(d)
    params = encoder_half(t, cfg)
    params["norm_out"] = _norm(t, "conv_norm_out")
    params["conv_out"] = _conv(t, "conv_out")
    up = []
    for i in range(len(cfg.channel_mult)):
        base = f"up_blocks.{i}"
        has_attn = f"{base}.attentions.0.norm.weight" in t
        lp = {
            "res": [_res_params(t, f"{base}.resnets.{j}")
                    for j in range(cfg.num_res_blocks + 1)],
            "attn": [_st_params(t, f"{base}.attentions.{j}")
                     for j in range(cfg.num_res_blocks + 1)] if has_attn
            else None,
        }
        if f"{base}.upsamplers.0.conv.weight" in t:
            lp["up"] = _conv(t, f"{base}.upsamplers.0.conv")
        up.append(lp)
    params["up"] = up
    return cfg, params


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_attn(t, prefix: str) -> dict:
    # newer diffusers: group_norm + to_q/to_k/to_v/to_out.0 linears;
    # older: norm + q/k/v/proj_out 1x1 convs
    if f"{prefix}.group_norm.weight" in t:
        names = ("group_norm", "to_q", "to_k", "to_v", "to_out.0")
    else:
        names = ("norm", "q", "k", "v", "proj_out")
    norm, q, k, v, o = names
    wq, bq = _lin(t, f"{prefix}.{q}")
    wk, bk = _lin(t, f"{prefix}.{k}")
    wv, bv = _lin(t, f"{prefix}.{v}")
    wo, bo = _lin(t, f"{prefix}.{o}")
    return {"norm": _norm(t, f"{prefix}.{norm}"),
            "wq": wq, "bq": bq, "wk": wk, "bk": bk,
            "wv": wv, "bv": bv, "wo": wo, "bo": bo}


def _vae_mid(t, prefix: str) -> dict:
    return {"res1": _res_params(t, f"{prefix}.resnets.0", temb=False),
            "attn": _vae_attn(t, f"{prefix}.attentions.0"),
            "res2": _res_params(t, f"{prefix}.resnets.1", temb=False)}


def load_vae(d: Path) -> tuple[VAEConfig, PyTree]:
    with open(Path(d) / "config.json") as f:
        cfg = VAEConfig.from_hf(json.load(f))
    t = _open_dir(d)
    levels = len(cfg.channel_mult)
    enc_down = []
    for lvl in range(levels):
        base = f"encoder.down_blocks.{lvl}"
        lp: dict[str, Any] = {
            "res": [_res_params(t, f"{base}.resnets.{j}", temb=False)
                    for j in range(cfg.num_res_blocks)]}
        if f"{base}.downsamplers.0.conv.weight" in t:
            lp["down"] = _conv(t, f"{base}.downsamplers.0.conv")
        enc_down.append(lp)
    dec_up = []
    for i in range(levels):
        base = f"decoder.up_blocks.{i}"
        lp = {"res": [_res_params(t, f"{base}.resnets.{j}", temb=False)
                      for j in range(cfg.num_res_blocks + 1)]}
        if f"{base}.upsamplers.0.conv.weight" in t:
            lp["up"] = _conv(t, f"{base}.upsamplers.0.conv")
        dec_up.append(lp)
    params = {
        "encoder": {
            "conv_in": _conv(t, "encoder.conv_in"),
            "down": enc_down,
            "mid": _vae_mid(t, "encoder.mid_block"),
            "norm_out": _norm(t, "encoder.conv_norm_out"),
            "conv_out": _conv(t, "encoder.conv_out"),
        },
        "quant_conv": _conv(t, "quant_conv"),
        "post_quant_conv": _conv(t, "post_quant_conv"),
        "decoder": {
            "conv_in": _conv(t, "decoder.conv_in"),
            "mid": _vae_mid(t, "decoder.mid_block"),
            "up": dec_up,
            "norm_out": _norm(t, "decoder.conv_norm_out"),
            "conv_out": _conv(t, "decoder.conv_out"),
        },
    }
    return cfg, params


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

_CLIP_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
              ("o", "out_proj"))


def load_text_encoder(d: Path) -> tuple[CLIPTextConfig, PyTree]:
    with open(Path(d) / "config.json") as f:
        cfg = CLIPTextConfig.from_hf(json.load(f))
    t = _open_dir(d)
    pre = "text_model."
    layers = []
    for i in range(cfg.num_layers):
        base = f"{pre}encoder.layers.{i}"
        attn = {}
        for ours, theirs in _CLIP_ATTN:
            w, b = _lin(t, f"{base}.self_attn.{theirs}")
            attn[f"w{ours}"] = w
            attn[f"b{ours}"] = b
        w1, b1 = _lin(t, f"{base}.mlp.fc1")
        w2, b2 = _lin(t, f"{base}.mlp.fc2")
        layers.append({
            "ln1": _norm(t, f"{base}.layer_norm1"),
            "attn": attn,
            "ln2": _norm(t, f"{base}.layer_norm2"),
            "mlp": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        })
    params = {
        "token_emb": _np(t, f"{pre}embeddings.token_embedding.weight"),
        "pos_emb": _np(t, f"{pre}embeddings.position_embedding.weight"),
        "layers": layers,
        "ln_f": _norm(t, f"{pre}final_layer_norm"),
    }
    if "text_projection.weight" in t:
        # SDXL's text_encoder_2 pools through a projection (no bias)
        params["text_projection"] = _np(t, "text_projection.weight").t()
    return cfg, params


# ---------------------------------------------------------------------------
# FLUX: the MMDiT and T5's encoder, cast leaf by leaf on the device


def cast_leaf(a: torch.Tensor, dtype: torch.dtype,
              device: str | torch.device, transpose: bool = False
              ) -> torch.Tensor:
    """One tensor on ``device`` in the JAX package's cast (more than one
    dimension → ``dtype``, a vector → float32), [out, in] → [in, out]
    when ``transpose``, contiguous; cast on the device (the bus carries
    the file's bytes), with one allocation of the result beside them."""
    a = a.to(device)
    if transpose:
        a = a.t()
    want = dtype if a.dim() > 1 else torch.float32
    if a.dtype == want and a.is_contiguous():
        return a
    return torch.empty(a.shape, dtype=want, device=a.device).copy_(a)


def leaf(t: dict, name: str, dtype: torch.dtype,
         device: str | torch.device, transpose: bool = False
         ) -> torch.Tensor:
    """One tensor of the file, as :func:`cast_leaf` casts it."""
    return cast_leaf(_np(t, name), dtype, device, transpose)


def stacked(t: dict, names: list, dtype: torch.dtype,
            device: str | torch.device, transpose: bool = False
            ) -> torch.Tensor:
    """The tensors ``names`` stacked as one [len(names), ...] leaf in
    ``dtype`` on ``device``, allocated once and filled layer by layer (no
    per-layer device copies held at once)."""
    first = _np(t, names[0])
    shape = tuple(first.shape[::-1]) if transpose else tuple(first.shape)
    out = torch.empty((len(names),) + shape, dtype=dtype,
                      device=resolve_device(device))
    for i, name in enumerate(names):
        a = (first if i == 0 else _np(t, name)).to(out.device)
        out[i].copy_(a.t() if transpose else a)
    return out


# FluxTransformer2DModel's linears (weight leaf, bias leaf, diffusers
# prefix), its per-head norm gains (leaf, name) and the embedders
_MMDIT_TOP = (("x_embed_w", "x_embed_b", "x_embedder"),
              ("ctx_embed_w", "ctx_embed_b", "context_embedder"),
              ("norm_out_w", "norm_out_b", "norm_out.linear"),
              ("proj_out_w", "proj_out_b", "proj_out"))
_MMDIT_MLPS = (("time_mlp", "time_text_embed.timestep_embedder"),
               ("text_mlp", "time_text_embed.text_embedder"),
               ("guid_mlp", "time_text_embed.guidance_embedder"))
_DOUBLE_LIN = (("mod_x_w", "mod_x_b", "norm1.linear"),
               ("mod_c_w", "mod_c_b", "norm1_context.linear"),
               ("wq_x", "bq_x", "attn.to_q"), ("wk_x", "bk_x", "attn.to_k"),
               ("wv_x", "bv_x", "attn.to_v"),
               ("wo_x", "bo_x", "attn.to_out.0"),
               ("wq_c", "bq_c", "attn.add_q_proj"),
               ("wk_c", "bk_c", "attn.add_k_proj"),
               ("wv_c", "bv_c", "attn.add_v_proj"),
               ("wo_c", "bo_c", "attn.to_add_out"),
               ("ff_x_w1", "ff_x_b1", "ff.net.0.proj"),
               ("ff_x_w2", "ff_x_b2", "ff.net.2"),
               ("ff_c_w1", "ff_c_b1", "ff_context.net.0.proj"),
               ("ff_c_w2", "ff_c_b2", "ff_context.net.2"))
_DOUBLE_NORM = (("qn_x", "attn.norm_q"), ("kn_x", "attn.norm_k"),
                ("qn_c", "attn.norm_added_q"), ("kn_c", "attn.norm_added_k"))
_SINGLE_LIN = (("mod_w", "mod_b", "norm.linear"), ("wq", "bq", "attn.to_q"),
               ("wk", "bk", "attn.to_k"), ("wv", "bv", "attn.to_v"),
               ("mlp_w", "mlp_b", "proj_mlp"), ("out_w", "out_b", "proj_out"))
_SINGLE_NORM = (("qn", "attn.norm_q"), ("kn", "attn.norm_k"))


def mmdit_entries(cfg) -> list[tuple[str, tuple, Optional[int], bool]]:
    """Every tensor of a ``FluxTransformer2DModel`` state dict as
    (diffusers name, leaf path in the MMDiT tree, layer index of a stacked
    leaf or None, stored transposed), in one fixed order: what the loader
    reads and the writer writes."""
    out: list = []

    def lin(w, b, prefix, path=(), layer=None):
        out.append((f"{prefix}.weight", path + (w,), layer, True))
        out.append((f"{prefix}.bias", path + (b,), layer, False))

    for w, b, prefix in _MMDIT_TOP:
        lin(w, b, prefix)
    for key, prefix in _MMDIT_MLPS:
        if key == "guid_mlp" and not cfg.guidance_embeds:
            continue
        lin("w1", "b1", f"{prefix}.linear_1", (key,))
        lin("w2", "b2", f"{prefix}.linear_2", (key,))
    for block, n, lins, norms, fmt in (
            ("double", cfg.num_layers, _DOUBLE_LIN, _DOUBLE_NORM,
             "transformer_blocks.{i}."),
            ("single", cfg.num_single_layers, _SINGLE_LIN, _SINGLE_NORM,
             "single_transformer_blocks.{i}.")):
        for i in range(n):
            pre = fmt.format(i=i)
            for w, b, name in lins:
                lin(w, b, pre + name, (block,), i)
            for key, name in norms:
                out.append((f"{pre}{name}.weight", (block, key), i, False))
    return out


def _assemble(entries: list, get_leaf, get_stack) -> dict:
    """A tree from (name, path, layer, transposed) entries: a leaf per
    unstacked path, one stacked leaf per path of layered entries."""
    tree: dict = {}
    groups: dict = {}
    for name, path, layer, tr in entries:
        if layer is None:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = get_leaf(name, tr)
        else:
            groups.setdefault(path, (tr, []))[1].append(name)
    for path, (tr, names) in groups.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = get_stack(names, tr)
    return tree


def load_entries(d: Path, entries: list, dtype: str,
                 device: str | torch.device = "cuda") -> dict:
    """The tensors of a directory's ``*.safetensors`` (shards included)
    named by ``entries`` (:func:`mmdit_entries`, :func:`t5_entries`) as
    a tree on ``device`` in ``dtype`` (vectors float32), each leaf cast on
    the device as it arrives and each stacked leaf filled in place."""
    t = _open_dir(d)
    dt = torch_dtype(dtype)
    device = resolve_device(device)
    return _assemble(
        entries,
        lambda name, tr: leaf(t, name, dt, device, transpose=tr),
        lambda names, tr: stacked(t, names, dt, device, transpose=tr))


def load_mmdit(d: Path, cfg, device: str | torch.device = "cuda") -> dict:
    """A diffusers ``transformer/`` directory → the MMDiT tree."""
    return load_entries(d, mmdit_entries(cfg), cfg.dtype, device)


def t5_entries(cfg) -> list[tuple[str, tuple, Optional[int], bool]]:
    """Every tensor of a ``T5EncoderModel`` state dict, as
    :func:`mmdit_entries` lists the MMDiT's."""
    out: list = [("shared.weight", ("embed",), None, False),
                 (_t5.T5_REL_EMBED, ("rel_embed",), None, False)]
    for i in range(cfg.num_layers):
        for key, (name, tr) in _t5.T5_LAYER_NAMES.items():
            out.append((f"encoder.block.{i}.layer.{name}", ("layers", key),
                        i, tr))
    out.append(("encoder.final_layer_norm.weight", ("final_ln",), None,
                False))
    return out


def entry_tensor(tree: dict, path: tuple, layer: Optional[int],
                 transposed: bool) -> torch.Tensor:
    """The tensor of one entry in the file's layout, from a tree."""
    t = tree
    for k in path:
        t = t[k]
    if layer is not None:
        t = t[layer]
    return t.t() if transposed else t


def entry_shape(shapes: dict, path: tuple, layer: Optional[int],
                transposed: bool) -> tuple:
    """The shape of one entry in the file's layout, from a tree's
    ``param_shapes``."""
    s = shapes
    for k in path:
        s = s[k]
    s = tuple(s[1:] if layer is not None else s)
    return s[::-1] if transposed else s


def write_entries(path: Path, entries: list, get, dtype: str,
                  shape) -> int:
    """One ``.safetensors`` of (name, path, layer, transposed) entries in
    ``dtype``: ``get(path, layer, transposed)`` gives each tensor in the
    file's layout as it is written, ``shape(...)`` its shape beforehand."""
    return write_safetensors(path, [
        (name, tuple(shape(p, layer, tr)), torch_dtype(dtype),
         (lambda p=p, layer=layer, tr=tr: get(p, layer, tr)))
        for name, p, layer, tr in entries])


def t5_hf_config(cfg) -> dict:
    return {"architectures": ["T5EncoderModel"], "model_type": "t5",
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "d_kv": cfg.d_kv, "d_ff": cfg.d_ff,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "relative_attention_num_buckets":
                cfg.relative_attention_num_buckets,
            "relative_attention_max_distance":
                cfg.relative_attention_max_distance,
            "layer_norm_epsilon": cfg.layer_norm_epsilon,
            "feed_forward_proj": "gated-gelu", "is_gated_act": True,
            "dense_act_fn": "gelu_new"}


def mmdit_hf_config(cfg) -> dict:
    return {"_class_name": "FluxTransformer2DModel", "patch_size": 1,
            "in_channels": cfg.in_channels, "num_layers": cfg.num_layers,
            "num_single_layers": cfg.num_single_layers,
            "attention_head_dim": cfg.attention_head_dim,
            "num_attention_heads": cfg.num_attention_heads,
            "joint_attention_dim": cfg.joint_attention_dim,
            "pooled_projection_dim": cfg.pooled_projection_dim,
            "guidance_embeds": cfg.guidance_embeds,
            "axes_dims_rope": list(cfg.axes_dims_rope)}


def write_sharded(d: Path, stem: str, entries: list, get, dtype: str,
                  shape, shards: int = 1) -> int:
    """``entries`` (:func:`write_entries`) split in file order into
    ``shards`` files of about equal bytes (``<stem>-0000k-of-0000n
    .safetensors`` and the ``<stem>.safetensors.index.json`` of the
    published layout; one ``<stem>.safetensors`` when ``shards`` is 1).
    Returns the bytes written."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    if shards <= 1:
        return write_entries(d / f"{stem}.safetensors", entries, get, dtype,
                             shape)
    sizes = [math.prod(shape(p, layer, tr)) for _, p, layer, tr in entries]
    total, acc, cut = sum(sizes), 0, [0]
    for i, n in enumerate(sizes):
        acc += n
        if acc >= total * len(cut) / shards and len(cut) < shards:
            cut.append(i + 1)
    cut.append(len(entries))
    nbytes, weight_map = 0, {}
    for k in range(shards):
        fname = f"{stem}-{k + 1:05d}-of-{shards:05d}.safetensors"
        part = entries[cut[k]:cut[k + 1]]
        nbytes += write_entries(d / fname, part, get, dtype, shape)
        weight_map.update({e[0]: fname for e in part})
    (d / f"{stem}.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    return nbytes


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def load_diffusers_pipeline(d: Path, *, lora_adapter: str = "",
                            lora_scale: float = 1.0,
                            device: str | torch.device = "cuda",
                            **defaults):
    """A directory with unet/ vae/ text_encoder/ tokenizer/ (and SDXL's
    text_encoder_2/ tokenizer_2/) → DiffusionPipeline on ``device``."""
    from localai_tpu_torch.image.pipeline import DiffusionPipeline

    d = Path(d)
    device = resolve_device(device)
    unet_cfg, unet_params = load_unet(d / "unet")
    vae_cfg, vae_params = load_vae(d / "vae")
    text_cfg, text_params = load_text_encoder(d / "text_encoder")
    extra = {}
    if (d / "text_encoder_2").is_dir():
        # the SDXL layout: a second (OpenCLIP-class) encoder + tokenizer_2
        text2_cfg, text2_params = load_text_encoder(d / "text_encoder_2")
        extra = {
            "text2_cfg": text2_cfg,
            "text2_params": _to_device(text2_params, text2_cfg.dtype, device),
            "tokenizer2": _load_clip_tokenizer(d / "tokenizer_2"),
        }
    if lora_adapter:
        # merged on the host before the weights go to the device, as the
        # JAX package merges (image/lora.py)
        from localai_tpu_torch.image.lora import apply_lora

        apply_lora(unet_params, text_params, lora_adapter, scale=lora_scale)
    tokenizer = _load_clip_tokenizer(d / "tokenizer")
    log.info("loaded diffusers pipeline from %s (unet %dch, ctx %d) on %s",
             d, unet_cfg.model_channels, unet_cfg.context_dim, device)
    return DiffusionPipeline(
        unet_cfg, _to_device(unet_params, unet_cfg.dtype, device),
        vae_cfg, _to_device(vae_params, vae_cfg.dtype, device),
        text_cfg, _to_device(text_params, text_cfg.dtype, device),
        tokenizer, ref=str(d), device=device, **extra, **defaults)


def map_tree(tree: PyTree, fn: Callable) -> PyTree:
    """``fn`` at every leaf of a parameter tree (dicts and lists walked,
    None kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def _to_device(params: PyTree, dtype: str,
               device: str | torch.device) -> PyTree:
    """Every leaf in the JAX package's cast (:func:`cast_leaf`)."""
    dt = torch_dtype(dtype)
    return map_tree(params, lambda a: cast_leaf(a, dt, device))


def from_jax_params(tree: PyTree, device: str | torch.device = "cuda"
                    ) -> PyTree:
    """A JAX package image tree (UNet, VAE, CLIP, ControlNet, and FLUX's
    MMDiT and T5, whose stacked [L, ...] leaves carry across as they are;
    numpy or JAX arrays, bfloat16 as ``ml_dtypes.bfloat16``) as tensors on
    ``device``, each in its own dtype, conv kernels HWIO → OIHW."""
    return map_tree(params_from_numpy(tree, device), lambda t: t.permute(
        3, 2, 0, 1).contiguous() if t.dim() == 4 else t)


# ---------------------------------------------------------------------------
# writing the layout
# ---------------------------------------------------------------------------

def _put_conv(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = p["w"]
    out[f"{name}.bias"] = p["b"]


def _put_lin(out: dict, name: str, w, b=None) -> None:
    out[f"{name}.weight"] = w.t()
    if b is not None:
        out[f"{name}.bias"] = b


def _put_norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = p["g"]
    out[f"{name}.bias"] = p["b"]


def _put_res(out: dict, name: str, p: dict) -> None:
    _put_norm(out, f"{name}.norm1", p["norm1"])
    _put_conv(out, f"{name}.conv1", p["conv1"])
    _put_norm(out, f"{name}.norm2", p["norm2"])
    _put_conv(out, f"{name}.conv2", p["conv2"])
    if "temb" in p:
        _put_lin(out, f"{name}.time_emb_proj", p["temb"]["w"],
                 p["temb"]["b"])
    if "skip" in p:
        _put_conv(out, f"{name}.conv_shortcut", p["skip"])


def _put_st(out: dict, name: str, p: dict, linear_proj: bool) -> None:
    _put_norm(out, f"{name}.norm", p["norm"])
    for key in ("proj_in", "proj_out"):
        w = p[key]["w"]
        out[f"{name}.{key}.weight"] = w[:, :, 0, 0] if linear_proj else w
        out[f"{name}.{key}.bias"] = p[key]["b"]
    for i, bp in enumerate(p["blocks"]):
        tb = f"{name}.transformer_blocks.{i}"
        for j in (1, 2, 3):
            _put_norm(out, f"{tb}.norm{j}", bp[f"ln{j}"])
        for a in ("attn1", "attn2"):
            ap = bp[a]
            for k in ("q", "k", "v"):
                _put_lin(out, f"{tb}.{a}.to_{k}", ap[f"w{k}"])
            _put_lin(out, f"{tb}.{a}.to_out.0", ap["wo"], ap["bo"])
        _put_lin(out, f"{tb}.ff.net.0.proj", bp["ff"]["w1"], bp["ff"]["b1"])
        _put_lin(out, f"{tb}.ff.net.2", bp["ff"]["w2"], bp["ff"]["b2"])


def _put_mlp(out: dict, name: str, p: dict) -> None:
    _put_lin(out, f"{name}.linear_1", p["w1"], p["b1"])
    _put_lin(out, f"{name}.linear_2", p["w2"], p["b2"])


def _put_encoder_half(out: dict, params: PyTree, linear_proj: bool) -> None:
    """conv_in, the time MLPs, the down blocks and the mid block: what a
    UNet and a ControlNet share."""
    _put_conv(out, "conv_in", params["conv_in"])
    _put_mlp(out, "time_embedding", params["time_emb"])
    if "add_emb" in params:
        _put_mlp(out, "add_embedding", params["add_emb"])
    for lvl, lp in enumerate(params["down"]):
        base = f"down_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _put_res(out, f"{base}.resnets.{j}", rp)
        for j, sp in enumerate(lp["attn"] or []):
            _put_st(out, f"{base}.attentions.{j}", sp, linear_proj)
        if lp.get("down"):
            _put_conv(out, f"{base}.downsamplers.0.conv", lp["down"])
    _put_res(out, "mid_block.resnets.0", params["mid"]["res1"])
    _put_st(out, "mid_block.attentions.0", params["mid"]["attn"],
            linear_proj)
    _put_res(out, "mid_block.resnets.1", params["mid"]["res2"])


def unet_tensors(params: PyTree, linear_proj: bool = False) -> dict:
    """The UNet tree by its diffusers names (tensors as the tree holds
    them, transposed where the layout asks)."""
    out: dict = {}
    _put_encoder_half(out, params, linear_proj)
    for lvl, lp in enumerate(params["up"]):
        base = f"up_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _put_res(out, f"{base}.resnets.{j}", rp)
        for j, sp in enumerate(lp["attn"] or []):
            _put_st(out, f"{base}.attentions.{j}", sp, linear_proj)
        if lp.get("up"):
            _put_conv(out, f"{base}.upsamplers.0.conv", lp["up"])
    _put_norm(out, "conv_norm_out", params["norm_out"])
    _put_conv(out, "conv_out", params["conv_out"])
    return out


def controlnet_tensors(params: PyTree, linear_proj: bool = False) -> dict:
    out: dict = {}
    _put_encoder_half(out, params, linear_proj)
    ce = "controlnet_cond_embedding"
    _put_conv(out, f"{ce}.conv_in", params["cond_emb"]["conv_in"])
    for i, blk in enumerate(params["cond_emb"]["blocks"]):
        _put_conv(out, f"{ce}.blocks.{2 * i}", blk["a"])
        _put_conv(out, f"{ce}.blocks.{2 * i + 1}", blk["b"])
    _put_conv(out, f"{ce}.conv_out", params["cond_emb"]["conv_out"])
    for j, zp in enumerate(params["zero_convs"]):
        _put_conv(out, f"controlnet_down_blocks.{j}", zp)
    _put_conv(out, "controlnet_mid_block", params["mid_zero"])
    return out


def vae_tensors(params: PyTree) -> dict:
    out: dict = {}

    def mid(name, p):
        _put_res(out, f"{name}.resnets.0", p["res1"])
        _put_res(out, f"{name}.resnets.1", p["res2"])
        a = f"{name}.attentions.0"
        _put_norm(out, f"{a}.group_norm", p["attn"]["norm"])
        for k, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                          ("o", "to_out.0")):
            _put_lin(out, f"{a}.{theirs}", p["attn"][f"w{k}"],
                     p["attn"][f"b{k}"])

    enc, dec = params["encoder"], params["decoder"]
    _put_conv(out, "encoder.conv_in", enc["conv_in"])
    for lvl, lp in enumerate(enc["down"]):
        base = f"encoder.down_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _put_res(out, f"{base}.resnets.{j}", rp)
        if "down" in lp:
            _put_conv(out, f"{base}.downsamplers.0.conv", lp["down"])
    mid("encoder.mid_block", enc["mid"])
    _put_norm(out, "encoder.conv_norm_out", enc["norm_out"])
    _put_conv(out, "encoder.conv_out", enc["conv_out"])
    _put_conv(out, "quant_conv", params["quant_conv"])
    _put_conv(out, "post_quant_conv", params["post_quant_conv"])
    _put_conv(out, "decoder.conv_in", dec["conv_in"])
    mid("decoder.mid_block", dec["mid"])
    for lvl, lp in enumerate(dec["up"]):
        base = f"decoder.up_blocks.{lvl}"
        for j, rp in enumerate(lp["res"]):
            _put_res(out, f"{base}.resnets.{j}", rp)
        if "up" in lp:
            _put_conv(out, f"{base}.upsamplers.0.conv", lp["up"])
    _put_norm(out, "decoder.conv_norm_out", dec["norm_out"])
    _put_conv(out, "decoder.conv_out", dec["conv_out"])
    return out


def clip_tensors(params: PyTree) -> dict:
    pre = "text_model."
    out: dict = {
        f"{pre}embeddings.token_embedding.weight": params["token_emb"],
        f"{pre}embeddings.position_embedding.weight": params["pos_emb"]}
    for i, lp in enumerate(params["layers"]):
        base = f"{pre}encoder.layers.{i}"
        _put_norm(out, f"{base}.layer_norm1", lp["ln1"])
        _put_norm(out, f"{base}.layer_norm2", lp["ln2"])
        for ours, theirs in _CLIP_ATTN:
            _put_lin(out, f"{base}.self_attn.{theirs}",
                     lp["attn"][f"w{ours}"], lp["attn"][f"b{ours}"])
        _put_lin(out, f"{base}.mlp.fc1", lp["mlp"]["w1"], lp["mlp"]["b1"])
        _put_lin(out, f"{base}.mlp.fc2", lp["mlp"]["w2"], lp["mlp"]["b2"])
    _put_norm(out, f"{pre}final_layer_norm", params["ln_f"])
    if "text_projection" in params:
        out["text_projection.weight"] = params["text_projection"].t()
    return out


def unet_hf_config(cfg: UNetConfig, linear_proj: bool = False) -> dict:
    """A diffusers ``unet/config.json`` that ``UNetConfig.from_hf`` reads
    back as ``cfg``."""
    n = len(cfg.channel_mult)
    heads = list(cfg.heads_per_level) or cfg.num_heads
    depth = list(cfg.depth_per_level) or cfg.transformer_depth
    hf = {
        "_class_name": "UNet2DConditionModel",
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "block_out_channels": [cfg.model_channels * m
                               for m in cfg.channel_mult],
        "down_block_types": ["CrossAttnDownBlock2D" if i in cfg.attn_levels
                             else "DownBlock2D" for i in range(n)],
        "up_block_types": ["CrossAttnUpBlock2D" if i in cfg.attn_levels
                           else "UpBlock2D" for i in reversed(range(n))],
        "layers_per_block": cfg.num_res_blocks,
        "attention_head_dim": heads,
        "cross_attention_dim": cfg.context_dim,
        "transformer_layers_per_block": depth,
        "use_linear_projection": linear_proj,
    }
    if cfg.addition_embed:
        hf.update(addition_embed_type="text_time",
                  addition_time_embed_dim=cfg.addition_time_embed_dim,
                  projection_class_embeddings_input_dim=cfg.addition_in_dim)
    return hf


def vae_hf_config(cfg: VAEConfig) -> dict:
    n = len(cfg.channel_mult)
    return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
            "out_channels": cfg.in_channels,
            "latent_channels": cfg.latent_channels,
            "block_out_channels": [cfg.base_channels * m
                                   for m in cfg.channel_mult],
            "down_block_types": ["DownEncoderBlock2D"] * n,
            "up_block_types": ["UpDecoderBlock2D"] * n,
            "layers_per_block": cfg.num_res_blocks,
            "scaling_factor": cfg.scaling_factor}


def clip_hf_config(cfg: CLIPTextConfig) -> dict:
    return {"architectures": ["CLIPTextModelWithProjection"
                              if cfg.projection_dim else "CLIPTextModel"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_length,
            "eos_token_id": cfg.eos_token_id, "hidden_act": cfg.activation,
            "projection_dim": cfg.projection_dim or cfg.hidden_size}


def write_component(d: Path, hf_config: dict, tensors: dict,
                    dtype: Optional[str] = None) -> int:
    """``config.json`` + ``diffusion_pytorch_model.safetensors`` (each
    tensor in ``dtype``, or its own), one tensor at a time. Returns the
    bytes written."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf_config))
    dt = torch_dtype(dtype) if dtype else None
    return write_safetensors(d / "diffusion_pytorch_model.safetensors", [
        (name, tuple(t.shape), dt or t.dtype, (lambda t=t: t))
        for name, t in tensors.items()])


def write_controlnet(d: Path, cfg: UNetConfig, params: PyTree,
                     dtype: Optional[str] = None,
                     linear_proj: bool = False) -> int:
    """A diffusers ControlNetModel directory from a ControlNet tree."""
    ce = params["cond_emb"]
    hf = {**unet_hf_config(cfg, linear_proj),
          "_class_name": "ControlNetModel",
          "conditioning_embedding_out_channels":
              [int(ce["conv_in"]["w"].shape[0])]
              + [int(b["b"]["w"].shape[0]) for b in ce["blocks"]]}
    hf.pop("up_block_types")
    return write_component(d, hf, controlnet_tensors(params, linear_proj),
                           dtype)


def write_diffusers_pipeline(root: Path, vae: tuple, text: tuple,
                             unet: Optional[tuple] = None,
                             text2: Optional[tuple] = None,
                             dtype: Optional[str] = None,
                             transformer: Optional[tuple] = None,
                             t5: Optional[tuple] = None,
                             t5_shards: int = 1,
                             configs: Optional[dict] = None) -> int:
    """A diffusers directory from (config, params) pairs: unet/, vae/,
    text_encoder/ (and text_encoder_2/ for SDXL, whose UNet's
    proj_in/proj_out are written as linears) and model_index.json; or,
    with ``transformer`` and ``t5``, FLUX's transformer/ (an MMDiT) and
    text_encoder_2/ (T5EncoderModel names, in ``t5_shards`` files), whose
    params may be a tree or a getter ``get(path, layer, transposed)`` that
    makes each tensor as it is written (:func:`write_entries`).
    ``configs`` ({subdirectory: config.json}) replaces the config.json
    written from a config. The tokenizer and scheduler directories are
    the caller's. Returns the bytes written."""
    root = Path(root)
    configs = configs or {}
    sdxl = text2 is not None
    n = 0
    if unet is not None:
        n += write_component(
            root / "unet",
            configs.get("unet") or unet_hf_config(unet[0], sdxl),
            unet_tensors(unet[1], sdxl), dtype)
    n += write_component(root / "vae",
                         configs.get("vae") or vae_hf_config(vae[0]),
                         vae_tensors(vae[1]), dtype)
    for sub, pair in (("text_encoder", text), ("text_encoder_2", text2)):
        if pair is not None:
            n += write_component(
                root / sub, configs.get(sub) or clip_hf_config(pair[0]),
                clip_tensors(pair[1]), dtype)
    cls = ("StableDiffusionXLPipeline" if sdxl
           else "StableDiffusionPipeline")
    for sub, stem, pair, mod, entries, hf, shards in (
            ("transformer", "diffusion_pytorch_model", transformer, _mmdit,
             mmdit_entries, mmdit_hf_config, 1),
            ("text_encoder_2", "model", t5, _t5, t5_entries, t5_hf_config,
             t5_shards)):
        if pair is None:
            continue
        cfg, src = pair
        get = src if callable(src) else functools.partial(entry_tensor, src)
        n += write_sharded(root / sub, stem, entries(cfg), get,
                           dtype or cfg.dtype,
                           functools.partial(entry_shape,
                                             mod.param_shapes(cfg)), shards)
        (root / sub / "config.json").write_text(
            json.dumps(configs.get(sub) or hf(cfg)))
    if transformer is not None:
        cls = "FluxPipeline"
    (root / "model_index.json").write_text(json.dumps({"_class_name": cls}))
    return n


# ---------------------------------------------------------------------------
# the CLIP tokenizer
# ---------------------------------------------------------------------------

class ClipTokenizer:
    """A CLIP tokenizer in the repo's Tokenizer protocol: ``encode`` gives
    ``CLIPTokenizerFast(text).input_ids`` (the start and end tokens
    around the text), as the JAX package's wrapper."""

    def __init__(self, spec: dict, vocab_size: int, eos_id: int):
        from localai_tpu_torch.utils.hf_tokenizer import TokenizerJSON

        self._tok = TokenizerJSON(spec)
        self.vocab_size = vocab_size
        self.eos_ids = {eos_id}

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids) -> str:
        return self._tok.decode(ids)


def _special(cfg: dict, key: str, default: str) -> str:
    v = cfg.get(key, default)
    if isinstance(v, dict):
        v = v.get("content", default)
    return v if isinstance(v, str) else default


def _load_clip_tokenizer(d: Path):
    """``tokenizer.json``, else ``vocab.json`` + ``merges.txt`` (with the
    special tokens of ``tokenizer_config.json`` / ``special_tokens_map
    .json``, CLIPTokenizerFast's defaults otherwise); a directory with
    neither gives the byte tokenizer with a warning."""
    from localai_tpu_torch.utils import hf_tokenizer as hft

    d = Path(d)
    cfg: dict = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        if (d / name).exists():
            cfg.update(json.loads((d / name).read_text(encoding="utf-8")))
    bos = _special(cfg, "bos_token", "<|startoftext|>")
    eos = _special(cfg, "eos_token", "<|endoftext|>")
    unk = _special(cfg, "unk_token", "<|endoftext|>")
    pad = _special(cfg, "pad_token", "<|endoftext|>")
    if (d / "tokenizer.json").exists():
        spec = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
        vocab = spec["model"]["vocab"]
    elif (d / "vocab.json").exists() and (d / "merges.txt").exists():
        vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        merges = hft.read_clip_merges(
            (d / "merges.txt").read_text(encoding="utf-8"))
        spec = hft.clip_tokenizer_spec(vocab, merges, bos=bos, eos=eos,
                                       unk=unk, specials=(pad,))
    else:
        log.warning("no CLIP tokenizer in %s (tokenizer.json or vocab.json "
                    "+ merges.txt); using the byte tokenizer", d)
        from localai_tpu_torch.utils.tokenizer import ByteTokenizer

        return ByteTokenizer()
    return ClipTokenizer(spec, len(vocab), vocab.get(eos, -1))
