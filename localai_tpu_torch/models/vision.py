"""Vision tower: CLIP ViT encoder + LLaVA-style multimodal projector.

Port of ``localai_tpu/models/vision.py`` to PyTorch:

  * patch embedding is a reshape + one matmul (the stride-P conv of CLIP
    collapses to patchify → GEMM);
  * pre-LN transformer blocks, with the port's own copies of the JAX
    package's ``image/clip.py`` ``_act`` / ``_mha`` and ``image/unet.py``
    ``layer_norm`` (the port imports nothing of ``localai_tpu``): plain
    torch matmuls, a float32 softmax, quick-GELU or tanh-GELU as
    ``jax.nn.gelu`` computes it by default;
  * LLaVA semantics: features from hidden layer ``feature_layer`` (default
    -2, the penultimate block's output, before any post-LN), CLS dropped,
    then a 2-layer GELU projector into the language model's hidden size.

Images are resized on the host by ``utils/resample.py`` (PIL's bicubic,
bit for bit), where the JAX package calls PIL. The tower runs on the
engine's device in the engine's dtype; ``VisionTower.encode`` takes and
returns numpy arrays, so the HTTP thread that encodes and the engine
thread that prefills share no tensor.

Ingests HF llava checkpoints (``vision_tower.vision_model.*`` +
``multi_modal_projector.*``, or the transformers ≥ 4.52 ``model.``
nesting) or a random-weight debug preset.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.models.llama import torch_dtype
from localai_tpu_torch.utils.device import resolve_device
from localai_tpu_torch.utils.resample import resize

log = logging.getLogger(__name__)

Params = dict[str, Any]

# CLIP preprocessing constants (openai/clip-vit-large-patch14)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 4096      # language-model hidden size
    feature_layer: int = -2         # LLaVA vision_feature_layer
    activation: str = "quick_gelu"
    dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf(cls, vision_cfg: dict, *, projection_dim: int,
                feature_layer: int = -2) -> "VisionConfig":
        return cls(
            image_size=vision_cfg.get("image_size", 336),
            patch_size=vision_cfg.get("patch_size", 14),
            hidden_size=vision_cfg.get("hidden_size", 1024),
            intermediate_size=vision_cfg.get("intermediate_size", 4096),
            num_layers=vision_cfg.get("num_hidden_layers", 24),
            num_heads=vision_cfg.get("num_attention_heads", 16),
            projection_dim=projection_dim,
            feature_layer=feature_layer,
            activation=vision_cfg.get("hidden_act", "quick_gelu"),
        )


DEBUG_PRESETS: dict[str, VisionConfig] = {
    # tiny ViT for tests: 32px/8px → 16 patch tokens
    "vit": VisionConfig(
        image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, projection_dim=64, feature_layer=-1,
    ),
}

_ZERO_INIT = ("bq", "bk", "bv", "bo", "b1", "b2", "b", "cls")


def param_shapes(cfg: VisionConfig) -> Params:
    C, I, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    D = cfg.projection_dim
    layer = {
        "ln1": {"g": (C,), "b": (C,)},
        "attn": {"wq": (C, C), "bq": (C,), "wk": (C, C), "bk": (C,),
                 "wv": (C, C), "bv": (C,), "wo": (C, C), "bo": (C,)},
        "ln2": {"g": (C,), "b": (C,)},
        "mlp": {"w1": (C, I), "b1": (I,), "w2": (I, C), "b2": (C,)},
    }
    return {
        "patch_embed": (3 * P * P, C),   # flattened conv kernel (c, i, j)
        "cls": (C,),
        "pos_emb": (cfg.n_patches + 1, C),
        "pre_ln": {"g": (C,), "b": (C,)},
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "projector": {"w1": (C, D), "b1": (D,), "w2": (D, D), "b2": (D,)},
    }


def init_params(cfg: VisionConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Params:
    """Random weights as the JAX package lays them out: matrices
    N(0, 0.02) in ``cfg.dtype``, vectors in float32 (gains 1; biases and
    the CLS embedding 0). Drawn on ``generator``'s device one matrix at a
    time."""
    device = torch.device(device if device is not None else generator.device)
    dtype = torch_dtype(cfg.dtype)

    def mk(name: str, shape: tuple):
        if len(shape) == 1:
            fill = 0.0 if name in _ZERO_INIT else 1.0
            return torch.full(shape, fill, dtype=torch.float32, device=device)
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    def walk(tree, name=""):
        if isinstance(tree, tuple):
            return mk(name, tree)
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        return {k: walk(v, k) for k, v in tree.items()}

    return walk(param_shapes(cfg))


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm computed in float32 (``image/unet.py::layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * p["g"].float() \
        + p["b"].float()
    return out.to(x.dtype)


def _act(cfg: VisionConfig, x: torch.Tensor) -> torch.Tensor:
    """``image/clip.py::_act``: quick-GELU, else ``jax.nn.gelu`` (the
    tanh approximation)."""
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")


def _mha(x: torch.Tensor, p: Params, num_heads: int) -> torch.Tensor:
    """``image/clip.py::_mha`` without a mask (the tower attends over all
    of an image's tokens): scores in the compute dtype, softmax in f32."""
    B, T, C = x.shape
    hd = C // num_heads

    def proj(w, b):
        return (x @ p[w].to(x.dtype) + p[b].to(x.dtype)).reshape(
            B, T, num_heads, hd)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(B, T, C)
    return out @ p["wo"].to(x.dtype) + p["bo"].to(x.dtype)


def patchify(cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] → patch vectors [B, N, 3·P·P] in conv-kernel
    order (channel, row, col), so the flattened HF conv weight applies."""
    B, H, W, _ = images.shape
    P = cfg.patch_size
    x = images.reshape(B, H // P, P, W // P, P, 3)
    x = x.permute(0, 1, 3, 5, 2, 4)     # [B, gh, gw, c, pi, pj]
    return x.reshape(B, cfg.n_patches, 3 * P * P)


def forward(cfg: VisionConfig, params: Params,
            images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] f32 (CLIP-normalised) → [B, n_patches, D].

    LLaVA semantics: stop at ``feature_layer``, drop CLS, project."""
    dtype = torch_dtype(cfg.dtype)
    B = images.shape[0]
    x = patchify(cfg, images).to(dtype) @ params["patch_embed"].to(dtype)
    cls = params["cls"].to(dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(dtype)
    x = layer_norm(x, params["pre_ln"])
    n_run = (cfg.num_layers + 1 + cfg.feature_layer
             if cfg.feature_layer < 0 else cfg.feature_layer)
    for lp in params["layers"][:n_run]:
        x = x + _mha(layer_norm(x, lp["ln1"]), lp["attn"], cfg.num_heads)
        h = layer_norm(x, lp["ln2"])
        h = _act(cfg, h @ lp["mlp"]["w1"].to(h.dtype)
                 + lp["mlp"]["b1"].to(h.dtype))
        x = x + (h @ lp["mlp"]["w2"].to(h.dtype)
                 + lp["mlp"]["b2"].to(h.dtype))
    x = x[:, 1:]   # drop CLS: vision_feature_select_strategy="default"
    pj = params["projector"]
    h = F.gelu(x @ pj["w1"].to(x.dtype) + pj["b1"].to(x.dtype),
               approximate="tanh")
    return h @ pj["w2"].to(h.dtype) + pj["b2"].to(h.dtype)


def preprocess(images: list[np.ndarray], cfg: VisionConfig) -> np.ndarray:
    """uint8 RGB arrays (any size) → [B, S, S, 3] f32 CLIP-normalised."""
    S = cfg.image_size
    out = np.zeros((len(images), S, S, 3), np.float32)
    for i, img in enumerate(images):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[2] == 4:
            arr = arr[..., :3]
        if arr.shape[:2] != (S, S):
            arr = resize(arr.astype(np.uint8), (S, S))
        out[i] = (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    return out


class VisionTower:
    """A loaded vision encoder bound to one language model: encodes
    images into [n_patches, D_model] embedding blocks for the prompt."""

    def __init__(self, cfg: VisionConfig, params: Params,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.device = (resolve_device(device) if device is not None
                       else params["patch_embed"].device)

    @property
    def n_patches(self) -> int:
        return self.cfg.n_patches

    def encode(self, images: list[np.ndarray]) -> np.ndarray:
        """List of RGB uint8 arrays → [B, n_patches, D_model] float32 (a
        host array: the caller's thread owns no device tensor after)."""
        batch = torch.from_numpy(preprocess(images, self.cfg))
        with torch.no_grad():
            out = forward(self.cfg, self.params, batch.to(self.device))
            return out.float().cpu().numpy()


def resolve_vision_tower(ref: str | Path, *, projection_dim: int,
                         model_path: str | Path = "models", seed: int = 0,
                         dtype: str = "bfloat16",
                         device: str | torch.device | None = "cuda"
                         ) -> VisionTower:
    """'debug:<preset>' → random weights drawn from ``seed``; a directory
    with an HF llava layout → its weights. In ``dtype`` on ``device``."""
    ref = str(ref)
    dev = resolve_device(device)
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        if name not in DEBUG_PRESETS:
            raise ValueError(
                f"unknown debug vision preset {name!r}; have "
                f"{sorted(DEBUG_PRESETS)}")
        cfg = dataclasses.replace(DEBUG_PRESETS[name],
                                  projection_dim=projection_dim, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return VisionTower(cfg, init_params(cfg, gen, dev), dev)
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            return load_llava_vision(cand, projection_dim=projection_dim,
                                     dtype=dtype, device=dev)
    raise FileNotFoundError(f"vision tower ref {ref!r} not found")


def load_llava_vision(model_dir: str | Path, *, projection_dim: int,
                      dtype: str = "bfloat16",
                      device: str | torch.device | None = "cuda"
                      ) -> VisionTower:
    """The vision half of an HF llava checkpoint directory, with the JAX
    package's dtypes per tensor (``dtype`` for all but the CLS embedding
    and the pre-LN, which stay float32)."""
    from localai_tpu_torch.models.loader import _open_safetensors, read_tensor

    model_dir = Path(model_dir)
    dev = resolve_device(device)
    hf = json.loads((model_dir / "config.json").read_text())
    cfg = VisionConfig.from_hf(
        hf.get("vision_config") or hf, projection_dim=projection_dim,
        feature_layer=hf.get("vision_feature_layer", -2))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    tensors = _open_safetensors(model_dir)
    V = "vision_tower.vision_model."
    if V + "embeddings.patch_embedding.weight" not in tensors:
        V = "model." + V  # transformers ≥ 4.52 nests under model.
    P = "multi_modal_projector."
    if (P + "linear_1.weight" not in tensors
            and "model." + P + "linear_1.weight" in tensors):
        P = "model." + P
    dt = torch_dtype(dtype)

    def g(name: str, transpose: bool = False,
          to: Optional[torch.dtype] = None) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(f"{model_dir}: tensor {name} missing")
        t = read_tensor(tensors[name]).float()
        t = t.T.contiguous() if transpose else t
        return t.to(device=dev, dtype=to or dt)

    conv = read_tensor(tensors[V + "embeddings.patch_embedding.weight"])
    C = conv.shape[0]
    layers = []
    for i in range(cfg.num_layers):
        L = f"{V}encoder.layers.{i}."
        layers.append({
            "ln1": {"g": g(L + "layer_norm1.weight"),
                    "b": g(L + "layer_norm1.bias")},
            "attn": {
                "wq": g(L + "self_attn.q_proj.weight", True),
                "bq": g(L + "self_attn.q_proj.bias"),
                "wk": g(L + "self_attn.k_proj.weight", True),
                "bk": g(L + "self_attn.k_proj.bias"),
                "wv": g(L + "self_attn.v_proj.weight", True),
                "bv": g(L + "self_attn.v_proj.bias"),
                "wo": g(L + "self_attn.out_proj.weight", True),
                "bo": g(L + "self_attn.out_proj.bias"),
            },
            "ln2": {"g": g(L + "layer_norm2.weight"),
                    "b": g(L + "layer_norm2.bias")},
            "mlp": {"w1": g(L + "mlp.fc1.weight", True),
                    "b1": g(L + "mlp.fc1.bias"),
                    "w2": g(L + "mlp.fc2.weight", True),
                    "b2": g(L + "mlp.fc2.bias")},
        })
    params = {
        "patch_embed": conv.float().reshape(C, -1).T.contiguous().to(
            device=dev, dtype=dt),
        "cls": g(V + "embeddings.class_embedding", to=torch.float32),
        "pos_emb": g(V + "embeddings.position_embedding.weight"),
        "pre_ln": {"g": g(V + "pre_layrnorm.weight", to=torch.float32),
                   "b": g(V + "pre_layrnorm.bias", to=torch.float32)},
        "layers": layers,
        "projector": {
            "w1": g(P + "linear_1.weight", True),
            "b1": g(P + "linear_1.bias"),
            "w2": g(P + "linear_2.weight", True),
            "b2": g(P + "linear_2.bias"),
        },
    }
    return VisionTower(cfg, params, dev)
