"""CLIP-class text encoder: the conditioning tower of latent diffusion.

Port of ``localai_tpu/image/clip.py``: a pre-LN transformer with a causal
mask, learned position embeddings, quick-GELU (CLIP ViT-L/14) or tanh
GELU (``gelu``: ``jax.nn.gelu``'s default, which SDXL's second encoder
names), and a final layer norm. ``clip_skip`` takes the hidden states N
layers before the end; ``encode_sdxl`` gives SDXL's penultimate states
and the projected pooled output at the end token. Plain torch ops, in the
config's dtype with layer norms and softmax in float32, as the JAX code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from localai_tpu_torch.image.unet import (
    _linear,
    draw_params,
    layer_norm,
    torch_dtype,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    eos_token_id: int = 49407
    activation: str = "quick_gelu"
    dtype: str = "bfloat16"
    # text_projection's width (SDXL's second encoder; 0 = none): sizes
    # drawn weights only, as the loader reads the projection it finds
    projection_dim: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "CLIPTextConfig":
        return cls(
            vocab_size=hf.get("vocab_size", 49408),
            hidden_size=hf.get("hidden_size", 768),
            intermediate_size=hf.get("intermediate_size", 3072),
            num_layers=hf.get("num_hidden_layers", 12),
            num_heads=hf.get("num_attention_heads", 12),
            max_length=hf.get("max_position_embeddings", 77),
            eos_token_id=hf.get("eos_token_id", 49407),
            activation=hf.get("hidden_act", "quick_gelu"),
            projection_dim=int(hf.get("projection_dim") or 0)
            if hf.get("architectures") == ["CLIPTextModelWithProjection"]
            else 0,
        )


def _act(cfg: CLIPTextConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")


def _mha(x: torch.Tensor, p: dict, num_heads: int,
         mask: torch.Tensor) -> torch.Tensor:
    B, T, C = x.shape
    hd = C // num_heads

    def proj(w, b):
        return _linear(x, p[w], p[b]).reshape(B, T, num_heads,
                                              hd).transpose(1, 2)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores.float() + mask
    probs = torch.softmax(scores, -1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, C)
    return _linear(out, p["wo"], p["bo"])


def _run_layers(cfg: CLIPTextConfig, params: PyTree, tokens: torch.Tensor,
                stop_after: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder loop shared by ``forward`` and ``encode_sdxl``: (hidden
    after ``stop_after`` layers, hidden after the second-to-last executed
    layer)."""
    dtype = torch_dtype(cfg.dtype)
    T = tokens.shape[1]
    x = params["token_emb"][tokens].to(dtype)
    x = x + params["pos_emb"][:T].to(dtype)
    causal = torch.triu(torch.full((T, T), -1e9, dtype=torch.float32,
                                   device=x.device), 1)[None, None]
    penultimate = x
    for li, lp in enumerate(params["layers"]):
        if li >= stop_after:
            break
        x = x + _mha(layer_norm(x, lp["ln1"]), lp["attn"], cfg.num_heads,
                     causal)
        h = layer_norm(x, lp["ln2"])
        h = _act(cfg, _linear(h, lp["mlp"]["w1"], lp["mlp"]["b1"]))
        x = x + _linear(h, lp["mlp"]["w2"], lp["mlp"]["b2"])
        if li == stop_after - 2:
            penultimate = x
    return x, penultimate


def forward(cfg: CLIPTextConfig, params: PyTree, tokens: torch.Tensor,
            clip_skip: int = 0) -> torch.Tensor:
    """tokens [B, T] → hidden states [B, T, C] (the UNet's cross-attention
    context). clip_skip=N>0 stops N-1 layers early (diffusers convention:
    skip 1 is the final layer)."""
    stop = len(params["layers"]) - max(0, clip_skip - 1)
    x, _ = _run_layers(cfg, params, tokens, stop)
    return layer_norm(x, params["ln_f"])


def encode_sdxl(cfg: CLIPTextConfig, params: PyTree, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SDXL conditioning: (penultimate hidden states [B, T, C], without
    the final layer norm; the pooled embedding [B, proj | C] of the final
    layer at the end token, the highest id, through ``text_projection``
    when the encoder has one)."""
    x, penultimate = _run_layers(cfg, params, tokens, len(params["layers"]))
    final = layer_norm(x, params["ln_f"])
    eot = torch.argmax(tokens, dim=-1)
    pooled = final[torch.arange(final.shape[0], device=final.device), eot]
    if "text_projection" in params:
        pooled = pooled @ params["text_projection"].to(pooled.dtype)
    return penultimate, pooled


def param_shapes(cfg: CLIPTextConfig) -> PyTree:
    C, I = cfg.hidden_size, cfg.intermediate_size
    layer = {
        "ln1": {"g": (C,), "b": (C,)},
        "attn": {"wq": (C, C), "bq": (C,), "wk": (C, C), "bk": (C,),
                 "wv": (C, C), "bv": (C,), "wo": (C, C), "bo": (C,)},
        "ln2": {"g": (C,), "b": (C,)},
        "mlp": {"w1": (C, I), "b1": (I,), "w2": (I, C), "b2": (C,)},
    }
    shapes = {
        "token_emb": (cfg.vocab_size, C),
        "pos_emb": (cfg.max_length, C),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "ln_f": {"g": (C,), "b": (C,)},
    }
    if cfg.projection_dim:
        shapes["text_projection"] = (C, cfg.projection_dim)
    return shapes


def init_params(cfg: CLIPTextConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> PyTree:
    """Random weights in the JAX package's scheme (matrices N(0, 0.02),
    gains 1, biases 0) from a ``torch.Generator``."""
    return draw_params(param_shapes(cfg), cfg.dtype, seed, device,
                       scale=lambda shape: 0.02)
