"""Whisper-family speech-to-text in PyTorch.

Port of ``localai_tpu/models/whisper.py``: the same encoder-decoder
transformer over the port's log-mel frontend (``audio.mel``), with the
same parameter tree (stacked per-layer tensors, right-multiply weights)
and the same numerics — tanh GELU (``jax.nn.gelu``'s default), population
variance in the layer norms, additive masks of -1e30, float32 softmax.
Whisper runs in float32, as the JAX loader widens every tensor; on the
card with TF32 off (``utils.device.full_f32``).

The JAX package decodes a chunk as one ``lax.while_loop`` program; the
port runs the same KV-cached greedy decode as a host loop over a
preallocated self-attention cache (``[L, H, Tmax, hd]``: the JAX
package's ``[L, Tmax, D]`` split by head), the cross-attention K/V
projected once per chunk. A step attends to the cache rows written
so far (the JAX package masks the rest with -1e30, which weighs them
exactly 0), and the vocabulary projection runs only where its argmax is
read (the prompt's steps feed the cache alone). No hand-written kernel
is on this path: the JAX package computes it in XLA.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.audio import mel as melmod
from localai_tpu_torch.utils.device import (
    full_f32,
    params_from_numpy,
    resolve_device,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384            # whisper-tiny
    n_heads: int = 6
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    d_ff: int = 1536
    vocab_size: int = 51865
    max_source_positions: int = 1500   # CHUNK_FRAMES // 2
    max_target_positions: int = 448
    # special token ids (whisper multilingual defaults); from_hf reads
    # only sot and eot, as the JAX package does (large-v3's added <|yue|>
    # shifts the rest: a limit of the reference, kept)
    sot: int = 50258
    eot: int = 50257
    token_transcribe: int = 50359
    token_translate: int = 50358
    token_notimestamps: int = 50363
    lang_base: int = 50259             # <|en|>
    dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "WhisperConfig":
        return cls(
            n_mels=hf.get("num_mel_bins", 80),
            d_model=hf.get("d_model", 384),
            n_heads=hf.get("encoder_attention_heads", 6),
            n_enc_layers=hf.get("encoder_layers", 4),
            n_dec_layers=hf.get("decoder_layers", 4),
            d_ff=hf.get("encoder_ffn_dim", 1536),
            vocab_size=hf.get("vocab_size", 51865),
            max_source_positions=hf.get("max_source_positions", 1500),
            max_target_positions=hf.get("max_target_positions", 448),
            sot=hf.get("decoder_start_token_id", 50258),
            eot=hf.get("eos_token_id", 50257),
        )


# whisper's language order — token id = lang_base + index
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()


def language_token(cfg: WhisperConfig, language: Optional[str]) -> int:
    """language code/name → <|xx|> token id (defaults to English)."""
    if not language:
        return cfg.lang_base
    code = language.strip().lower()
    aliases = {"english": "en", "french": "fr", "german": "de",
               "spanish": "es", "chinese": "zh", "japanese": "ja",
               "korean": "ko", "russian": "ru", "portuguese": "pt",
               "italian": "it", "dutch": "nl", "arabic": "ar",
               "hindi": "hi", "turkish": "tr", "polish": "pl"}
    code = aliases.get(code, code)
    try:
        return cfg.lang_base + LANGUAGES.index(code)
    except ValueError:
        return cfg.lang_base


DEBUG_CONFIG = WhisperConfig(
    d_model=64, n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=128,
    vocab_size=512, max_source_positions=1500, max_target_positions=64,
    sot=500, eot=501, token_transcribe=502, token_translate=503,
    token_notimestamps=504, lang_base=505,
)


def _attn_block_shapes(d: int) -> dict:
    return {
        "ln": (d,), "ln_b": (d,),
        "wq": (d, d), "bq": (d,),
        "wk": (d, d),
        "wv": (d, d), "bv": (d,),
        "wo": (d, d), "bo": (d,),
    }


def param_shapes(cfg: WhisperConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers

    def stack(shapes: dict, n: int) -> dict:
        return {k: (n, *v) for k, v in shapes.items()}

    mlp = {"ln2": (d,), "ln2_b": (d,), "fc1": (d, f), "b1": (f,),
           "fc2": (f, d), "b2": (d,)}
    enc_layer = {**{f"sa_{k}": v for k, v in _attn_block_shapes(d).items()},
                 **mlp}
    dec_layer = {**{f"sa_{k}": v for k, v in _attn_block_shapes(d).items()},
                 **{f"ca_{k}": v for k, v in _attn_block_shapes(d).items()},
                 **mlp}
    return {
        "conv1_w": (d, cfg.n_mels, 3), "conv1_b": (d,),
        "conv2_w": (d, d, 3), "conv2_b": (d,),
        "enc": stack(enc_layer, Le),
        "enc_ln": (d,), "enc_ln_b": (d,),
        "embed": (cfg.vocab_size, d),
        "pos": (cfg.max_target_positions, d),
        "dec": stack(dec_layer, Ld),
        "dec_ln": (d,), "dec_ln_b": (d,),
    }


_GAIN_NAMES = {"sa_ln", "ca_ln", "ln2", "enc_ln", "dec_ln"}


def init_params(cfg: WhisperConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                std: float = 0.02) -> Params:
    """Random weights from a ``torch.Generator`` in the JAX package's
    scheme (1-D leaves 0, the rest N(0, std), the layer-norm gains 1),
    drawn on the CPU and moved, so a seed gives the same weights on every
    device."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    def mk(name: str, shape: tuple) -> torch.Tensor:
        if name in _GAIN_NAMES:
            t = torch.ones(shape)
        elif len(shape) == 1:
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=g) * std
        return t.to(device)

    return {name: ({k: mk(k, s) for k, s in v.items()}
                   if isinstance(v, dict) else mk(name, v))
            for name, v in param_shapes(cfg).items()}


def from_jax_params(tree: Any, device: str | torch.device = "cuda"
                    ) -> Params:
    """The JAX package's whisper tree (float32 numpy arrays) as tensors on
    ``device``."""
    return params_from_numpy(tree, device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _ln(x, g, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _mha(cfg: WhisperConfig, q_in, kv_in, p, prefix, mask=None):
    """q_in [Tq, D], kv_in [Tk, D] → [Tq, D]. Whisper has no k bias."""
    H, hd = cfg.n_heads, cfg.hd
    q = (q_in @ p[f"{prefix}_wq"] + p[f"{prefix}_bq"]).reshape(-1, H, hd)
    k = (kv_in @ p[f"{prefix}_wk"]).reshape(-1, H, hd)
    v = (kv_in @ p[f"{prefix}_wv"] + p[f"{prefix}_bv"]).reshape(-1, H, hd)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[None], scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(-1, cfg.d_model)
    return out @ p[f"{prefix}_wo"] + p[f"{prefix}_bo"]


def _sinusoids(length: int, channels: int,
               device: torch.device) -> torch.Tensor:
    """Whisper's sinusoidal encoder positions."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def encode(cfg: WhisperConfig, params: Params,
           mel: torch.Tensor) -> torch.Tensor:
    """mel [n_mels, frames] → encoder states [frames//2, D]."""
    # explicit (1, 1) padding on both convs, as torch's Conv1d(padding=1)
    # and the JAX package's explicit pads (XLA's SAME would resolve to
    # (0, 1) at conv2's stride 2 and shift every frame by one step)
    x = _gelu(F.conv1d(mel[None], params["conv1_w"], params["conv1_b"],
                       padding=1))
    x = _gelu(F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2,
                       padding=1))
    x = x[0].T                                       # [T', D]
    x = x + _sinusoids(x.shape[0], cfg.d_model, x.device)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc"], i)
        h = _ln(x, lp["sa_ln"], lp["sa_ln_b"])
        x = x + _mha(cfg, h, h, lp, "sa")
        m = _ln(x, lp["ln2"], lp["ln2_b"])
        x = x + (_gelu(m @ lp["fc1"] + lp["b1"]) @ lp["fc2"] + lp["b2"])
    return _ln(x, params["enc_ln"], params["enc_ln_b"])


def decode_logits(cfg: WhisperConfig, params: Params, tokens: torch.Tensor,
                  length: int, enc: torch.Tensor) -> torch.Tensor:
    """tokens [Tmax] (padded), length → logits [V] at length-1 (the
    teacher-forced decoder over the whole buffer)."""
    Tmax = tokens.shape[0]
    # an id past the table (a checkpoint whose vocabulary is smaller than
    # the special ids) reads the last row, as the JAX package's gather
    # clamps it
    V = params["embed"].shape[0]
    x = params["embed"][tokens.clamp(0, V - 1)] + params["pos"][:Tmax]
    t = torch.arange(Tmax, device=x.device)
    causal = (t[:, None] >= t[None, :]) & (t[None, :] < length)
    for i in range(cfg.n_dec_layers):
        lp = _layer(params["dec"], i)
        h = _ln(x, lp["sa_ln"], lp["sa_ln_b"])
        x = x + _mha(cfg, h, h, lp, "sa", mask=causal)
        x = x + _mha(cfg, _ln(x, lp["ca_ln"], lp["ca_ln_b"]), enc, lp, "ca")
        m = _ln(x, lp["ln2"], lp["ln2_b"])
        x = x + (_gelu(m @ lp["fc1"] + lp["b1"]) @ lp["fc2"] + lp["b2"])
    x = _ln(x, params["dec_ln"], params["dec_ln_b"])
    return x[length - 1] @ params["embed"].T


def cross_kv(cfg: WhisperConfig, params: Params, enc: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K and V of every decoder layer, [L, H, Tenc,
    hd] each, projected once per chunk (the encoder output is fixed)."""
    dec = params["dec"]

    def heads(x: torch.Tensor) -> torch.Tensor:
        L, T, _ = x.shape
        return x.view(L, T, cfg.n_heads, cfg.hd).transpose(1, 2).contiguous()

    ca_k = torch.einsum("td,lde->lte", enc, dec["ca_wk"])
    ca_v = torch.einsum("td,lde->lte", enc, dec["ca_wv"]) + dec["ca_bv"][:, None]
    return heads(ca_k), heads(ca_v)


def decoder_layers(cfg: WhisperConfig, params: Params) -> list[dict]:
    """Each decoder layer's tensors as views, taken once per chunk rather
    than once per layer per token."""
    return [_layer(params["dec"], i) for i in range(cfg.n_dec_layers)]


def cached_step(cfg: WhisperConfig, params: Params, token: int, t: int,
                sa_k: torch.Tensor, sa_v: torch.Tensor, ca_k: torch.Tensor,
                ca_v: torch.Tensor,
                layers: Optional[list[dict]] = None) -> torch.Tensor:
    """One KV-cached decoder step at position ``t``: writes position
    ``t`` of the self-attention cache ``sa_k``/``sa_v`` [L, H, Tmax, hd]
    in place and returns the final-norm hidden state [D] (``@ embed.T``
    gives the logits). Projections with a bias are one ``addmm`` each
    and the attention products batched matmuls over the heads: a step is
    host-bound, so fewer launches are the step's time."""
    H, hd, D = cfg.n_heads, cfg.hd, cfg.d_model
    # an id past the table reads its last row (the JAX gather's clamp)
    token = min(max(int(token), 0), params["embed"].shape[0] - 1)
    x = (params["embed"][token] + params["pos"][t])[None]      # [1, D]
    scale = math.sqrt(hd)
    for i, lp in enumerate(layers or decoder_layers(cfg, params)):
        h = _ln(x, lp["sa_ln"], lp["sa_ln_b"])
        q = torch.addmm(lp["sa_bq"], h, lp["sa_wq"]).view(H, 1, hd)
        sa_k[i, :, t] = (h @ lp["sa_wk"]).view(H, hd)
        sa_v[i, :, t] = torch.addmm(lp["sa_bv"], h, lp["sa_wv"]).view(H, hd)
        s = q @ sa_k[i, :, :t + 1].transpose(1, 2) / scale       # [H, 1, t+1]
        a = torch.softmax(s, dim=-1) @ sa_v[i, :, :t + 1]
        x = x + torch.addmm(lp["sa_bo"], a.view(1, D), lp["sa_wo"])

        h2 = _ln(x, lp["ca_ln"], lp["ca_ln_b"])
        q2 = torch.addmm(lp["ca_bq"], h2, lp["ca_wq"]).view(H, 1, hd)
        s2 = q2 @ ca_k[i].transpose(1, 2) / scale
        c = torch.softmax(s2, dim=-1) @ ca_v[i]
        x = x + torch.addmm(lp["ca_bo"], c.view(1, D), lp["ca_wo"])

        m = _ln(x, lp["ln2"], lp["ln2_b"])
        x = x + torch.addmm(lp["b2"], _gelu(torch.addmm(lp["b1"], m,
                                                          lp["fc1"])),
                            lp["fc2"])
    return _ln(x, params["dec_ln"], params["dec_ln_b"])[0]


def decode_greedy(cfg: WhisperConfig, params: Params, prompt: list[int],
                  enc: torch.Tensor, limit: int) -> list[int]:
    """The chunk's KV-cached greedy decode: the prompt's steps fill the
    cache, then generate until <eot>, ``limit`` tokens or the last
    target position. Returns the generated ids (eot excluded)."""
    Tmax = cfg.max_target_positions
    ca_k, ca_v = cross_kv(cfg, params, enc)
    sa_k = torch.zeros((cfg.n_dec_layers, cfg.n_heads, Tmax, cfg.hd),
                       dtype=enc.dtype, device=enc.device)
    sa_v = torch.zeros_like(sa_k)
    layers = decoder_layers(cfg, params)
    out: list[int] = []
    token, t = prompt[0], 0
    while len(out) < limit and t < Tmax - 1:
        x = cached_step(cfg, params, token, t, sa_k, sa_v, ca_k, ca_v,
                        layers)
        t += 1
        if t < len(prompt):          # a prompt step: the cache only
            token = prompt[t]
            continue
        token = int(torch.argmax(x @ params["embed"].T))
        if token == cfg.eot:
            break
        out.append(token)
    return out


class WhisperModel:
    """Loaded whisper engine: encode + KV-cached greedy decode per chunk,
    on ``device``, float32 with TF32 off."""

    def __init__(self, cfg: WhisperConfig, params: Params, tokenizer=None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.filters = torch.from_numpy(
            melmod.mel_filterbank(cfg.n_mels)).to(self.device)

    def encode_chunk(self, audio: np.ndarray) -> torch.Tensor:
        """One 30-s chunk → encoder states [frames//2, D] on the device."""
        with torch.inference_mode(), full_f32():
            mel = melmod.log_mel(
                torch.from_numpy(np.asarray(audio, np.float32)).to(
                    self.device), self.filters)
            return encode(self.cfg, self.params, mel)

    def transcribe_chunk(self, audio: np.ndarray, *,
                         language: Optional[str] = None,
                         translate: bool = False,
                         max_tokens: Optional[int] = None) -> list[int]:
        """One ≤30-s chunk → decoded token ids (specials stripped)."""
        cfg = self.cfg
        enc = self.encode_chunk(audio)
        task = cfg.token_translate if translate else cfg.token_transcribe
        prompt = [cfg.sot, language_token(cfg, language), task,
                  cfg.token_notimestamps]
        limit = min(max_tokens or cfg.max_target_positions,
                    cfg.max_target_positions - len(prompt))
        with torch.inference_mode(), full_f32():
            ids = decode_greedy(cfg, self.params, prompt, enc, limit)
        return [t for t in ids if t < cfg.eot and t < cfg.sot]

    def transcribe(self, audio: np.ndarray, *,
                   language: Optional[str] = None,
                   translate: bool = False,
                   max_tokens_per_chunk: Optional[int] = None) -> dict:
        """Full-file transcription → {text, segments} (the JAX package's
        segment schema)."""
        segments = []
        texts = []
        for i, chunk in enumerate(melmod.chunk_audio(audio)):
            ids = self.transcribe_chunk(
                chunk, language=language, translate=translate,
                max_tokens=max_tokens_per_chunk,
            )
            text = self._decode_text(ids)
            start = i * melmod.CHUNK_SECONDS
            end = min((i + 1) * melmod.CHUNK_SECONDS,
                      max(len(audio), 1) / melmod.SAMPLE_RATE)
            segments.append({
                "id": i,
                "start": float(start),
                "end": float(end),
                "text": text,
                "tokens": ids,
            })
            texts.append(text)
        return {"text": " ".join(t for t in texts if t).strip(),
                "segments": segments}

    def _decode_text(self, ids: list[int]) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


def debug_model(seed: int = 0,
                device: str | torch.device = "cuda") -> WhisperModel:
    cfg = DEBUG_CONFIG
    return WhisperModel(cfg, init_params(cfg, seed, device), device=device)


# HF transformers WhisperForConditionalGeneration → stacked layout
_HF_ENC = "model.encoder.layers.{i}."
_HF_DEC = "model.decoder.layers.{i}."
_HF_ATTN = {"wq": ("q_proj.weight", True), "bq": ("q_proj.bias", False),
            "wk": ("k_proj.weight", True), "wv": ("v_proj.weight", True),
            "bv": ("v_proj.bias", False), "wo": ("out_proj.weight", True),
            "bo": ("out_proj.bias", False)}
_HF_LAYER = {"sa_ln": "self_attn_layer_norm.weight",
             "sa_ln_b": "self_attn_layer_norm.bias",
             "ca_ln": "encoder_attn_layer_norm.weight",
             "ca_ln_b": "encoder_attn_layer_norm.bias",
             "ln2": "final_layer_norm.weight",
             "ln2_b": "final_layer_norm.bias"}
_HF_MLP = {"fc1": ("fc1.weight", True), "b1": ("fc1.bias", False),
           "fc2": ("fc2.weight", True), "b2": ("fc2.bias", False)}
_HF_TOP = {"conv1_w": "model.encoder.conv1.weight",
           "conv1_b": "model.encoder.conv1.bias",
           "conv2_w": "model.encoder.conv2.weight",
           "conv2_b": "model.encoder.conv2.bias",
           "enc_ln": "model.encoder.layer_norm.weight",
           "enc_ln_b": "model.encoder.layer_norm.bias",
           "embed": "model.decoder.embed_tokens.weight",
           "pos": "model.decoder.embed_positions.weight",
           "dec_ln": "model.decoder.layer_norm.weight",
           "dec_ln_b": "model.decoder.layer_norm.bias"}


def hf_layer_names(key: str) -> tuple[str, bool]:
    """Our stacked key → (the HF name under a layer's prefix, whether
    the HF tensor is the transpose of ours)."""
    if key in _HF_LAYER:
        return _HF_LAYER[key], False
    if key in _HF_MLP:
        return _HF_MLP[key]
    block, _, k = key.partition("_")
    hf, tr = _HF_ATTN[k]
    return ("encoder_attn." if block == "ca" else "self_attn.") + hf, tr


def hf_tensors(cfg: WhisperConfig, params: Params) -> dict:
    """HF name → getter of the tensor in HF's layout, for every tensor of
    ``params`` (the inverse of :func:`load_hf_whisper`'s mapping; the
    smoke writes a checkpoint through it)."""
    out = {hf: (lambda k=k: params[k]) for k, hf in _HF_TOP.items()}
    for stack, prefix, n in (("enc", _HF_ENC, cfg.n_enc_layers),
                             ("dec", _HF_DEC, cfg.n_dec_layers)):
        for key, t in params[stack].items():
            name, tr = hf_layer_names(key)
            for i in range(n):
                out[prefix.format(i=i) + name] = (
                    lambda t=t, i=i, tr=tr: t[i].T if tr else t[i])
    return out


def load_hf_whisper(model_dir: str | Path,
                    device: str | torch.device = "cuda") -> WhisperModel:
    """Load a HF whisper checkpoint (config.json + safetensors, any float
    dtype, widened to float32) through the port's safetensors reader, with
    its ``tokenizer.json`` (``utils.tokenizer.load_tokenizer``)."""
    import json

    from localai_tpu_torch.models.loader import _open_safetensors, read_tensor
    from localai_tpu_torch.utils.tokenizer import load_tokenizer

    device = resolve_device(device)
    model_dir = Path(model_dir)
    cfg = WhisperConfig.from_hf(json.loads(
        (model_dir / "config.json").read_text()))
    index = _open_safetensors(model_dir)

    def get(name: str) -> torch.Tensor:
        return read_tensor(index[name]).float()

    def stack_layers(stack: str, prefix: str, n: int) -> dict:
        out = {}
        for key in param_shapes(cfg)[stack]:
            name, tr = hf_layer_names(key)
            out[key] = torch.stack([
                get(prefix.format(i=i) + name).T if tr
                else get(prefix.format(i=i) + name)
                for i in range(n)]).contiguous().to(device)
        return out

    params: Params = {k: get(hf).to(device) for k, hf in _HF_TOP.items()}
    params["enc"] = stack_layers("enc", _HF_ENC, cfg.n_enc_layers)
    params["dec"] = stack_layers("dec", _HF_DEC, cfg.n_dec_layers)
    return WhisperModel(cfg, params, tokenizer=load_tokenizer(model_dir),
                        device=device)
