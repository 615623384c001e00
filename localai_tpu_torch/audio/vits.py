"""VITS text-to-speech in PyTorch: the neural voice path.

Port of ``localai_tpu/audio/vits.py``: the text encoder with windowed
relative attention, the stochastic duration predictor (rational-quadratic
spline conv flows, reverse direction) or the deterministic one, the
residual-coupling flow and the HiFi-GAN decoder, reading HuggingFace
``VitsModel`` checkpoints (model_type "vits": facebook/mms-tts-*).
Tensors are [B, C, L] as in the torch modules, so torch's own
``conv1d``/``conv_transpose1d`` take the place of the JAX package's
``lax.conv_general_dilated`` emulations. Weight-normed convs are fused
once at load (``_P``, the JAX package's formula in numpy float32) where
the JAX package fuses them on every read.

Length regulation stays on the host, as in the JAX package: the
predicted durations are read back and each text position repeated by its
own. The two noise draws (the duration latents and the prior) come from
a ``torch.Generator`` seeded with ``seed``, drawn on the CPU and moved,
so a seed gives the same audio on every device; ``_forward`` takes
either draw as an argument instead (the tests feed it the JAX package's).
Float32 with TF32 off on the card (``utils.device.full_f32``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class VitsConfig:
    vocab_size: int = 38
    hidden_size: int = 192
    num_layers: int = 6
    num_heads: int = 2
    window_size: int = 4
    use_bias: bool = True
    ffn_dim: int = 768
    ffn_kernel_size: int = 3
    layer_norm_eps: float = 1e-5
    flow_size: int = 192
    spectrogram_bins: int = 513
    prior_encoder_num_flows: int = 4
    prior_encoder_num_wavenet_layers: int = 4
    wavenet_kernel_size: int = 5
    wavenet_dilation_rate: int = 1
    use_stochastic_duration_prediction: bool = True
    duration_predictor_num_flows: int = 4
    duration_predictor_kernel_size: int = 3
    duration_predictor_filter_channels: int = 256
    duration_predictor_flow_bins: int = 10
    duration_predictor_tail_bound: float = 5.0
    depth_separable_channels: int = 2
    depth_separable_num_layers: int = 3
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    num_speakers: int = 1
    speaker_embedding_size: int = 0
    sampling_rate: int = 16000
    speaking_rate: float = 1.0
    noise_scale: float = 0.667
    noise_scale_duration: float = 0.8
    pad_token_id: int = 0
    add_blank: bool = True

    @classmethod
    def from_hf(cls, hf: dict) -> "VitsConfig":
        aliases = {"num_layers": "num_hidden_layers",
                   "num_heads": "num_attention_heads"}
        kw = {}
        for f in dataclasses.fields(cls):
            src = aliases.get(f.name, f.name)
            if src in hf:
                v = hf[src]
                if isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
                kw[f.name] = v
        return cls(**kw)


# ---------------------------------------------------------------------------
# primitives (all tensors [B, C, L], the torch layouts)


def layer_norm_cl(x, g, b, eps):
    """LayerNorm over the channel dim of [B,C,L] (torch transposes to
    channels-last; normalizing axis 1 directly is equivalent)."""
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g[None, :, None] \
        + b[None, :, None]


def leaky_relu(x, slope):
    return torch.where(x >= 0, x, x * slope)


def _fuse_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    g = np.asarray(g, np.float32)
    v = np.asarray(v, np.float32)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


class _P:
    """HF-named float32 tensors on one device, weight norms fused: a
    ``weight_g``/``weight_v`` or ``parametrizations.weight.original0/1``
    pair becomes its ``.weight``."""

    def __init__(self, tensors: dict[str, np.ndarray],
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        fused: dict[str, np.ndarray] = {}
        for name, a in tensors.items():
            for gs, vs in ((".weight_g", ".weight_v"),
                           (".parametrizations.weight.original0",
                            ".parametrizations.weight.original1")):
                if name.endswith(gs):
                    base = name[: -len(gs)]
                    fused[base + ".weight"] = _fuse_weight_norm(
                        a, tensors[base + vs])
                    break
                if name.endswith(vs):
                    break
            else:
                fused[name] = np.asarray(a, np.float32)
        self.t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in fused.items()}

    def __contains__(self, k):
        return k in self.t

    def get(self, name: str) -> torch.Tensor:
        return self.t[name]

    def opt(self, name: str) -> Optional[torch.Tensor]:
        return self.t.get(name)


# ---------------------------------------------------------------------------
# text encoder (relative-position attention — VitsAttention parity)


def _relative_embeddings(rel, window, length):
    pad = max(length - (window + 1), 0)
    if pad > 0:
        rel = F.pad(rel, (0, 0, pad, pad))
    start = max((window + 1) - length, 0)
    return rel[:, start: start + 2 * length - 1]


def _rel_to_abs(x):
    bh, length, _ = x.shape
    x = F.pad(x, (0, 1))
    xf = x.reshape(bh, length * 2 * length)
    xf = F.pad(xf, (0, length - 1))
    return xf.reshape(bh, length + 1, 2 * length - 1)[:, :length,
                                                      length - 1:]


def _abs_to_rel(x):
    bh, length, _ = x.shape
    x = F.pad(x, (0, length - 1))
    xf = x.reshape(bh, length * (2 * length - 1))
    xf = F.pad(xf, (length, 0))
    return xf.reshape(bh, length, 2 * length)[:, :, 1:]


def _linear(p: _P, name: str, x):
    out = x @ p.get(f"{name}.weight").T
    b = p.opt(f"{name}.bias")
    return out + b if b is not None else out


def _attention(p: _P, pre: str, cfg: VitsConfig, x, attn_mask):
    """x [B,L,H] → [B,L,H] (channels-last like the torch module)."""
    B, L, H = x.shape
    nh = cfg.num_heads
    hd = H // nh
    scale = hd ** -0.5

    def heads(t):
        return t.reshape(B, L, nh, hd).transpose(1, 2).reshape(B * nh, L, hd)

    q = heads(_linear(p, f"{pre}.q_proj", x) * scale)
    k = heads(_linear(p, f"{pre}.k_proj", x))
    v = heads(_linear(p, f"{pre}.v_proj", x))
    weights = q @ k.transpose(1, 2)
    if cfg.window_size:
        rel_k = _relative_embeddings(
            p.get(f"{pre}.emb_rel_k"), cfg.window_size, L)
        weights = weights + _rel_to_abs(q @ rel_k.transpose(1, 2))
    if attn_mask is not None:
        weights = torch.where(
            attn_mask.reshape(B, 1, 1, L) > 0, weights.reshape(B, nh, L, L),
            -1e9,
        ).reshape(B * nh, L, L)
    probs = torch.softmax(weights, dim=-1)
    out = probs @ v
    if cfg.window_size:
        rel_v = _relative_embeddings(
            p.get(f"{pre}.emb_rel_v"), cfg.window_size, L)
        out = out + _abs_to_rel(probs) @ rel_v
    out = out.reshape(B, nh, L, hd).transpose(1, 2).reshape(B, L, H)
    return _linear(p, f"{pre}.out_proj", out)


def _ln_last(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _conv(p: _P, name: str, x, **kw):
    return F.conv1d(x, p.get(f"{name}.weight"), p.opt(f"{name}.bias"), **kw)


def _feed_forward(p: _P, pre: str, cfg: VitsConfig, x, pad_cl):
    """x [B,L,H]; pad_cl [B,L,1] — VitsFeedForward parity (asymmetric
    conv padding)."""
    h = (x * pad_cl).transpose(1, 2)
    mask = pad_cl.transpose(1, 2)
    k = cfg.ffn_kernel_size
    if k > 1:
        h = F.pad(h, ((k - 1) // 2, k // 2))
    h = torch.relu(_conv(p, f"{pre}.conv_1", h))
    h = h * mask
    if k > 1:
        h = F.pad(h, ((k - 1) // 2, k // 2))
    h = _conv(p, f"{pre}.conv_2", h)
    return (h * mask).transpose(1, 2)


def text_encoder(p: _P, cfg: VitsConfig, ids, pad_mask):
    """ids [B,L]; pad_mask [B,L] → (hidden [B,H,L], m_p, logs_p [B,F,L])."""
    x = p.get("text_encoder.embed_tokens.weight")[ids]
    x = x * math.sqrt(cfg.hidden_size)
    pad_cl = pad_mask[:, :, None].to(x.dtype)
    x = x * pad_cl
    for i in range(cfg.num_layers):
        pre = f"text_encoder.encoder.layers.{i}"
        attn = _attention(p, f"{pre}.attention", cfg, x, pad_mask)
        x = _ln_last(x + attn, p.get(f"{pre}.layer_norm.weight"),
                     p.get(f"{pre}.layer_norm.bias"), cfg.layer_norm_eps)
        ff = _feed_forward(p, f"{pre}.feed_forward", cfg, x, pad_cl)
        x = _ln_last(x + ff, p.get(f"{pre}.final_layer_norm.weight"),
                     p.get(f"{pre}.final_layer_norm.bias"),
                     cfg.layer_norm_eps)
    x = x * pad_cl
    stats = _conv(p, "text_encoder.project", x.transpose(1, 2))
    stats = stats * pad_cl.transpose(1, 2)
    m_p, logs_p = torch.chunk(stats, 2, dim=1)
    return x.transpose(1, 2), m_p, logs_p


# ---------------------------------------------------------------------------
# WaveNet + residual coupling flow (reverse only — inference)


def _wavenet(p: _P, pre: str, cfg: VitsConfig, x, pad, num_layers,
             cond=None):
    """VitsWaveNet parity: x [B,H,L]."""
    H = cfg.hidden_size
    if cond is not None:
        cond = _conv(p, f"{pre}.cond_layer", cond)
    outputs = torch.zeros_like(x)
    for i in range(num_layers):
        dilation = cfg.wavenet_dilation_rate ** i
        padding = (cfg.wavenet_kernel_size * dilation - dilation) // 2
        h = _conv(p, f"{pre}.in_layers.{i}", x, dilation=dilation,
                  padding=padding)
        if cond is not None:
            off = i * 2 * H
            h = h + cond[:, off: off + 2 * H]
        acts = torch.tanh(h[:, :H]) * torch.sigmoid(h[:, H:])
        rs = _conv(p, f"{pre}.res_skip_layers.{i}", acts)
        if i < num_layers - 1:
            x = (x + rs[:, :H]) * pad
            outputs = outputs + rs[:, H:]
        else:
            outputs = outputs + rs
    return outputs * pad


def flow_reverse(p: _P, cfg: VitsConfig, z, pad, cond=None):
    """VitsResidualCouplingBlock reverse (inference direction)."""
    half = cfg.flow_size // 2
    for i in reversed(range(cfg.prior_encoder_num_flows)):
        z = torch.flip(z, dims=(1,))
        pre = f"flow.flows.{i}"
        first, second = z[:, :half], z[:, half:]
        h = _conv(p, f"{pre}.conv_pre", first) * pad
        h = _wavenet(p, f"{pre}.wavenet", cfg, h, pad,
                     cfg.prior_encoder_num_wavenet_layers, cond)
        mean = _conv(p, f"{pre}.conv_post", h) * pad
        second = (second - mean) * pad
        z = torch.cat([first, second], dim=1)
    return z


# ---------------------------------------------------------------------------
# duration predictors


def _dds(p: _P, pre: str, cfg: VitsConfig, x, pad, cond=None):
    """VitsDilatedDepthSeparableConv parity."""
    if cond is not None:
        x = x + cond
    k = cfg.duration_predictor_kernel_size
    for i in range(cfg.depth_separable_num_layers):
        dilation = k ** i
        padding = (k * dilation - dilation) // 2
        h = _conv(p, f"{pre}.convs_dilated.{i}", x * pad, dilation=dilation,
                  padding=padding, groups=x.shape[1])
        h = layer_norm_cl(h, p.get(f"{pre}.norms_1.{i}.weight"),
                          p.get(f"{pre}.norms_1.{i}.bias"),
                          cfg.layer_norm_eps)
        h = F.gelu(h)
        h = _conv(p, f"{pre}.convs_pointwise.{i}", h)
        h = layer_norm_cl(h, p.get(f"{pre}.norms_2.{i}.weight"),
                          p.get(f"{pre}.norms_2.{i}.bias"),
                          cfg.layer_norm_eps)
        h = F.gelu(h)
        x = x + h
    return x * pad


def _rq_spline_reverse(inputs, uw, uh, ud, tail_bound):
    """_unconstrained_rational_quadratic_spline (reverse) — vectorized
    with masking instead of boolean indexing."""
    min_bin_width = min_bin_height = min_derivative = 1e-3
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    num_bins = uw.shape[-1]
    constant = math.log(math.exp(1 - min_derivative) - 1)
    ud = F.pad(ud, (1, 1), value=constant)

    def knots(u):
        size = torch.softmax(u, dim=-1)
        size = min_bin_width + (1 - min_bin_width * num_bins) * size
        cum = F.pad(torch.cumsum(size, -1), (1, 0))
        cum = 2 * tail_bound * cum - tail_bound
        cum[..., 0] = -tail_bound
        cum[..., -1] = tail_bound
        return cum, cum[..., 1:] - cum[..., :-1]

    cumw, widths = knots(uw)
    derivs = min_derivative + F.softplus(ud)
    cumh, heights = knots(uh)

    # reverse mode bins locate on the height axis
    locs = cumh.clone()
    locs[..., -1] += 1e-6
    safe_in = torch.clamp(inputs, -tail_bound, tail_bound)
    bin_idx = (safe_in[..., None] >= locs).sum(-1) - 1
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def g(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    in_cumw = g(cumw)
    in_w = g(widths)
    in_cumh = g(cumh)
    delta = heights / widths
    in_delta = g(delta)
    in_d = g(derivs)
    in_d1 = g(derivs[..., 1:])
    in_h = g(heights)

    i1 = in_d + in_d1 - 2 * in_delta
    i2 = safe_in - in_cumh
    i3 = i2 * i1
    a = in_h * (in_delta - in_d) + i3
    b = in_h * in_d - i3
    c = -in_delta * i2
    disc = b ** 2 - 4 * a * c
    root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
    outputs = root * in_w + in_cumw
    return torch.where(inside, outputs, inputs)


def _conv_flow_reverse(p: _P, pre: str, cfg: VitsConfig, z, pad, cond):
    half = cfg.depth_separable_channels // 2
    first, second = z[:, :half], z[:, half:]
    h = _conv(p, f"{pre}.conv_pre", first)
    h = _dds(p, f"{pre}.conv_dds", cfg, h, pad, cond)
    h = _conv(p, f"{pre}.conv_proj", h) * pad
    B, C, L = first.shape
    nb = cfg.duration_predictor_flow_bins
    h = h.reshape(B, C, -1, L).permute(0, 1, 3, 2)
    scale = math.sqrt(cfg.hidden_size)
    second = _rq_spline_reverse(
        second, h[..., :nb] / scale, h[..., nb: 2 * nb] / scale,
        h[..., 2 * nb:], cfg.duration_predictor_tail_bound,
    )
    return torch.cat([first, second], dim=1) * pad


def stochastic_duration_reverse(p: _P, cfg: VitsConfig, x, pad,
                                noise, cond=None):
    """VitsStochasticDurationPredictor reverse → log durations [B,1,L].
    ``noise`` is the [B,2,L] latent draw, scaled (0 → deterministic)."""
    pre = "duration_predictor"
    x = _conv(p, f"{pre}.conv_pre", x)
    if cond is not None:
        x = x + _conv(p, f"{pre}.cond", cond)
    x = _dds(p, f"{pre}.conv_dds", cfg, x, pad)
    x = _conv(p, f"{pre}.conv_proj", x) * pad

    # flows reversed, dropping the "useless vflow" (modeling_vits.py:792):
    # flows[n] .. flows[2], then flows[0] (ElementwiseAffine)
    n = cfg.duration_predictor_num_flows
    latents = noise
    for idx in list(range(n, 1, -1)) + [0]:
        latents = torch.flip(latents, dims=(1,))
        fp = f"{pre}.flows.{idx}"
        if idx == 0:
            tr = p.get(f"{fp}.translate")
            ls = p.get(f"{fp}.log_scale")
            latents = (latents - tr[None]) * torch.exp(-ls[None]) * pad
        else:
            latents = _conv_flow_reverse(p, fp, cfg, latents, pad, x)
    return latents[:, :1]


def duration_predictor(p: _P, cfg: VitsConfig, x, pad, cond=None):
    """Deterministic VitsDurationPredictor → log durations [B,1,L]."""
    pre = "duration_predictor"
    if cond is not None:
        x = x + _conv(p, f"{pre}.cond", cond)
    k = cfg.duration_predictor_kernel_size
    h = _conv(p, f"{pre}.conv_1", x * pad, padding=k // 2)
    h = layer_norm_cl(torch.relu(h), p.get(f"{pre}.norm_1.weight"),
                      p.get(f"{pre}.norm_1.bias"), cfg.layer_norm_eps)
    h = _conv(p, f"{pre}.conv_2", h * pad, padding=k // 2)
    h = layer_norm_cl(torch.relu(h), p.get(f"{pre}.norm_2.weight"),
                      p.get(f"{pre}.norm_2.bias"), cfg.layer_norm_eps)
    return _conv(p, f"{pre}.proj", h * pad) * pad


# ---------------------------------------------------------------------------
# HiFi-GAN decoder


def hifigan(p: _P, cfg: VitsConfig, spec, cond=None):
    """spec [B,F,L] → waveform [B, L*prod(upsample_rates)]."""
    x = _conv(p, "decoder.conv_pre", spec, padding=3)
    if cond is not None:
        x = x + _conv(p, "decoder.cond", cond)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates,
                                      cfg.upsample_kernel_sizes)):
        x = leaky_relu(x, cfg.leaky_relu_slope)
        x = F.conv_transpose1d(
            x, p.get(f"decoder.upsampler.{i}.weight"),
            p.opt(f"decoder.upsampler.{i}.bias"),
            stride=rate, padding=(k - rate) // 2,
        )
        acc = None
        for j in range(nk):
            rb = f"decoder.resblocks.{i * nk + j}"
            ks = cfg.resblock_kernel_sizes[j]
            h = x
            for ci, dil in enumerate(cfg.resblock_dilation_sizes[j]):
                r = leaky_relu(h, cfg.leaky_relu_slope)
                r = _conv(p, f"{rb}.convs1.{ci}", r, dilation=dil,
                          padding=(ks * dil - dil) // 2)
                r = leaky_relu(r, cfg.leaky_relu_slope)
                r = _conv(p, f"{rb}.convs2.{ci}", r, padding=(ks - 1) // 2)
                h = h + r
            acc = h if acc is None else acc + h
        x = acc / nk
    x = leaky_relu(x, 0.01)  # torch F.leaky_relu default slope
    x = F.conv1d(x, p.get("decoder.conv_post.weight"), padding=3)
    return torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# tokenizer + model


class VitsCharTokenizer:
    """HF VitsTokenizer behavior: char → id via vocab.json, optional
    lowercasing and blank interspersal (tokenizer_config.json)."""

    def __init__(self, model_dir: Path):
        self.vocab = json.loads(
            (model_dir / "vocab.json").read_text()
        )
        tc = {}
        tc_path = model_dir / "tokenizer_config.json"
        if tc_path.exists():
            tc = json.loads(tc_path.read_text())
        self.do_lower = tc.get("do_lower_case", True)
        self.add_blank = tc.get("add_blank", True)
        self.pad_id = self.vocab.get(tc.get("pad_token", "<pad>"), 0)

    def encode(self, text: str) -> list[int]:
        if self.do_lower:
            text = text.lower()
        ids = [self.vocab[ch] for ch in text if ch in self.vocab]
        if not ids:
            ids = [self.pad_id]
        if self.add_blank:
            out = [self.pad_id] * (2 * len(ids) + 1)
            out[1::2] = ids
            return out
        return ids


class VitsTTS:
    """One loaded VITS voice: text → waveform, on ``params.device``."""

    def __init__(self, cfg: VitsConfig, params: _P, tokenizer: Any):
        self.cfg = cfg
        self.p = params
        self.tokenizer = tokenizer
        self.device = params.device
        self.last_frames = 0     # spectrogram frames of the last synthesis

    def synthesize(self, text: str, *, speaker_id: Optional[int] = None,
                   speaker_embedding: Optional[np.ndarray] = None,
                   noise_scale: Optional[float] = None,
                   noise_scale_duration: Optional[float] = None,
                   speaking_rate: Optional[float] = None,
                   seed: int = 0) -> np.ndarray:
        """float32 waveform in [-1, 1] at cfg.sampling_rate.

        ``speaker_embedding`` conditions the flow/decoder/duration nets on
        a CONTINUOUS [speaker_embedding_size] vector — the voice-cloning
        path (audio.speaker.SpeakerEncoder output), bypassing the trained
        speaker table. Takes precedence over ``speaker_id``."""
        cfg = self.cfg
        ids = np.asarray([self.tokenizer.encode(text)], np.int64)
        pad_mask = np.ones(ids.shape, np.float32)
        wav = self._forward(
            ids, pad_mask,
            noise_scale=cfg.noise_scale if noise_scale is None
            else noise_scale,
            noise_scale_duration=cfg.noise_scale_duration
            if noise_scale_duration is None else noise_scale_duration,
            speaking_rate=cfg.speaking_rate if speaking_rate is None
            else speaking_rate,
            speaker_id=speaker_id, speaker_embedding=speaker_embedding,
            seed=seed,
        )
        return wav[0]

    def _forward(self, ids, pad_mask, *, noise_scale,
                 noise_scale_duration, speaking_rate, speaker_id, seed,
                 speaker_embedding=None,
                 duration_noise: Optional[np.ndarray] = None,
                 prior_noise: Optional[np.ndarray] = None) -> np.ndarray:
        """ids [B,L] → waveform [B, samples] (numpy float32). The noises
        are standard-normal draws, the duration latents' [B,2,L] and the
        prior's [B,F,frames]; each one not given is drawn from the seeded
        generator (the duration draw first, as the JAX package splits its
        key)."""
        with torch.inference_mode(), full_f32():
            return self._run(ids, pad_mask, noise_scale,
                             noise_scale_duration, speaking_rate,
                             speaker_id, seed, speaker_embedding,
                             duration_noise, prior_noise)

    def _run(self, ids, pad_mask, noise_scale, noise_scale_duration,
             speaking_rate, speaker_id, seed, speaker_embedding,
             duration_noise, prior_noise) -> np.ndarray:
        cfg, p, dev = self.cfg, self.p, self.device
        gen = torch.Generator().manual_seed(int(seed))
        pad_mask_t = torch.as_tensor(np.asarray(pad_mask, np.float32),
                                     device=dev)
        pad = pad_mask_t[:, None, :]  # [B,1,L]
        cond = None
        if speaker_embedding is not None and cfg.speaker_embedding_size:
            emb = np.asarray(speaker_embedding, np.float32)
            if emb.shape != (cfg.speaker_embedding_size,):
                raise ValueError(
                    f"speaker_embedding must be [{cfg.speaker_embedding_size}]"
                    f", got {emb.shape}"
                )
            # match the trained table's scale so the conditioning convs see
            # in-distribution magnitudes
            tab = p.get("embed_speaker.weight").cpu().numpy()
            emb = emb * float(np.linalg.norm(tab, axis=1).mean())
            cond = torch.from_numpy(emb).to(dev)[None, :, None]
        elif cfg.num_speakers > 1 and speaker_id is not None:
            cond = p.get("embed_speaker.weight")[speaker_id][None, :, None]
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        hidden, m_p, logs_p = text_encoder(p, cfg, ids_t, pad_mask_t)
        if cfg.use_stochastic_duration_prediction:
            shape = (ids.shape[0], 2, ids.shape[1])
            if duration_noise is None:
                noise = torch.randn(shape, generator=gen)
            else:
                noise = torch.from_numpy(
                    np.array(duration_noise, np.float32).reshape(shape))
            noise = noise.to(dev) * noise_scale_duration
            log_d = stochastic_duration_reverse(
                p, cfg, hidden, pad, noise, cond)
        else:
            log_d = duration_predictor(p, cfg, hidden, pad, cond)
        durations = np.ceil(
            torch.exp(log_d).cpu().numpy() * np.asarray(pad_mask)[:, None]
            / speaking_rate
        )[:, 0]  # [B,L]

        # length regulation: repeat each text position by its duration
        # (on the host: the output length is data-dependent)
        reps = durations[0].astype(np.int64)
        gather = np.repeat(np.arange(ids.shape[1]), reps)
        if gather.size == 0:
            gather = np.zeros(1, np.int64)
        self.last_frames = int(gather.size)
        idx = torch.from_numpy(gather).to(dev)
        m_up = m_p[:, :, idx]
        logs_up = logs_p[:, :, idx]
        out_pad = torch.ones((1, 1, m_up.shape[-1]), dtype=m_up.dtype,
                             device=dev)
        if prior_noise is None:
            z = torch.randn(tuple(m_up.shape), generator=gen)
        else:
            z = torch.from_numpy(np.array(prior_noise, np.float32))
        prior = m_up + z.to(dev) * torch.exp(logs_up) * noise_scale
        latents = flow_reverse(p, cfg, prior, out_pad, cond)
        wav = hifigan(p, cfg, latents * out_pad, cond)
        return wav.float().cpu().numpy()


def param_shapes(cfg: VitsConfig) -> dict[str, tuple]:
    """HF name → shape of every tensor the inference path reads, with
    each weight-normed conv as its fused ``.weight`` (the posterior
    encoder and the duration predictor's ``post_*`` nets train only)."""
    H, half = cfg.hidden_size, cfg.flow_size // 2
    spk = cfg.speaker_embedding_size
    out: dict[str, tuple] = {"text_encoder.embed_tokens.weight":
                             (cfg.vocab_size, H)}

    def conv(name, o, i, k, bias=True):
        out[f"{name}.weight"] = (o, i, k)
        if bias:
            out[f"{name}.bias"] = (o,)

    def norm(name, n):
        out[f"{name}.weight"] = out[f"{name}.bias"] = (n,)

    for i in range(cfg.num_layers):
        pre = f"text_encoder.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{pre}.attention.{proj}.weight"] = (H, H)
            if cfg.use_bias:
                out[f"{pre}.attention.{proj}.bias"] = (H,)
        if cfg.window_size:
            for r in ("emb_rel_k", "emb_rel_v"):
                out[f"{pre}.attention.{r}"] = (
                    1, 2 * cfg.window_size + 1, H // cfg.num_heads)
        norm(f"{pre}.layer_norm", H)
        conv(f"{pre}.feed_forward.conv_1", cfg.ffn_dim, H,
             cfg.ffn_kernel_size)
        conv(f"{pre}.feed_forward.conv_2", H, cfg.ffn_dim,
             cfg.ffn_kernel_size)
        norm(f"{pre}.final_layer_norm", H)
    conv("text_encoder.project", 2 * cfg.flow_size, H, 1)
    nw = cfg.prior_encoder_num_wavenet_layers
    for i in range(cfg.prior_encoder_num_flows):
        pre = f"flow.flows.{i}"
        conv(f"{pre}.conv_pre", H, half, 1)
        for j in range(nw):
            conv(f"{pre}.wavenet.in_layers.{j}", 2 * H, H,
                 cfg.wavenet_kernel_size)
            conv(f"{pre}.wavenet.res_skip_layers.{j}",
                 2 * H if j < nw - 1 else H, H, 1)
        if spk:
            conv(f"{pre}.wavenet.cond_layer", 2 * H * nw, spk, 1)
        conv(f"{pre}.conv_post", half, H, 1)
    ch = cfg.upsample_initial_channel
    conv("decoder.conv_pre", ch, cfg.flow_size, 7)
    if spk:
        conv("decoder.cond", ch, spk, 1)
    nk = len(cfg.resblock_kernel_sizes)
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        out[f"decoder.upsampler.{i}.weight"] = (ch, ch // 2, k)
        out[f"decoder.upsampler.{i}.bias"] = (ch // 2,)
        ch //= 2
        for j, ks in enumerate(cfg.resblock_kernel_sizes):
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                for convs in ("convs1", "convs2"):
                    conv(f"decoder.resblocks.{i * nk + j}.{convs}.{c}", ch,
                         ch, ks)
    conv("decoder.conv_post", 1, ch, 7, bias=False)
    dp, k = "duration_predictor", cfg.duration_predictor_kernel_size
    if cfg.use_stochastic_duration_prediction:
        def dds(pre):
            for n in range(cfg.depth_separable_num_layers):
                conv(f"{pre}.convs_dilated.{n}", H, 1, k)
                conv(f"{pre}.convs_pointwise.{n}", H, H, 1)
                norm(f"{pre}.norms_1.{n}", H)
                norm(f"{pre}.norms_2.{n}", H)

        conv(f"{dp}.conv_pre", H, H, 1)
        conv(f"{dp}.conv_proj", H, H, 1)
        dds(f"{dp}.conv_dds")
        if spk:
            conv(f"{dp}.cond", H, spk, 1)
        dsc = cfg.depth_separable_channels
        out[f"{dp}.flows.0.translate"] = out[f"{dp}.flows.0.log_scale"] = (
            dsc, 1)
        for f in range(1, cfg.duration_predictor_num_flows + 1):
            conv(f"{dp}.flows.{f}.conv_pre", H, dsc // 2, 1)
            dds(f"{dp}.flows.{f}.conv_dds")
            conv(f"{dp}.flows.{f}.conv_proj",
                 (3 * cfg.duration_predictor_flow_bins - 1) * (dsc // 2),
                 H, 1)
    else:
        fd = cfg.duration_predictor_filter_channels
        conv(f"{dp}.conv_1", fd, H, k)
        norm(f"{dp}.norm_1", fd)
        conv(f"{dp}.conv_2", fd, fd, k)
        norm(f"{dp}.norm_2", fd)
        conv(f"{dp}.proj", 1, fd, 1)
        if spk:
            conv(f"{dp}.cond", H, spk, 1)
    if cfg.num_speakers > 1:
        out["embed_speaker.weight"] = (cfg.num_speakers, spk)
    return out


def init_params(cfg: VitsConfig, seed: int = 0,
                std: float = 0.02) -> dict[str, np.ndarray]:
    """Random float32 weights for every tensor of :func:`param_shapes`,
    drawn from a ``torch.Generator``: matrices and conv kernels N(0, std),
    biases and the duration flows' affine 0, layer-norm gains 1. A small
    ``std`` keeps a random voice's durations near one frame a symbol."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        gain = (name.endswith(".weight") and len(shape) == 1)
        if gain:
            t = torch.ones(shape)
        elif len(shape) == 1 or name.endswith(("translate", "log_scale")):
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=g) * std
        out[name] = t.numpy()
    return out


def load_hf_vits(model_dir: str | Path,
                 device: str | torch.device = "cuda") -> VitsTTS:
    """HF VitsModel checkpoint dir (config.json model_type "vits" +
    safetensors + vocab.json) → VitsTTS on ``device``, every tensor read
    as float32 by the port's safetensors reader."""
    from localai_tpu_torch.models.loader import _open_safetensors, read_tensor

    model_dir = Path(model_dir)
    hf = json.loads((model_dir / "config.json").read_text())
    tensors = {name: read_tensor(entry).float().numpy()
               for name, entry in _open_safetensors(model_dir).items()}
    return VitsTTS(VitsConfig.from_hf(hf), _P(tensors, device),
                   VitsCharTokenizer(model_dir))
