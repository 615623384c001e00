"""MusicGen-class generative audio: codebook LM + EnCodec SEANet decoder.

Port of ``localai_tpu/audio/musicgen.py`` (the reference's
transformers-musicgen backend):

  * ``lm_forward`` — MusicGen's decoder LM (transformers
    ``MusicgenForCausalLM``): K codebook embeddings summed, sinusoidal
    positions, pre-LN self + cross attention layers (bias-free
    projections), K lm heads.
  * ``generate_codes`` — the delay-pattern sampler (codebook k trails k
    steps) with a per-layer KV cache, as a host loop of ``frames + K``
    steps. The JAX package scans a power-of-two bucket of frames to reuse
    compiled programs; a step depends on earlier steps alone, so the
    port runs the frames asked for and the codes are the same. Top-k
    sampling draws from a ``torch.Generator``; ``temperature <= 0`` is
    greedy.
  * ``encodec_decode`` — EnCodec's RVQ codebook sum + SEANet decoder
    (causal convs with reflect padding, a stacked LSTM with a residual,
    transposed-conv upsampling, residual blocks).

The debug preset draws its weights from a ``torch.Generator``; the
``*_from_torch`` adapters carry a transformers state dict (or the JAX
package's tree, through ``from_numpy``) across. Float32 with TF32 off on
the card (``utils.device.full_f32``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import full_f32, resolve_device

Params = Any


@dataclasses.dataclass(frozen=True)
class MusicgenConfig:
    vocab_size: int = 64          # per-codebook acoustic vocab
    num_codebooks: int = 4
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 2
    ffn_dim: int = 128
    max_positions: int = 2048
    # EnCodec decoder side
    codebook_dim: int = 32
    num_filters: int = 8
    upsampling_ratios: tuple = (8, 5, 4)   # 160× → 100 Hz frames @16 kHz
    num_residual_layers: int = 1
    num_lstm_layers: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    sampling_rate: int = 16000

    @property
    def pad_id(self) -> int:  # BOS/PAD sentinel (embed tables have V+1 rows)
        return self.vocab_size

    @property
    def frame_rate(self) -> float:
        return self.sampling_rate / math.prod(self.upsampling_ratios)


# ---------------------------------------------------------------------------
# LM building blocks (MusicgenForCausalLM parity)


def _ln(x, p):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-5) * p["w"] + p["b"]


def sinusoidal_positions(n: int, dim: int,
                         device: str | torch.device = "cpu") -> torch.Tensor:
    """[n, dim] — tensor2tensor layout: [cos | sin] halves (matches
    MusicgenSinusoidalPositionalEmbedding.get_embedding)."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / (half - 1)))
    ang = torch.arange(n, dtype=torch.float32,
                       device=device)[:, None] * freq[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros((n, 1), device=device)], dim=1)
    return emb


def _gelu(x):
    return F.gelu(x)   # exact, as the JAX package's approximate=False


def _mha(q_x, kv_x, p, heads: int, mask=None):
    """Bias-free multi-head attention (MusicgenAttention)."""
    D = q_x.shape[-1]
    hd = D // heads
    q = (q_x @ p["q"].T) * (hd ** -0.5)
    k = kv_x @ p["k"].T
    v = kv_x @ p["v"].T

    def split(t):
        return t.reshape(*t.shape[:-1], heads, hd)

    scores = torch.einsum("qhd,khd->hqk", split(q), split(k))
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, split(v)).reshape(
        q_x.shape[0], D)
    return out @ p["o"].T


def lm_forward(cfg: MusicgenConfig, params: Params, codes: torch.Tensor,
               memory: Optional[torch.Tensor] = None,
               offset: int = 0) -> torch.Tensor:
    """Teacher-forced decoder pass. codes [K, T] (pad_id = BOS) →
    logits [K, T, V]. ``memory`` [S, D] enables cross-attention."""
    T = codes.shape[1]
    dev = codes.device
    x = sum(params["embed"][k][codes[k]] for k in range(cfg.num_codebooks))
    x = x + sinusoidal_positions(offset + T, cfg.hidden_size, dev)[offset:]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
    for lp in params["layers"]:
        h = _ln(x, lp["ln1"])
        x = x + _mha(h, h, lp["self"], cfg.num_heads, causal)
        if memory is not None:
            h = _ln(x, lp["ln2"])
            x = x + _mha(h, memory, lp["cross"], cfg.num_heads)
        h = _ln(x, lp["ln3"])
        x = x + _gelu(h @ lp["fc1"].T) @ lp["fc2"].T
    x = _ln(x, params["final_ln"])
    return torch.stack([x @ params["heads"][k].T
                        for k in range(cfg.num_codebooks)])


# ---------------------------------------------------------------------------
# Delay-pattern generation (host loop, explicit KV cache)


def generate_codes(cfg: MusicgenConfig, params: Params,
                   memory: torch.Tensor, *, frames: int,
                   temperature: float = 1.0, top_k: int = 64,
                   memory_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Sample [K, frames] acoustic codes with MusicGen's delay pattern
    (codebook k trails k steps; BOS until a codebook's first frame).

    ``temperature <= 0`` is greedy; above it, top-``top_k`` sampling from
    ``generator`` (on the memory's device). ``memory_mask`` [S] marks
    real rows when the conditioning memory is padded."""
    K, D = cfg.num_codebooks, cfg.hidden_size
    heads = cfg.num_heads
    hd = D // heads
    dev = memory.device
    T_total = frames + K
    pos_tab = sinusoidal_positions(T_total, D, dev)
    scale = hd ** -0.5
    layers = params["layers"]

    # cross-attention K/V precomputed once per layer
    cross_kv = [((memory @ lp["cross"]["k"].T).reshape(-1, heads, hd),
                 (memory @ lp["cross"]["v"].T).reshape(-1, heads, hd))
                for lp in layers]
    keep = None if memory_mask is None else memory_mask[None, None, :]
    kc = torch.zeros((len(layers), T_total, heads, hd), device=dev)
    vc = torch.zeros_like(kc)
    kk = min(top_k, cfg.vocab_size)
    temp = float(temperature)
    delay = torch.arange(K, device=dev)
    tok_col = torch.full((K,), cfg.pad_id, dtype=torch.long, device=dev)
    cols = []
    for t in range(T_total):
        x = sum(params["embed"][k][tok_col[k]] for k in range(K)) + pos_tab[t]
        x = x[None]  # [1, D]
        for li, lp in enumerate(layers):
            h = _ln(x, lp["ln1"])
            q = (h @ lp["self"]["q"].T).reshape(1, heads, hd) * scale
            kc[li, t] = (h @ lp["self"]["k"].T).reshape(heads, hd)
            vc[li, t] = (h @ lp["self"]["v"].T).reshape(heads, hd)
            scores = torch.einsum("qhd,khd->hqk", q, kc[li, :t + 1])
            probs = torch.softmax(scores, -1)
            att = torch.einsum("hqk,khd->qhd", probs,
                               vc[li, :t + 1]).reshape(1, D)
            x = x + att @ lp["self"]["o"].T
            # cross-attention
            h = _ln(x, lp["ln2"])
            qc = (h @ lp["cross"]["q"].T).reshape(1, heads, hd) * scale
            ck, cv = cross_kv[li]
            cs = torch.einsum("qhd,khd->hqk", qc, ck)
            if keep is not None:
                cs = torch.where(keep, cs, -1e30)
            catt = torch.einsum("hqk,khd->qhd", torch.softmax(cs, -1),
                                cv).reshape(1, D)
            x = x + catt @ lp["cross"]["o"].T
            h = _ln(x, lp["ln3"])
            x = x + _gelu(h @ lp["fc1"].T) @ lp["fc2"].T
        x = _ln(x, params["final_ln"])[0]
        logits = torch.stack([x @ params["heads"][k].T for k in range(K)])
        if temp <= 0:
            sampled = torch.argmax(logits, dim=-1)
        else:
            vals_k, idx_k = torch.topk(logits / max(temp, 1e-6), kk)
            choice = torch.multinomial(torch.softmax(vals_k, -1), 1,
                                       generator=generator)
            sampled = torch.gather(idx_k, 1, choice)[:, 0]
        cols.append(sampled)
        # delay pattern: codebook k stays BOS until step t+1 > k
        tok_col = torch.where(t + 1 > delay, sampled, cfg.pad_id)
    cols_t = torch.stack(cols)  # [T_total, K] — sampled at each step
    # un-delay: codebook k's frame f was sampled at step f + k
    f_idx = torch.arange(frames, device=dev)
    codes = torch.stack([cols_t[f_idx + k, k] for k in range(K)])
    return torch.clamp(codes, 0, cfg.vocab_size - 1)


# ---------------------------------------------------------------------------
# EnCodec decoder (SEANet) — EncodecModel.decode parity


def _causal_conv1d(x, w, b, stride: int = 1, dilation: int = 1):
    """x [C, T] with EnCodec causal reflect padding; w [out, in, k]."""
    k = w.shape[-1]
    pad_total = (k - 1) * dilation + 1 - stride
    length = x.shape[-1]
    n_frames = (length - ((k - 1) * dilation + 1) + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + ((k - 1) * dilation + 1) \
        - pad_total
    extra = ideal - length
    # reflect needs width > pad; EnCodec zero-extends first in that case
    if length <= pad_total:
        x = F.pad(x, (0, pad_total - length + 1))
    if pad_total > 0:
        x = F.pad(x[None], (pad_total, 0), mode="reflect")[0]
    if extra > 0:
        x = F.pad(x, (0, extra))
    return F.conv1d(x[None], w, b, stride=stride, dilation=dilation)[0]


def _conv_transpose1d(x, w, b, stride: int):
    """torch ConvTranspose1d (padding=0) + EnCodec causal right-trim.
    w torch layout [in, out, k]."""
    k = w.shape[-1]
    out = F.conv_transpose1d(x[None], w, b, stride=stride)[0]
    pad_total = k - stride
    right = math.ceil(pad_total * 1.0)  # trim_right_ratio = 1.0 (causal)
    left = pad_total - right
    return out[:, left: out.shape[-1] - right]


def _lstm_stack(x, layers):
    """EncodecLSTM: stacked torch-layout LSTM over time + residual.
    x [C, T] → [C, T]."""
    h_seq = x.T  # [T, C]
    for wi, wh, bi, bh in layers:  # [4H, in], [4H, H], [4H], [4H]
        H = wh.shape[1]
        gx = h_seq @ wi.T + bi          # the input projection, all steps
        h = torch.zeros(H, device=x.device)
        c = torch.zeros(H, device=x.device)
        out = []
        for t in range(h_seq.shape[0]):
            g = gx[t] + (wh @ h + bh)
            i, f, gg, o = torch.chunk(g, 4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        h_seq = torch.stack(out)
    return x + h_seq.T


def encodec_decode(cfg: MusicgenConfig, dparams: Params,
                   codes: torch.Tensor) -> torch.Tensor:
    """RVQ codes [K, T] → waveform [T × prod(ratios)] float32 mono."""
    emb = sum(dparams["codebooks"][k][codes[k]]
              for k in range(cfg.num_codebooks))   # [T, codebook_dim]
    x = emb.T  # [C, T]
    x = _causal_conv1d(x, *dparams["conv_in"])
    x = _lstm_stack(x, dparams["lstm"])
    for up in dparams["ups"]:
        x = F.elu(x)
        x = _conv_transpose1d(x, up["w"], up["b"], up["stride"])
        for rb in up["res"]:
            y = F.elu(x)
            y = _causal_conv1d(y, *rb["c1"], dilation=rb["dilation"])
            y = F.elu(y)
            y = _causal_conv1d(y, *rb["c2"])
            sc = rb.get("shortcut")
            x = (x if sc is None else _causal_conv1d(x, *sc)) + y
    x = F.elu(x)
    x = _causal_conv1d(x, *dparams["conv_out"])
    return x[0]


# ---------------------------------------------------------------------------
# Weight adapters (torch state_dict → param trees)


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float().to(device)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def from_numpy(tree: Any, device: str | torch.device = "cuda") -> Params:
    """The JAX package's lm or decoder tree (numpy arrays, ints kept) as
    float32 tensors on ``device``."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        if isinstance(a, int):
            return a
        return _tensor(a, device)

    return conv(tree)


def lm_params_from_torch(state: dict, cfg: MusicgenConfig,
                         device: str | torch.device = "cuda") -> Params:
    """transformers MusicgenForCausalLM state_dict → lm param tree."""
    device = resolve_device(device)

    def g(n):
        return _tensor(state[n], device)

    def attn(p, block):
        return {"q": g(p + f"{block}.q_proj.weight"),
                "k": g(p + f"{block}.k_proj.weight"),
                "v": g(p + f"{block}.v_proj.weight"),
                "o": g(p + f"{block}.out_proj.weight")}

    def ln(p, name):
        return {"w": g(p + f"{name}.weight"), "b": g(p + f"{name}.bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        layers.append({
            "self": attn(p, "self_attn"), "cross": attn(p, "encoder_attn"),
            "ln1": ln(p, "self_attn_layer_norm"),
            "ln2": ln(p, "encoder_attn_layer_norm"),
            "ln3": ln(p, "final_layer_norm"),
            "fc1": g(p + "fc1.weight"),
            "fc2": g(p + "fc2.weight"),
        })
    return {
        "embed": [g(f"model.decoder.embed_tokens.{k}.weight")
                  for k in range(cfg.num_codebooks)],
        "heads": [g(f"lm_heads.{k}.weight")
                  for k in range(cfg.num_codebooks)],
        "final_ln": ln("model.decoder.", "layer_norm"),
        "layers": layers,
    }


def _fold_weight_norm(state: dict, prefix: str, device):
    """weight_norm(v, g): w = g · v / ‖v‖ over (in, k) per out channel
    (the JAX package's numpy float32 formula)."""
    def arr(n):
        a = state[n]
        return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a, np.float32))

    g0 = arr(prefix + ".parametrizations.weight.original0")
    v = arr(prefix + ".parametrizations.weight.original1")
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    w = g0 * v / np.maximum(norm, 1e-12)
    return _tensor(w, device), _tensor(arr(prefix + ".bias"), device)


def encodec_params_from_torch(state: dict, cfg: MusicgenConfig,
                              device: str | torch.device = "cuda"
                              ) -> Params:
    """transformers EncodecModel state_dict → SEANet decoder tree.

    Layer indices follow EncodecDecoder's ModuleList layout: conv_in=0,
    lstm=1, then per ratio [ELU, convtranspose, res×R], final [ELU, conv]."""
    device = resolve_device(device)
    idx = 0
    out: dict = {}
    out["codebooks"] = [
        _tensor(state[f"quantizer.layers.{k}.codebook.embed"], device)
        for k in range(cfg.num_codebooks)
    ]
    out["conv_in"] = _fold_weight_norm(state, f"decoder.layers.{idx}.conv",
                                       device)
    idx += 1
    out["lstm"] = [
        tuple(_tensor(state[f"decoder.layers.{idx}.lstm.{n}_l{li}"], device)
              for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        for li in range(cfg.num_lstm_layers)
    ]
    idx += 1
    ups = []
    for ratio in cfg.upsampling_ratios:
        idx += 1  # ELU
        w, b = _fold_weight_norm(state, f"decoder.layers.{idx}.conv",
                                 device)
        idx += 1
        res = []
        for j in range(cfg.num_residual_layers):
            p = f"decoder.layers.{idx}"
            rb = {"c1": _fold_weight_norm(state, p + ".block.1.conv", device),
                  "c2": _fold_weight_norm(state, p + ".block.3.conv", device),
                  "dilation": cfg.dilation_growth_rate ** j}
            if f"{p}.shortcut.conv.bias" in state:
                rb["shortcut"] = _fold_weight_norm(
                    state, p + ".shortcut.conv", device)
            res.append(rb)
            idx += 1
        ups.append({"w": w, "b": b, "stride": ratio, "res": res})
    idx += 1  # final ELU
    out["ups"] = ups
    out["conv_out"] = _fold_weight_norm(state, f"decoder.layers.{idx}.conv",
                                        device)
    return out


# ---------------------------------------------------------------------------
# Random init (debug preset) + serving entry


def init_params(cfg: MusicgenConfig, seed: int = 0,
                device: str | torch.device = "cuda"
                ) -> tuple[Params, Params]:
    """(lm_params, decoder_params) with random weights in the JAX
    package's scheme (its per-tensor scales), drawn on the CPU from a
    ``torch.Generator`` and moved — the zero-download serving preset."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def w(shape, scale=0.08):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    D, F_, K, V = (cfg.hidden_size, cfg.ffn_dim, cfg.num_codebooks,
                   cfg.vocab_size)

    def ln():
        return {"w": torch.ones(D, device=device), "b": zeros(D)}

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "self": {c: w((D, D)) for c in "qkvo"},
            "cross": {c: w((D, D)) for c in "qkvo"},
            "ln1": ln(), "ln2": ln(), "ln3": ln(),
            "fc1": w((F_, D)), "fc2": w((D, F_)),
        })
    lm = {
        "embed": [w((V + 1, D)) for _ in range(K)],
        "heads": [w((V, D)) for _ in range(K)],
        "final_ln": ln(),
        "layers": layers,
    }

    C = cfg.codebook_dim
    ch = 2 ** len(cfg.upsampling_ratios) * cfg.num_filters
    dec: dict = {
        "codebooks": [w((V, C), 0.5) for _ in range(K)],
        "conv_in": (w((ch, C, cfg.kernel_size), 0.2), zeros(ch)),
        "lstm": [
            tuple(w(s, 0.15) for s in
                  ((4 * ch, ch), (4 * ch, ch), (4 * ch,), (4 * ch,)))
            for _ in range(cfg.num_lstm_layers)
        ],
    }
    ups = []
    for ratio in cfg.upsampling_ratios:
        nxt = ch // 2
        hidden = nxt // cfg.compress
        res = []
        for j in range(cfg.num_residual_layers):
            res.append({
                "c1": (w((hidden, nxt, cfg.residual_kernel_size), 0.2),
                       zeros(hidden)),
                "c2": (w((nxt, hidden, 1), 0.2), zeros(nxt)),
                "dilation": cfg.dilation_growth_rate ** j,
                "shortcut": (w((nxt, nxt, 1), 0.2), zeros(nxt)),
            })
        ups.append({"w": w((ch, nxt, ratio * 2), 0.2), "b": zeros(nxt),
                    "stride": ratio, "res": res})
        ch = nxt
    dec["ups"] = ups
    dec["conv_out"] = (w((1, cfg.num_filters, cfg.last_kernel_size), 0.3),
                       zeros(1))
    return lm, dec


def _text_seed(text: str) -> int:
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:4],
                          "little")


class MusicGenerator:
    """Text-conditioned audio generation (SoundGeneration parity engine)
    on ``device``.

    Conditioning: UTF-8 bytes → learned byte embeddings + sinusoidal
    positions form the cross-attention memory (the debug-preset stand-in
    for MusicGen's T5 encoder; a loaded checkpoint can supply its own
    memory via ``generate(memory=...)``)."""

    def __init__(self, cfg: Optional[MusicgenConfig] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or MusicgenConfig()
        self.device = resolve_device(device)
        self.lm, self.dec = init_params(self.cfg, seed, self.device)
        gen = torch.Generator().manual_seed(seed + 1)
        self.text_embed = (torch.randn((256, self.cfg.hidden_size),
                                       generator=gen) * 0.3).to(self.device)

    def text_memory(self, text: str, max_len: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(memory [max_len, D], mask [max_len]): the text's bytes padded
        to ``max_len`` rows, the padding masked out."""
        ids = np.frombuffer(text.encode()[:max_len], np.uint8)
        if not len(ids):
            ids = np.zeros(1, np.uint8)
        padded = np.zeros(max_len, np.int64)
        padded[: len(ids)] = ids
        mem = self.text_embed[torch.from_numpy(padded).to(self.device)]
        mem = mem + sinusoidal_positions(max_len, self.cfg.hidden_size,
                                         self.device)
        return mem, torch.arange(max_len, device=self.device) < len(ids)

    def generate_codes(self, text: str, duration: float = 3.0,
                       temperature: float = 1.0,
                       memory: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """[K, frames] codes for ``duration`` seconds (0.25–30) of
        ``text``; sampling seeded by the text (the JAX package's seed)."""
        cfg = self.cfg
        frames = int(min(max(duration, 0.25), 30.0) * cfg.frame_rate)
        if memory is None:
            memory, mask = self.text_memory(text)
        else:
            mask = None
        gen = torch.Generator(device=self.device).manual_seed(
            _text_seed(text))
        with torch.inference_mode(), full_f32():
            return generate_codes(
                cfg, self.lm, memory, frames=frames,
                temperature=max(float(temperature), 0.0),
                memory_mask=mask, generator=gen)

    def decode(self, codes: torch.Tensor) -> np.ndarray:
        """Codes → waveform, peak-normalised to 0.7."""
        with torch.inference_mode(), full_f32():
            audio = encodec_decode(self.cfg, self.dec, codes)
        audio = audio.float().cpu().numpy()
        peak = np.abs(audio).max()
        return (audio / max(peak, 1e-6) * 0.7).astype(np.float32)

    def generate(self, text: str, duration: float = 3.0,
                 temperature: float = 1.0,
                 memory: Optional[torch.Tensor] = None) -> np.ndarray:
        return self.decode(self.generate_codes(text, duration, temperature,
                                               memory))
