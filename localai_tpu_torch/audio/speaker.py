"""Speaker encoder and pitch estimation — the voice-cloning front end.

Port of ``localai_tpu/audio/speaker.py``. Two conditioning signals come
from a reference recording:

  * ``SpeakerEncoder.embed`` — an identity embedding from engineered
    voice features: the voiced autocorrelation pitch profile over the
    60–400 Hz lag band and log-mel envelope statistics, a seeded linear
    projection, L2-normalised, over a fixed 3-s window. ``load`` replaces
    the projection with trained weights (npz, key ``proj``).
  * ``estimate_pitch`` — median F0 by frame autocorrelation, with which
    the parametric synthesiser matches a reference speaker's pitch.

``project`` maps the embedding onto a checkpoint's
``speaker_embedding_size`` with a fixed seeded projection
(:meth:`SpeakerEncoder.projection`), so any multi-speaker VITS checkpoint
accepts cloned voices. Both projections are drawn from
``torch.Generator``s seeded as the JAX package seeds its keys (0 and
1234): the same seeds, other numbers.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from localai_tpu_torch.audio.mel import HOP, N_FFT, frame_power, mel_filterbank
from localai_tpu_torch.utils.device import full_f32, resolve_device

RATE = 16000
N_MELS = 40
WINDOW_S = 3.0                      # reference window (pad/truncate)
FRAMES = int(WINDOW_S * RATE) // HOP

_AC_FRAME = 640   # 40 ms pitch-analysis frames
_AC_HOP = 320
_AC_LO = RATE // 400   # 60–400 Hz lag band
_AC_HI = RATE // 60


def _frame_mels(audio: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """audio [WINDOW samples] → log-mel [FRAMES, N_MELS]."""
    mel = frame_power(audio, FRAMES) @ filters.T
    return torch.log10(torch.clamp(mel, min=1e-10))


def _autocorr(audio: torch.Tensor) -> torch.Tensor:
    """Normalised autocorrelation of 40-ms frames every 20 ms,
    [n_frames, _AC_FRAME] (lag 0 = 1)."""
    frames = audio.unfold(0, _AC_FRAME, _AC_HOP)
    frames = frames[:(audio.shape[0] - _AC_FRAME) // _AC_HOP]
    frames = frames - frames.mean(dim=1, keepdim=True)
    spec = torch.fft.rfft(frames, n=2 * _AC_FRAME, dim=1)
    ac = torch.fft.irfft(spec * torch.conj(spec), dim=1)[:, :_AC_FRAME]
    return ac / torch.clamp(ac[:, :1], min=1e-8)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-8)


class SpeakerEncoder:
    """Reference waveform → L2-normalized identity embedding [dim], on
    ``device``."""

    def __init__(self, dim: int = 192, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self.filters = torch.from_numpy(
            mel_filterbank(n_mels=N_MELS, n_fft=N_FFT, rate=RATE)
        ).to(self.device)
        feat = (_AC_HI - _AC_LO) + 2 * N_MELS
        g = torch.Generator().manual_seed(seed)
        self.params = {
            "proj": (torch.randn((dim, feat), generator=g)
                     / np.sqrt(feat)).to(self.device),
        }

    def load(self, path) -> None:
        """Load trained projection weights (npz with key 'proj')."""
        with np.load(path) as z:
            self.params = {k: torch.from_numpy(np.asarray(z[k], np.float32))
                           .to(self.device) for k in z.files}

    def _embed(self, audio: torch.Tensor, length: int) -> torch.Tensor:
        # --- pitch profile: voiced-frame mean autocorrelation band ------
        ac = _autocorr(audio)
        n_ac = ac.shape[0]
        band = ac[:, _AC_LO:_AC_HI]                    # [n_ac, lags]
        ends = torch.arange(n_ac, device=audio.device) * _AC_HOP + _AC_FRAME
        voiced = (band.max(dim=1).values > 0.3) & (ends <= length)
        w = voiced[:, None].float()
        profile = _unit((band * w).sum(0) / torch.clamp(w.sum(), min=1.0))

        # --- spectral envelope statistics -------------------------------
        mels = _frame_mels(audio, self.filters)        # [FRAMES, M]
        n_frames = min(length // HOP + 1, FRAMES)
        valid = (torch.arange(FRAMES, device=audio.device)
                 < n_frames)[:, None].float()
        denom = torch.clamp(valid.sum(), min=1.0)
        mean = (mels * valid).sum(0) / denom
        var = ((mels - mean) ** 2 * valid).sum(0) / denom
        stats = _unit(torch.cat([mean, torch.sqrt(var + 1e-8)]))

        # pitch dominates (it is the stronger untrained cue)
        feats = torch.cat([2.0 * profile, stats])
        return _unit(self.params["proj"] @ feats)

    def embed(self, audio: np.ndarray) -> np.ndarray:
        """audio float32 @16 kHz (any length) → [dim] unit vector."""
        n = int(WINDOW_S * RATE)
        buf = np.zeros(n, np.float32)
        a = np.asarray(audio, np.float32)[:n]
        buf[: len(a)] = a
        with torch.inference_mode(), full_f32():
            out = self._embed(torch.from_numpy(buf).to(self.device),
                              min(len(a), n))
        return out.cpu().numpy()

    def projection(self, size: int) -> np.ndarray:
        """The fixed [size, dim] map of :meth:`project` (seed 1234)."""
        g = torch.Generator().manual_seed(1234)
        return (torch.randn((size, self.dim), generator=g)
                / np.sqrt(self.dim)).numpy()

    def project(self, emb: np.ndarray, size: int) -> np.ndarray:
        """Map [dim] → [size] with a fixed seeded projection (so any
        multi-speaker VITS checkpoint accepts cloned embeddings)."""
        if size == self.dim:
            return emb
        out = self.projection(size) @ emb
        return (out / max(np.linalg.norm(out), 1e-8)).astype(np.float32)


def _autocorr_pitch(audio: torch.Tensor) -> float:
    """Median frame F0 (Hz) over voiced frames via autocorrelation."""
    band = _autocorr(audio)[:, _AC_LO:_AC_HI]           # 60–400 Hz band
    strength, lag = band.max(dim=1)
    f0 = RATE / (lag + _AC_LO).float()
    voiced = strength > 0.3
    count = int(voiced.sum())
    if count == 0:                  # no voiced frame: 140 Hz
        return 140.0
    # the lower median of the voiced frames
    return float(torch.sort(f0[voiced]).values[(count - 1) // 2])


def estimate_pitch(audio: np.ndarray,
                   device: str | torch.device = "cuda") -> float:
    """Median F0 (Hz) of a reference recording (60–400 Hz band)."""
    a = np.asarray(audio, np.float32)
    if len(a) < 1600:
        return 140.0
    buf = np.zeros(RATE * 10, np.float32)   # the JAX package's 10-s frame
    a = a[: RATE * 10]
    buf[: len(a)] = a
    with torch.inference_mode(), full_f32():
        return _autocorr_pitch(
            torch.from_numpy(buf).to(resolve_device(device)))


_encoders: dict[str, SpeakerEncoder] = {}
_encoder_lock = threading.Lock()


def get_speaker_encoder(device: str | torch.device = "cuda"
                        ) -> SpeakerEncoder:
    """The process-wide encoder of ``device`` (weights are deterministic
    by seed, so all callers agree on the embedding space)."""
    key = str(resolve_device(device))
    with _encoder_lock:
        if key not in _encoders:
            _encoders[key] = SpeakerEncoder(device=key)
        return _encoders[key]
