"""Whisper's log-mel spectrogram frontend in torch.

Port of ``localai_tpu/audio/mel.py``: frame, periodic Hann window, rFFT
(``torch.fft.rfft``), power, slaney mel projection, log10 clamped at the
chunk's max − 8, then ``(x + 4) / 4``. Constants are OpenAI whisper's
(n_fft 400, hop 160 at 16 kHz, 3000 frames a 30-s chunk); ``n_mels`` is
an argument (80, or 128 for large-v3). The filterbank is built in numpy
on the host, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30
CHUNK_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS
CHUNK_FRAMES = CHUNK_SAMPLES // HOP  # 3000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney scale (librosa default, what whisper uses)."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_step = np.log(6.4) / 27.0
    brk = 1000.0
    brk_mel = brk / (200.0 / 3)
    safe = np.maximum(f, 1e-10)
    return np.where(f >= brk, brk_mel + np.log(safe / brk) / log_step, mel)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    log_step = np.log(6.4) / 27.0
    brk_mel = 15.0
    f = m * (200.0 / 3)
    return np.where(m >= brk_mel, 1000.0 * np.exp(log_step * (m - brk_mel)), f)


def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   rate: int = SAMPLE_RATE) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular filters."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(0.0)),
                          _hz_to_mel(np.array(rate / 2.0)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def hann_window(n: int, device: torch.device) -> torch.Tensor:
    """Periodic Hann (``torch.hann_window``'s default, what whisper was
    trained with), computed as the JAX package computes it."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * torch.pi * k / n))


def frame_power(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """audio [S] → |rfft|² of ``n_frames`` reflect-padded, Hann-windowed
    frames, [n_frames, N_FFT//2 + 1]."""
    pad = N_FFT // 2
    x = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP)[:n_frames]
    frames = frames * hann_window(N_FFT, audio.device)[None, :]
    return torch.fft.rfft(frames, dim=-1).abs() ** 2


def log_mel(audio: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """audio [CHUNK_SAMPLES] f32 → log-mel [n_mels, CHUNK_FRAMES], with
    ``n_mels`` the filterbank's rows."""
    power = frame_power(audio, CHUNK_FRAMES)        # [frames, n_freqs]
    mel = power @ filters.T                          # [frames, n_mels]
    logspec = torch.log10(torch.clamp(mel, min=1e-10))
    logspec = torch.maximum(logspec, logspec.max() - 8.0)
    logspec = (logspec + 4.0) / 4.0
    return logspec.T                                 # [n_mels, frames]


def chunk_audio(audio: np.ndarray) -> list[np.ndarray]:
    """Split/pad into 30-s chunks (whisper's fixed receptive field)."""
    chunks = []
    for off in range(0, max(len(audio), 1), CHUNK_SAMPLES):
        c = audio[off:off + CHUNK_SAMPLES]
        if len(c) < CHUNK_SAMPLES:
            c = np.pad(c, (0, CHUNK_SAMPLES - len(c)))
        chunks.append(c.astype(np.float32))
    return chunks
