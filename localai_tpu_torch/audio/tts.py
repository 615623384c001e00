"""Built-in parametric TTS and the sound-generation entry.

Port of ``localai_tpu/audio/tts.py``: the zero-download voice, a
deterministic formant synthesiser (character classes → pitch, formant,
noise-mix and amplitude tracks on 10-ms frames → a harmonic source
coloured toward the formants, mixed with noise, smoothed and normalised)
behind ``/v1/audio/speech``, ``/tts`` and the Elevenlabs route for models
without a VITS checkpoint. The frame tracks are built in plain Python, as
in the JAX package, and padded to the same power-of-two frame buckets
(padding frames are silent and cut off after). The noise track is drawn
from a ``torch.Generator`` seeded with the JAX package's key seed (the
first four bytes of sha256(voice + text)); ``_synth`` takes it as an
argument instead for the tests. :func:`generate_sound` runs the
MusicGen-class generator (``audio.musicgen``).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import full_f32, resolve_device

RATE = 16000
FRAME = 160                      # 10 ms frames
MAX_FRAMES = 3000                # 30 s ceiling per request

_VOWELS = {
    # vowel → (F1, F2) formant pair (rough adult averages, Hz)
    "a": (800, 1200), "e": (500, 1900), "i": (320, 2300),
    "o": (500, 900), "u": (330, 800), "y": (300, 2100),
}
_VOICED = set("bdgjlmnrvwz")
_SIBILANT = set("szcfxh")


def _char_params(ch: str) -> tuple[float, float, float, int]:
    """char → (f1, f2, noise_mix, frames)."""
    c = ch.lower()
    if c in _VOWELS:
        f1, f2 = _VOWELS[c]
        return f1, f2, 0.05, 9
    if c in _SIBILANT:
        return 2500.0, 4000.0, 0.95, 6
    if c in _VOICED:
        return 300.0, 1400.0, 0.35, 6
    if c.isalpha() or c.isdigit():
        return 400.0, 1800.0, 0.6, 5
    if c in ".,;:!?":
        return 0.0, 0.0, 0.0, 12   # pause
    return 0.0, 0.0, 0.0, 6        # space/other → short pause


def _voice_seed(voice: str) -> tuple[float, float]:
    """voice name → (base pitch Hz, vibrato rate) — distinct, stable."""
    h = int.from_bytes(hashlib.sha256(voice.encode()).digest()[:4], "little")
    pitch = 95.0 + (h % 120)            # 95–215 Hz
    vib = 4.0 + (h >> 8) % 4
    return pitch, float(vib)


def _noise_seed(voice: str, text: str) -> int:
    return int.from_bytes(hashlib.sha256(
        (voice + text).encode()).digest()[:4], "little")


# The time axis and the harmonics' phase scales, rounded as XLA rounds
# the JAX package's "jnp.arange(n) / RATE" and "cumsum / RATE * 2 * pi"
# (times 1, 2, 3): a division by a constant becomes a product by its
# float32 reciprocal, and a chain of constant factors folds into one
# float32 constant, rounded at each step. The phases reach ~1e4 rad, where
# one rounding apart moves a sine by 1e-4.
_INV_RATE = float(np.float32(1 / RATE))
_PHASE = np.float32(np.float32(np.float32(1 / RATE) * 2) * np.float32(np.pi))
_PHASE_SCALES = tuple(float(np.float32(h * _PHASE)) for h in (1, 2, 3))


def _synth(f1_track, f2_track, noise_track, voiced_track, pitch_track,
           noise: torch.Tensor) -> torch.Tensor:
    """Frame tracks [n_frames] and standard-normal ``noise``
    [n_frames * FRAME] → audio [n_frames * FRAME]."""
    n = noise.shape[0]
    t = torch.arange(n, dtype=torch.float32, device=noise.device) * _INV_RATE

    def up(tr):
        return torch.repeat_interleave(tr, FRAME)

    pitch = up(pitch_track)
    cum = torch.cumsum(pitch, 0)
    # harmonic source: fundamental + 2 overtones, formant-weighted
    f1 = up(f1_track)
    f2 = up(f2_track)
    s1, s2, s3 = (torch.sin(cum * scale) for scale in _PHASE_SCALES)
    src = s1 + 0.5 * s2 + 0.25 * s3
    # crude formant colouring: ring-modulate toward the formant bands
    form = (torch.sin(2 * torch.pi * f1 * t) * 0.6
            + torch.sin(2 * torch.pi * f2 * t) * 0.4)
    voiced = src * (0.65 + 0.35 * form)
    mix = up(noise_track)
    amp = up(voiced_track)
    audio = amp * ((1 - mix) * voiced + mix * 0.5 * noise)
    # 5-ms attack/decay per frame boundary smoothing via moving average
    # (an 81-tap box, "same" length)
    kernel = torch.full((1, 1, 81), 1 / 81, device=noise.device)
    audio = F.conv1d(audio[None, None], kernel, padding=40)[0, 0]
    peak = torch.max(torch.abs(audio))
    return audio / torch.clamp(peak, min=1e-6) * 0.7


def synthesize(text: str, voice: str = "alloy", speed: float = 1.0,
               ref_audio: Optional[np.ndarray] = None, *,
               device: str | torch.device = "cuda",
               noise: Optional[np.ndarray] = None) -> np.ndarray:
    """text → mono float32 speech-like audio at 16 kHz.

    ``ref_audio`` is the parametric voice-cloning path (vall-e-x
    audio_path parity): the synthesized voice takes its pitch from the
    reference recording (audio.speaker.estimate_pitch) instead of the
    name-hash, so output prosody tracks the reference speaker. ``noise``
    replaces the seeded draw ([bucket frames * FRAME] standard normal)."""
    device = resolve_device(device)
    pitch0, vib = _voice_seed(voice or "alloy")
    if ref_audio is not None and len(ref_audio):
        from localai_tpu_torch.audio.speaker import estimate_pitch

        pitch0 = estimate_pitch(ref_audio, device=device)
    f1s, f2s, mixes, amps, pitches = [], [], [], [], []
    for i, ch in enumerate(text[:2000]):
        f1, f2, mix, frames = _char_params(ch)
        frames = max(1, int(round(frames / max(speed, 0.25))))
        silent = f1 == 0.0
        for j in range(frames):
            f1s.append(f1)
            f2s.append(f2)
            mixes.append(mix)
            amps.append(0.0 if silent else 1.0)
            # gentle declination + per-char vibrato gives sentence cadence
            frac = i / max(len(text), 1)
            pitches.append(pitch0 * (1.12 - 0.18 * frac)
                           + vib * np.sin(0.7 * i + j))
    if not f1s:
        f1s, f2s, mixes, amps, pitches = [0], [0], [0], [0], [pitch0]
    n_frames = min(len(f1s), MAX_FRAMES)
    # the JAX package's power-of-two frame buckets (amps are 0 in the
    # padding → silence)
    bucket = 64
    while bucket < n_frames:
        bucket *= 2
    bucket = min(bucket, MAX_FRAMES)

    def pad(xs):
        arr = np.zeros(bucket, np.float32)
        arr[:len(xs[:n_frames])] = xs[:n_frames]
        return torch.from_numpy(arr).to(device)

    if noise is None:
        g = torch.Generator().manual_seed(_noise_seed(voice, text))
        noise_t = torch.randn(bucket * FRAME, generator=g)
    else:
        noise_t = torch.from_numpy(np.asarray(noise, np.float32))
    with torch.inference_mode(), full_f32():
        audio = _synth(pad(f1s), pad(f2s), pad(mixes), pad(amps),
                       pad(pitches), noise_t.to(device))
    return audio.cpu().numpy()[:n_frames * FRAME]


_music_gens: dict = {}
_music_gen_lock = threading.Lock()


def generate_sound(text: str, duration: float = 3.0,
                   temperature: float = 1.0, *,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Model-generated text-conditioned audio (SoundGeneration parity —
    the reference fans out to transformers-musicgen): the MusicGen-class
    codebook LM + EnCodec decoder of ``audio.musicgen`` with its debug
    preset's seeded weights, one process-wide generator per device."""
    key = str(resolve_device(device))
    with _music_gen_lock:
        if key not in _music_gens:
            from localai_tpu_torch.audio.musicgen import MusicGenerator

            _music_gens[key] = MusicGenerator(device=key)
        gen = _music_gens[key]
    return gen.generate(text, duration, temperature)
