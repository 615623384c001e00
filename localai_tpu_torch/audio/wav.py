"""WAV I/O and resampling on the host.

Copy of ``localai_tpu/audio/wav.py``: the stdlib ``wave`` reader for 8-,
16- and 32-bit PCM, a mono mix-down, and ``scipy.signal.resample_poly``
(imported inside :func:`read_wav`) to the target rate; other containers
raise ``ValueError``.
"""

from __future__ import annotations

import io
import wave
from math import gcd

import numpy as np


def read_wav(data: bytes, target_rate: int = 16000) -> np.ndarray:
    """Decode wav bytes → mono float32 [-1, 1] at ``target_rate``."""
    try:
        with wave.open(io.BytesIO(data)) as w:
            rate = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
    except (wave.Error, EOFError) as e:
        raise ValueError(
            f"could not parse audio as WAV ({e}); convert to 16-bit PCM wav"
        ) from e
    if width == 2:
        x = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width: {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if rate != target_rate:
        from scipy.signal import resample_poly

        g = gcd(rate, target_rate)
        x = resample_poly(x, target_rate // g, rate // g).astype(np.float32)
    return x


def write_wav(samples: np.ndarray, rate: int = 16000) -> bytes:
    """mono float32 [-1, 1] → 16-bit PCM wav bytes."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()
