"""Media ingestion for multimodal chat: image_url / video_url parts → RGB
arrays.

Port of ``localai_tpu/utils/media.py``: the same reference forms (http(s)
URLs, data URIs, raw base64), size limit, frame sampling and messages.
The JAX package decodes with PIL; the card's machine has none, so the
port decodes with its own stdlib + numpy readers — ``utils/png.py`` (PNG,
APNG), ``utils/jpeg.py`` and ``utils/gif.py`` — chosen by the data's
magic bytes. Any other format raises :class:`MediaError` naming it (the
API answers 400): WebP, TIFF, BMP, ICO, and video containers (mp4/mov,
webm/mkv), some of which PIL decodes for the JAX package.
"""

from __future__ import annotations

import base64
import binascii
import logging
import re
import struct

import numpy as np

from localai_tpu_torch.utils import gif, jpeg, png

log = logging.getLogger(__name__)

MAX_IMAGE_BYTES = 32 * 1024 * 1024
_DATA_URI = re.compile(r"^data:[a-zA-Z0-9.+/-]+;base64,(?P<b64>.+)$", re.S)


class MediaError(ValueError):
    """Raised when an image reference cannot be fetched or decoded."""


def fetch_image_bytes(ref: str, *, timeout: float = 30.0,
                      kind: str = "image") -> bytes:
    """image/video_url string → raw encoded bytes: http(s) fetch,
    data-URI strip, or raw base64 decode. ``kind`` only flavours error
    messages, so a bad video_url is not reported as an image."""
    ref = ref.strip()
    m = _DATA_URI.match(ref)
    if m:
        try:
            return base64.b64decode(m.group("b64"), validate=False)
        except (binascii.Error, ValueError) as e:
            raise MediaError(f"invalid base64 data URI: {e}") from e
    if ref.startswith(("http://", "https://")):
        import urllib.request

        req = urllib.request.Request(ref, headers={"User-Agent": "localai-tpu"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = resp.read(MAX_IMAGE_BYTES + 1)
        except Exception as e:  # noqa: BLE001 — network errors → request error
            raise MediaError(f"failed to fetch {kind} URL: {e}") from e
        if len(data) > MAX_IMAGE_BYTES:
            raise MediaError(f"{kind} exceeds size limit")
        return data
    # raw base64 (no scheme, no data: header)
    try:
        return base64.b64decode(ref, validate=True)
    except (binascii.Error, ValueError) as e:
        raise MediaError(
            f"{kind}_url is neither an http(s) URL, data URI, nor base64"
        ) from e


def sniff(data: bytes) -> str:
    """The container format named by the data's magic bytes."""
    if data.startswith(png.SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data.startswith((b"GIF87a", b"GIF89a")):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in (b"II*\0", b"MM\0*"):
        return "TIFF"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"\0\0\1\0", b"\0\0\2\0"):
        return "ICO"
    if data[4:8] == b"ftyp":
        return "MP4/MOV video"
    if data[:4] == b"\x1aE\xdf\xa3":
        return "WebM/Matroska video"
    return ""


# still images by format, and the formats that may hold an animation
_DECODERS = {"PNG": png.decode, "JPEG": jpeg.decode, "GIF": gif.decode}
_ANIMATED = {"PNG": png.PNGImage, "GIF": gif.GIFImage}


def _format(data: bytes) -> str:
    fmt = sniff(data)
    if fmt in _DECODERS:
        return fmt
    if fmt:
        raise ValueError(f"{fmt} is not supported by this server (PNG, "
                         "APNG, JPEG and GIF are)")
    raise ValueError("cannot identify image file")


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes → RGB uint8 array [H, W, 3] (the first frame
    of an animation)."""
    try:
        return _DECODERS[_format(data)](data)
    except (ValueError, IndexError, struct.error) as e:
        raise MediaError(f"cannot decode image: {e}") from e


def fetch_image(ref: str, *, timeout: float = 30.0) -> np.ndarray:
    return decode_image(fetch_image_bytes(ref, timeout=timeout))


def decode_video_frames(data: bytes, max_frames: int = 8) -> list[np.ndarray]:
    """Encoded multi-frame media (animated GIF / APNG) → up to
    ``max_frames`` uniformly-sampled RGB uint8 frames [H, W, 3]."""
    try:
        fmt = _format(data)
        if fmt not in _ANIMATED:
            return [_DECODERS[fmt](data)]
        r = _ANIMATED[fmt](data)
        n = r.n_frames
        if n <= 1:
            return [next(r.frames())]
        count = min(max_frames, n)
        idxs = {round(i * (n - 1) / max(count - 1, 1)) for i in range(count)}
        frames = []
        for i, frame in enumerate(r.frames()):
            if i in idxs:
                frames.append(frame)
            if i >= max(idxs):
                break
        return frames
    except (ValueError, IndexError, struct.error) as e:
        raise MediaError(
            f"cannot decode video: {e} (supported: animated GIF/APNG; "
            "compressed containers like mp4 require a codec stack not "
            "available here)"
        ) from e


def fetch_video_frames(ref: str, *, timeout: float = 30.0,
                       max_frames: int = 8) -> list[np.ndarray]:
    """video_url string → sampled RGB frames (same ref forms as images)."""
    return decode_video_frames(
        fetch_image_bytes(ref, timeout=timeout, kind="video"),
        max_frames=max_frames)
