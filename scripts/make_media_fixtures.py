"""Write the media fixtures ``chip_smoke.py``'s media and LLaVA phases
read (the card's machine has no PIL, so the reference decodes are made
here and committed beside the files).

    python3 scripts/make_media_fixtures.py [--out tests/data/media]

Pictures are drawn from seeded numpy arrays (smooth colour fields with a
few hard-edged shapes, so the files compress), encoded by PIL, and
decoded by PIL as the JAX package decodes them (``convert("RGB")``; a
GIF's frames by ``seek(i)``). Each reference decode is written as a PNG
(``<name>.ref.png``; a GIF's frames stacked top to bottom), which the
port's PNG reader decodes byte for byte as PIL does. Re-running with the
same Pillow and libjpeg-turbo gives the same bytes.

  photo.jpg         640x480 baseline JPEG, 4:2:0, quality 90
  progressive.jpg   800x600 progressive JPEG, 4:2:0, quality 85
  rgba.png          512x512 RGBA PNG
  video.gif         256x256, 4 frames (sent as a video_url)
"""

from __future__ import annotations

import argparse
import io
from pathlib import Path

import numpy as np
from PIL import Image


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded [h, w, 3] uint8 picture with hard-edged shapes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    out = np.empty((h, w, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.5, 3.0, 3)
        out[..., c] = 128 + 90 * np.sin(2 * np.pi * (fx * x + ph)) * \
            np.cos(2 * np.pi * fy * y) + 30 * (x - y)
    for _ in range(6):
        x0, y0 = rng.integers(0, w - w // 6), rng.integers(0, h - h // 6)
        out[y0:y0 + h // 6, x0:x0 + w // 6] = rng.integers(0, 256, 3)
    return np.clip(out, 0, 255).astype(np.uint8)


def encode(img: Image.Image, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def fixtures() -> dict[str, bytes]:
    rgba = np.concatenate([picture(512, 512, 3), np.broadcast_to(
        np.linspace(40, 255, 512).astype(np.uint8)[None, :, None],
        (512, 512, 1))], axis=2)
    frames = []
    for i in range(4):
        a = picture(256, 256, 4)
        a[40 + 30 * i:100 + 30 * i, 60:140] = (250, 40, 40)
        frames.append(Image.fromarray(a).quantize(64))
    return {
        "photo.jpg": encode(Image.fromarray(picture(480, 640, 1)), "JPEG",
                            quality=90, subsampling=2),
        "progressive.jpg": encode(Image.fromarray(picture(600, 800, 2)),
                                  "JPEG", quality=85, subsampling=2,
                                  progressive=True),
        "rgba.png": encode(Image.fromarray(rgba, "RGBA"), "PNG"),
        "video.gif": encode(frames[0], "GIF", save_all=True,
                            append_images=frames[1:], duration=100, loop=0),
    }


def reference(data: bytes) -> np.ndarray:
    """PIL's decode: RGB, a GIF's frames stacked top to bottom."""
    im = Image.open(io.BytesIO(data))
    frames = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB"), np.uint8))
    return np.concatenate(frames, axis=0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1]
                                         / "tests" / "data" / "media"))
    out = Path(ap.parse_args().out)
    out.mkdir(parents=True, exist_ok=True)
    total = 0
    for name, data in fixtures().items():
        ref = encode(Image.fromarray(reference(data)), "PNG", optimize=True)
        (out / name).write_bytes(data)
        (out / (name + ".ref.png")).write_bytes(ref)
        total += len(data) + len(ref)
        print(f"{name}: {len(data)} bytes, reference {len(ref)} bytes")
    print(f"total {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
