"""GIF decoding in the stdlib and numpy.

The counterpart of PIL 12's GIF reader as ``localai_tpu/utils/media.py``
reaches it: ``Image.open(...).convert("RGB")`` for an image and
``seek(i)`` + ``convert("RGB")`` for the frames of an animation. GIF87a
and GIF89a, LZW, global and local palettes, interlaced frames, the
graphic control extension's transparency and disposal 0-3.

Frames are composed as PIL's ``GifImagePlugin`` composes them under its
default ``RGB_AFTER_FIRST`` strategy, quirks included:

  * frame 0 stays a palette image ("P"), or greyscale ("L") when there is
    no palette or it is the identity grey ramp; its transparent index,
    when it has one, fills the canvas before the frame is drawn;
  * from frame 1 on a palette image turns RGB (RGBA with frame 0's
    transparency, whose index becomes alpha 0), and each frame is drawn
    on a canvas of its own palette, turned into RGB(A) and pasted into
    its rectangle, its transparent pixels keeping what was there;
  * a greyscale animation draws every frame in place, skipping its
    transparent pixels;
  * the disposal method persists from the last frame that named one;
    disposal 2 fills the rectangle with the transparent colour (alpha 0),
    else the background index; disposal 3 restores the rectangle as it
    was before the frame;
  * a frame reaching past the logical screen enlarges the image.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

from localai_tpu_torch.utils.png import check_size


def _lzw(data: bytes, min_size: int, npix: int) -> bytes:
    """GIF LZW codes (LSB-first, variable width up to 12 bits) → up to
    ``npix`` indices; stops early at the end code or the data's end."""
    if not 0 < min_size <= 11:
        raise ValueError(f"bad LZW code size {min_size}")
    clear = 1 << min_size
    eoi = clear + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_size + 1
    mask = (1 << size) - 1
    out = bytearray()
    prev = None
    buf = nbits = pos = 0
    n = len(data)
    while len(out) < npix:
        while nbits < size:
            if pos >= n:
                return bytes(out)
            buf |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = buf & mask
        buf >>= size
        nbits -= size
        if code == clear:
            table = list(base)
            size = min_size + 1
            mask = (1 << size) - 1
            prev = None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt GIF image data (bad LZW code)")
        out += entry
        prev = entry
        if len(table) == 1 << size and size < 12:
            size += 1
            mask = (1 << size) - 1
    return bytes(out[:npix])


def _identity_grey(p: bytes) -> bool:
    """PIL's ``not _is_palette_needed``: every entry i is (i, i, i)."""
    return all(i // 3 == p[i] == p[i + 1] == p[i + 2]
               for i in range(0, len(p), 3))


def _palette(p: bytes) -> np.ndarray:
    """Palette bytes → [256, 3] uint8, entries past the table black."""
    out = np.zeros((256, 3), np.uint8)
    n = min(256, len(p) // 3)
    out[:n] = np.frombuffer(p, np.uint8, n * 3).reshape(n, 3)
    return out


class _Frame:
    __slots__ = ("box", "palette", "transparency", "disposal", "interlace",
                 "min_size", "data")


class GIFImage:
    """A parsed GIF: ``n_frames`` and ``frames()``, the RGB frames as
    PIL's ``seek(i)`` + ``convert("RGB")`` give them."""

    def __init__(self, data: bytes):
        if len(data) < 13 or not data.startswith((b"GIF87a", b"GIF89a")):
            raise ValueError("not a GIF file")
        self.size = struct.unpack("<HH", data[6:10])
        flags = data[10]
        pos = 13
        self.global_palette: Optional[bytes] = None
        self.background: Optional[int] = None
        if flags & 128:
            self.background = data[11]
            p = data[pos:pos + (3 << ((flags & 7) + 1))]
            pos += len(p)
            if not _identity_grey(p):
                self.global_palette = p
        self.frames_: list[_Frame] = []
        disposal = 0
        transparency = None
        while pos < len(data):
            tag = data[pos]
            pos += 1
            if tag == 0x3B:  # trailer
                break
            if tag == 0x21:  # extension
                label = data[pos]
                pos += 1
                first = True
                while pos < len(data) and data[pos]:
                    block = data[pos + 1:pos + 1 + data[pos]]
                    pos += 1 + data[pos]
                    if first and label == 0xF9 and len(block) >= 4:
                        if block[0] & 1:
                            transparency = block[3]
                        bits = (block[0] & 0b00011100) >> 2
                        if bits:  # PIL keeps the last method named
                            disposal = bits
                    first = False
                pos += 1
                continue
            if tag != 0x2C:
                # PIL stops at a byte that starts no block
                break
            if pos + 9 > len(data):
                raise ValueError("truncated GIF image descriptor")
            x0, y0, w, h = struct.unpack("<HHHH", data[pos:pos + 8])
            check_size(max(x0 + w, self.size[0]), max(y0 + h, self.size[1]))
            fl = data[pos + 8]
            pos += 9
            fr = _Frame()
            fr.box = (x0, y0, x0 + w, y0 + h)
            fr.interlace = bool(fl & 64)
            fr.palette = None
            if fl & 128:
                p = data[pos:pos + (3 << ((fl & 7) + 1))]
                pos += len(p)
                fr.palette = False if _identity_grey(p) else p
            if pos >= len(data):
                raise ValueError("truncated GIF image data")
            fr.min_size = data[pos]
            pos += 1
            chunks = []
            while pos < len(data) and data[pos]:
                chunks.append(data[pos + 1:pos + 1 + data[pos]])
                pos += 1 + data[pos]
            pos += 1
            fr.data = b"".join(chunks)
            fr.transparency = transparency
            fr.disposal = disposal
            self.frames_.append(fr)
            transparency = None
        if not self.frames_:
            raise ValueError("image not found in GIF frame")
        self.n_frames = len(self.frames_)

    @staticmethod
    def _draw(canvas: np.ndarray, fr: _Frame, skip: Optional[int]) -> None:
        """Decode ``fr`` into its rectangle of a 2-D index canvas,
        leaving pixels equal to ``skip`` (and any not in the data) as
        they were."""
        x0, y0, x1, y1 = fr.box
        w, h = x1 - x0, y1 - y0
        if not w or not h:
            return
        idx = np.frombuffer(_lzw(fr.data, fr.min_size, w * h), np.uint8)
        if fr.interlace:
            order = np.concatenate([np.arange(s, h, d) for s, d in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])
        else:
            order = np.arange(h)
        k = np.arange(len(idx))
        ys, xs = order[k // w] + y0, k % w + x0
        if skip is not None:
            keep = idx != skip
            ys, xs, idx = ys[keep], xs[keep], idx[keep]
        canvas[ys, xs] = idx

    def frames(self) -> Iterator[np.ndarray]:
        """RGB frames in order, composed as PIL's ``seek()`` does."""
        W, H = self.size
        mode = None
        canvas = pal = None          # the current image, its palette
        transparency_info = None     # PIL's info["transparency"]
        dispose = dispose_box = None
        for f, fr in enumerate(self.frames_):
            x0, y0, x1, y1 = fr.box
            if x1 > W or y1 > H:
                W, H = max(x1, W), max(y1, H)
            if dispose is not None:
                bx0, by0, bx1, by1 = dispose_box
                if canvas.ndim == 3:
                    c = min(canvas.shape[2], dispose.shape[2])
                    canvas[by0:by1, bx0:bx1, :c] = dispose[..., :c]
                else:
                    canvas[by0:by1, bx0:bx1] = dispose
            fpal = fr.palette if fr.palette is not None \
                else self.global_palette
            t = fr.transparency
            if f == 0:
                mode = "P" if fpal else "L"
                pal = _palette(fpal) if fpal else None
            elif mode == "P":
                rgb = pal[canvas]
                if transparency_info is not None:
                    a = np.where(canvas == transparency_info, 0, 255)
                    canvas = np.concatenate(
                        [rgb, a[..., None].astype(np.uint8)], axis=2)
                    mode = "RGBA"
                    transparency_info = None
                else:
                    canvas, mode = rgb, "RGB"

            def rgb_of(color: int) -> tuple:
                if fpal:
                    if color * 3 + 3 > len(fpal):
                        color = 0
                    return tuple(fpal[color * 3:color * 3 + 3])
                return (color, color, color)

            dispose_box = fr.box
            dispose = None
            dh, dw = y1 - y0, x1 - x0
            if fr.disposal == 2:
                color = transparency_info if transparency_info is not None \
                    else t
                if color is not None:
                    fill = (rgb_of(color) + (0,) if mode in ("RGB", "RGBA")
                            else color)
                else:
                    color = self.background or 0
                    fill = (rgb_of(color) if mode in ("RGB", "RGBA")
                            else color)
                dispose = np.empty((dh, dw) + ((len(fill),) if isinstance(
                    fill, tuple) else ()), np.uint8)
                dispose[...] = fill
            elif fr.disposal == 3:
                if canvas is not None:
                    dispose = canvas[y0:y1, x0:x1].copy()
                elif t is not None:
                    fill = rgb_of(t) + (0,) if mode in ("RGB", "RGBA") else t
                    dispose = np.empty((dh, dw) + ((len(fill),) if isinstance(
                        fill, tuple) else ()), np.uint8)
                    dispose[...] = fill
            if f == 0:
                canvas = np.full((H, W), t if t is not None else 0, np.uint8)
                if t is not None:
                    transparency_info = t
                self._draw(canvas, fr, None)
            elif mode in ("RGB", "RGBA"):
                frame = np.full((H, W), t or 0, np.uint8)
                self._draw(frame, fr, None)
                if canvas.shape[:2] != (H, W):
                    grown = np.zeros((H, W, 4 if t is not None else 3),
                                     np.uint8)
                    if t is None and fpal:
                        grown[...] = _palette(fpal)[0]
                    ch = min(grown.shape[2], canvas.shape[2])
                    grown[:canvas.shape[0], :canvas.shape[1], :ch] = \
                        canvas[..., :ch]
                    canvas = grown
                    mode = "RGBA" if grown.shape[2] == 4 else "RGB"
                part = frame[y0:y1, x0:x1]
                src = (_palette(fpal)[part] if fpal
                       else np.repeat(part[..., None], 3, axis=2))
                dst = canvas[y0:y1, x0:x1]
                # PIL pastes with the frame's alpha (0 or 255) as the mask:
                # a select
                sel = part != t if t is not None else np.ones(part.shape,
                                                              bool)
                dst[..., :3][sel] = src[sel]
                if dst.shape[2] == 4:
                    dst[..., 3][sel] = 255
            else:  # a greyscale (or palette-less) animation draws in place
                if canvas.shape != (H, W):
                    grown = np.zeros((H, W), np.uint8)
                    grown[:canvas.shape[0], :canvas.shape[1]] = canvas
                    canvas = grown
                self._draw(canvas, fr, t)
            if mode == "P":
                yield pal[canvas]
            elif mode == "L":
                yield np.repeat(canvas[..., None], 3, axis=2)
            else:
                yield canvas[..., :3].copy()


def decode(data: bytes) -> np.ndarray:
    """GIF bytes → RGB uint8 [H, W, 3]: the first frame, as PIL's
    ``Image.open(...).convert("RGB")``."""
    return next(GIFImage(data).frames())
