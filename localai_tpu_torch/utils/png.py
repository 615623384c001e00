"""PNG and APNG decoding with the stdlib's ``zlib`` and numpy, and an
8-bit RGB PNG encoder.

The counterpart of PIL's PNG reader as ``localai_tpu/utils/media.py``
reaches it (``Image.open(...).convert("RGB")``, ``seek(i)`` for the frames
of an animation): the card's machine has no PIL, so the port decodes
PNGs itself, byte for byte as PIL 12 does.

  * Colour types 0/2/3/4/6 at bit depths 1/2/4/8/16, PLTE and tRNS,
    Adam7 interlace and the five row filters. The filters run over
    every row at once on a skewed copy of the image (pixel (y, x) at
    column x + y), so each step of the recurrence is one vectorised
    column: the left, upper and upper-left neighbours of every pixel of a
    column are in the two columns before it.
  * The image is kept in PIL's mode for it ("1", "L", "I;16", "P", "RGB",
    "LA", "RGBA") and turned into RGB as PIL's ``convert("RGB")`` does:
    alpha is dropped, not composited; 16-bit colour keeps the high byte of
    each sample (PIL's ``RGB;16B`` / ``RGBA;16B`` / ``LA;16B`` raw modes),
    16-bit grey is clipped to 255 (PIL's ``I;16`` to RGB); 1/2/4-bit grey
    is scaled to 0..255; palette indices past the PLTE are black.
  * APNG (``acTL``/``fcTL``/``fdAT``): frames composed as PIL's ``seek()``
    composes them — dispose ops none/background/previous applied before
    the next frame, blend op source, or over, which is PIL's
    ``paste(frame, box, mask)`` with the frame's alpha as the weight of
    every channel (``BLEND`` of ``libImaging/Paste.c``), alpha included.

:func:`encode` writes what the image endpoint returns (the counterpart of
PIL's ``Image.fromarray(rgb).save(buf, "PNG")``): 8-bit RGB, no
interlace, every row with the Sub filter, one zlib stream at level 6 in
one IDAT. Its bytes are not PIL's (PIL chooses filters and chunking of
its own); its pixels, read back by PIL or by :func:`decode`, are the
array's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL refuses an image of more than twice Image.MAX_IMAGE_PIXELS as a
# decompression bomb; so do the port's readers (png, jpeg, gif)
MAX_PIXELS = 2 * 89478485


def check_size(width: int, height: int) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"image size ({width}x{height}) exceeds the limit "
                         f"of {MAX_PIXELS} pixels (decompression bomb)")

# (bit depth, colour type) -> PIL mode, as PIL's PngImagePlugin._MODES
_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB",
    (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA",
    (8, 6): "RGBA", (16, 6): "RGBA",
}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# APNG dispose and blend ops
_DISPOSE_BACKGROUND, _DISPOSE_PREVIOUS = 1, 2
_BLEND_OVER = 1


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """[rows, 1 + rowbytes] filtered scanlines → [rows, rowbytes] bytes.

    Pixel (y, x) of a [H, U, bpp] view lives at column x + y of a skewed
    array, so its left (a), upper (b) and upper-left (c) neighbours are
    in the two columns before it and one column step reconstructs a whole
    anti-diagonal: U + H vectorised steps instead of H x U scalar ones."""
    ftype = raw[:, 0]
    filt = raw[:, 1:]
    if not ftype.any():
        return filt.copy()
    if int(ftype.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    H, rowbytes = filt.shape
    U = rowbytes // bpp
    f = filt.reshape(H, U, bpp).astype(np.int16)
    fsk = np.zeros((H, U + H, bpp), np.int16)
    for y in range(H):
        fsk[y, y:y + U] = f[y]
    sk = np.zeros((H + 1, U + H + 1, bpp), np.int16)
    t = ftype.astype(np.int16)[:, None]
    for j in range(U + H - 1):
        y0, y1 = max(0, j - U + 1), min(H - 1, j)
        a = sk[y0 + 1:y1 + 2, j]
        b = sk[y0:y1 + 1, j]
        c = sk[y0:y1 + 1, j - 1] if j else np.zeros_like(b)
        tt = t[y0:y1 + 1]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(tt == 1, a, np.where(
            tt == 2, b, np.where(tt == 3, (a + b) >> 1,
                                 np.where(tt == 4, paeth, 0))))
        sk[y0 + 1:y1 + 2, j + 1] = (fsk[y0:y1 + 1, j] + pred) & 255
    out = np.empty((H, U, bpp), np.uint8)
    for y in range(H):
        out[y] = sk[y + 1, y + 1:y + 1 + U]
    return out.reshape(H, rowbytes)


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered [h, rowbytes] bytes → [h, width, channels] samples
    (uint8, or uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        bits = np.unpackbits(rows, axis=1)
        per = 8 // depth
        n = rows.shape[1] * per
        bits = bits.reshape(h, n, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(axis=2).astype(np.uint8)
    return s[:, :width * channels].reshape(h, width, channels)


class _Header:
    def __init__(self, ihdr: bytes):
        if len(ihdr) < 13:
            raise ValueError("truncated IHDR chunk")
        (self.width, self.height, self.depth, self.ctype, comp, filt,
         self.interlace) = struct.unpack(">IIBBBBB", ihdr[:13])
        if (self.depth, self.ctype) not in _MODES:
            raise ValueError(f"unsupported PNG bit depth {self.depth} with "
                             f"colour type {self.ctype}")
        if filt:
            raise ValueError("unknown filter category")
        if comp:
            raise ValueError("unknown compression method")
        check_size(self.width, self.height)
        self.mode = _MODES[(self.depth, self.ctype)]
        self.channels = _CHANNELS[self.ctype]


def _to_mode(s: np.ndarray, hdr: _Header) -> np.ndarray:
    """Samples → the PIL mode's pixel values (PIL's raw-mode unpacking)."""
    d, ct = hdr.depth, hdr.ctype
    if ct == 0:
        g = s[..., 0]
        if d == 16:
            return g.astype(np.uint16)
        if d == 1:
            return (g * 255).astype(np.uint8)
        return (g * (255 // ((1 << d) - 1))).astype(np.uint8)
    if ct == 3:
        return s[..., 0].astype(np.uint8)
    hi = (s >> 8).astype(np.uint8) if d == 16 else s
    if ct == 4 and d == 16:   # LA;16B unpacks into RGBA as (L, L, L, A)
        return np.stack([hi[..., 0]] * 3 + [hi[..., 1]], axis=-1)
    return hi


def _decode_image(zdata: bytes, hdr: _Header, width: int,
                  height: int) -> np.ndarray:
    """One (sub)image's zlib stream → its PIL-mode array [h, w(, c)]."""
    try:
        raw = zlib.decompressobj().decompress(zdata)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    bits = hdr.channels * hdr.depth
    bpp = max(1, bits // 8)
    passes = (_ADAM7 if hdr.interlace else ((0, 0, 1, 1),))
    dtype = np.uint16 if hdr.depth == 16 else np.uint8
    out = np.zeros((height, width, hdr.channels), dtype)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if not pw or not ph:
            continue
        rowbytes = (pw * bits + 7) // 8
        n = (rowbytes + 1) * ph
        if pos + n > len(raw):
            raise ValueError("image file is truncated")
        rows = np.frombuffer(raw, np.uint8, n, pos).reshape(ph, rowbytes + 1)
        pos += n
        s = _samples(_unfilter(rows, bpp), pw, hdr.depth, hdr.channels)
        out[y0::dy, x0::dx] = s
    return _to_mode(out, hdr)


class PNGImage:
    """A parsed PNG: ``n_frames`` and ``frames()``, the RGB frames as
    PIL's ``seek(i)`` + ``convert("RGB")`` give them."""

    def __init__(self, data: bytes):
        if not data.startswith(SIGNATURE):
            raise ValueError("not a PNG file")
        self.hdr: Optional[_Header] = None
        self.palette = np.zeros((256, 3), np.uint8)
        self.trns: Optional[bytes] = None
        self.idat: list[bytes] = []
        self.num_frames: Optional[int] = None
        # APNG: [(fcTL fields, [data chunks])]; a default image (IDAT
        # before any fcTL) is not one of them
        self.anim: list[tuple[tuple, list[bytes]]] = []
        self.default_image = False
        pos, seen_fctl = 8, False
        while pos + 8 <= len(data):
            length, cid = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            if len(body) < length:
                raise ValueError("truncated PNG chunk "
                                 f"{cid.decode('latin-1')!r}")
            if cid not in (b"IDAT", b"fdAT"):
                crc = data[pos + 8 + length:pos + 12 + length]
                if len(crc) == 4 and struct.unpack(">I", crc)[0] != \
                        zlib.crc32(cid + body):
                    raise ValueError("broken PNG file (bad header checksum "
                                     f"in {cid!r})")
            pos += 12 + length
            if cid == b"IHDR":
                self.hdr = _Header(body)
            elif cid == b"PLTE":
                n = min(256, len(body) // 3)
                self.palette[:n] = np.frombuffer(body, np.uint8, n * 3
                                                 ).reshape(n, 3)
            elif cid == b"tRNS":
                self.trns = body
            elif cid == b"acTL":
                n = struct.unpack(">I", body[:4])[0] if len(body) >= 4 else 0
                if 0 < n <= 0x80000000:
                    self.num_frames = n
            elif cid == b"fcTL":
                if len(body) < 26:
                    raise ValueError("APNG contains truncated fcTL chunk")
                seen_fctl = True
                w, h, x, y = struct.unpack(">IIII", body[4:20])
                self.anim.append(((w, h, x, y, body[24], body[25]), []))
            elif cid == b"IDAT":
                self.idat.append(body)
                if self.num_frames is not None and seen_fctl and \
                        len(self.anim) == 1:
                    self.anim[0][1].append(body)
                elif self.num_frames is not None and not seen_fctl:
                    self.default_image = True
            elif cid == b"fdAT":
                if self.anim:
                    self.anim[-1][1].append(body[4:])
            elif cid == b"IEND":
                break
        if self.hdr is None:
            raise ValueError("PNG has no IHDR chunk")
        if not self.idat:
            raise ValueError("PNG has no image data")
        self.mode = self.hdr.mode
        if self.num_frames is None:
            self.n_frames = 1
        else:
            self.n_frames = self.num_frames + (1 if self.default_image else 0)

    # -- pixels ----------------------------------------------------------

    def to_rgb(self, px: np.ndarray) -> np.ndarray:
        """A PIL-mode array → RGB uint8 [H, W, 3] (PIL's convert("RGB"))."""
        m = self.mode
        if m in ("1", "L"):
            return np.repeat(px[..., None], 3, axis=2)
        if m == "I;16":
            g = np.minimum(px, 255).astype(np.uint8)
            return np.repeat(g[..., None], 3, axis=2)
        if m == "P":
            return self.palette[px]
        if m == "LA":
            return np.repeat(px[..., :1], 3, axis=2)
        return px[..., :3].copy()

    def _alpha(self, px: np.ndarray) -> Optional[np.ndarray]:
        """The weight PIL's APNG blend-over pastes a frame with (its
        ``mask``'s alpha), or None where PIL's mask is opaque."""
        m = self.mode
        if m in ("RGBA", "LA"):
            return px[..., -1]
        if m == "RGB" and self.trns is not None and len(self.trns) >= 6:
            key = struct.unpack(">HHH", self.trns[:6])
            hit = ((px[..., 0] == key[0]) & (px[..., 1] == key[1])
                   & (px[..., 2] == key[2]))
            return np.where(hit, 0, 255).astype(np.uint8)
        if m == "P" and self.trns is not None:
            lut = np.full(256, 255, np.uint8)
            t = np.frombuffer(self.trns[:256], np.uint8)
            lut[:len(t)] = t
            return lut[px]
        return None

    def _blank(self, h: int, w: int) -> np.ndarray:
        c = {"RGB": 3, "RGBA": 4, "LA": 2}.get(self.mode)
        dtype = np.uint16 if self.mode == "I;16" else np.uint8
        return np.zeros((h, w) + ((c,) if c else ()), dtype)

    def frames(self) -> Iterator[np.ndarray]:
        """RGB frames in order, composed as PIL's ``seek()`` does."""
        hdr = self.hdr
        W, H = hdr.width, hdr.height
        if self.num_frames is None:
            yield self.to_rgb(_decode_image(b"".join(self.idat), hdr, W, H))
            return
        entries: list[tuple[Optional[tuple], list[bytes]]] = []
        if self.default_image:
            entries.append((None, self.idat))
        entries.extend(self.anim)
        canvas = None
        dispose = dispose_box = None
        for f in range(self.n_frames):
            if f >= len(entries) or not entries[f][1]:
                raise ValueError("no more images in APNG file")
            ctl, chunks = entries[f]
            if ctl is None:
                box, dop, bop = (0, 0, W, H), None, None
            else:
                w, h, x, y, dop, bop = ctl
                if x + w > W or y + h > H:
                    raise ValueError("APNG contains invalid frames")
                box = (x, y, x + w, y + h)
            prev = None
            if f:
                if dispose is not None:
                    x0, y0, x1, y1 = dispose_box
                    canvas[y0:y1, x0:x1] = dispose
                prev = canvas.copy()
            dispose_box = box
            if prev is None and dop == _DISPOSE_PREVIOUS:
                dop = _DISPOSE_BACKGROUND
            x0, y0, x1, y1 = box
            dispose = None
            if dop == _DISPOSE_PREVIOUS:
                dispose = prev[y0:y1, x0:x1].copy()
            elif dop == _DISPOSE_BACKGROUND:
                dispose = self._blank(y1 - y0, x1 - x0)
            if canvas is None:
                canvas = self._blank(H, W)
            canvas[y0:y1, x0:x1] = _decode_image(b"".join(chunks), hdr,
                                                 x1 - x0, y1 - y0)
            if prev is not None and bop == _BLEND_OVER:
                new = canvas[y0:y1, x0:x1]
                alpha = self._alpha(new)
                if alpha is not None:
                    old = prev[y0:y1, x0:x1].astype(np.int32)
                    m = alpha.astype(np.int32)
                    if old.ndim == 3:
                        m = m[..., None]
                    # libImaging/Paste.c BLEND: DIV255(out*(255-m) + in*m)
                    tmp = old * (255 - m) + new.astype(np.int32) * m + 128
                    prev[y0:y1, x0:x1] = (((tmp >> 8) + tmp) >> 8).astype(
                        prev.dtype)
                else:
                    prev[y0:y1, x0:x1] = new
                canvas = prev
            yield self.to_rgb(canvas)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes → RGB uint8 [H, W, 3]: the first frame, as PIL's
    ``Image.open(...).convert("RGB")``."""
    return next(PNGImage(data).frames())


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(rgb: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] → PNG bytes (8-bit RGB, the Sub filter)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes uint8 [H, W, 3], not {rgb.dtype} "
                         f"{list(rgb.shape)}")
    h, w = rgb.shape[:2]
    if h < 1 or w < 1:
        raise ValueError(f"cannot encode an empty {w}x{h} image")
    rows = rgb.reshape(h, w * 3)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]            # Sub: each byte minus its left
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
