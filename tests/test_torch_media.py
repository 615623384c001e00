"""The PyTorch port's image decoders and media ingestion against the JAX
package's (PIL 12) on the CPU.

Images are made from seeded numpy arrays (gradients, edges, noise) and
encoded by PIL, or, for what PIL cannot write (every PNG bit depth and
colour type, Adam7, all five row filters; JPEG 4:4:0), by the small
encoders below. Each file is decoded by the JAX package's
``utils.media.decode_image`` / ``decode_video_frames`` (PIL) and by the
port's. PNG, APNG and GIF must agree byte for byte, and so must the
bicubic resize; JPEG within max |diff| <= 2 and mean <= 0.25 per
channel (the port implements libjpeg-turbo's integer IDCT, fancy
upsampling and colour tables, so it is expected to be exact, and 4:4:4
is asserted exact). Then the reference forms of ``fetch_image_bytes``
(data URI, raw base64, an http URL from a local stdlib server) with the
JAX package's errors, and the formats the port refuses, each named.
"""

import base64
import http.server
import io
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.utils import media as jmedia  # noqa: E402
from localai_tpu_torch.utils import gif as tgif  # noqa: E402
from localai_tpu_torch.utils import jpeg as tjpeg  # noqa: E402
from localai_tpu_torch.utils import media as tmedia  # noqa: E402
from localai_tpu_torch.utils import png as tpng  # noqa: E402
from localai_tpu_torch.utils.resample import resize  # noqa: E402

# JPEG: libjpeg-turbo's decode within these (a reimplementation may
# round differently by a step in the upsampler or the colour tables)
JPEG_MAX, JPEG_MEAN = 2, 0.25


def picture(h: int, w: int, kind: str, seed: int = 0) -> np.ndarray:
    """A seeded [h, w, 3] uint8 picture: a gradient, edges, or noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "grad":
        a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                      (x + y) * 127 // max(w + h - 2, 1)], -1)
    elif kind == "edge":
        a = np.stack([((x // 5 + y // 7) % 2) * 255, (x * 3) % 256,
                      ((y // 3) % 2) * 200], -1)
    else:
        a = rng.integers(0, 256, (h, w, 3))
    return a.astype(np.uint8)


def pil_bytes(img, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        b, fmt, **kw)
    return b.getvalue()


def same_image(data: bytes) -> None:
    ref = jmedia.decode_image(data)
    got = tmedia.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def same_frames(data: bytes, max_frames: int = 8) -> list:
    ref = jmedia.decode_video_frames(data, max_frames=max_frames)
    got = tmedia.decode_video_frames(data, max_frames=max_frames)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    return got


# ---------------------------------------------------------------------------
# PNG: a writer for every depth, colour type, filter and Adam7

def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Scanlines with a random filter type each (0-4)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        t = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if t == 1:
            r2 = r - a
        elif t == 2:
            r2 = r - b
        elif t == 3:
            r2 = r - ((a + b) >> 1)
        elif t == 4:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            r2 = r - np.where((pa <= pb) & (pa <= pc), a,
                              np.where(pb <= pc, b, c))
        else:
            r2 = r
        out.append(bytes([t]) + bytes((r2 & 255).astype(np.uint8)))
        prev = r
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, -n % per), samples.dtype)],
                       1).reshape(h, -1, per)
    v = np.zeros(s.shape[:2], np.int64)
    for i in range(per):
        v = (v << depth) | s[:, :, i]
    return v.astype(np.uint8)


def png_bytes(img: np.ndarray, depth: int, ctype: int, *, seed: int = 0,
              interlace: bool = False, extra: bytes = b"") -> bytes:
    """[h, w, channels] samples → a PNG with random row filters."""
    rng = np.random.default_rng(seed)
    h, w = img.shape[:2]
    bpp = max(1, img.shape[2] * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (tpng._ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth),
                                bpp, rng)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (tpng.SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,ctype", sorted(tpng._MODES))
def test_png_every_depth_and_colour_type_equals_pil(depth, ctype, interlace,
                                                    trns):
    rng = np.random.default_rng(depth * 10 + ctype)
    ch = tpng._CHANNELS[ctype]
    for h, w in ((1, 1), (13, 29), (40, 9)):
        img = rng.integers(0, 1 << depth, (h, w, ch))
        extra = b""
        if ctype == 3:
            n = int(rng.integers(1, min(256, 1 << depth) + 1))
            extra += _chunk(b"PLTE", rng.integers(0, 256, 3 * n).astype(
                np.uint8).tobytes())
            if trns:
                extra += _chunk(b"tRNS", rng.integers(
                    0, 256, int(rng.integers(1, n + 1))).astype(
                        np.uint8).tobytes())
        elif trns and ctype in (0, 2):
            extra += _chunk(b"tRNS", struct.pack(
                ">" + "H" * ch, *[int(v) for v in img[0, 0]]))
        same_image(png_bytes(img, depth, ctype, seed=h, interlace=interlace,
                             extra=extra))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_png_written_by_pil_equals_pil(mode):
    img = Image.fromarray(picture(37, 23, "edge"))
    if mode == "P":
        img = img.quantize(37)
    elif mode == "I;16":
        px = picture(37, 23, "grad")[..., 0].astype("<u2") * 7
        img = Image.frombytes("I;16", (23, 37), px.tobytes())
    else:
        img = img.convert(mode)
    same_image(pil_bytes(img, "PNG"))
    same_image(pil_bytes(img, "PNG", optimize=True))


def _apng(mode: str, seed: int, *, default_image: bool = False,
          transparency=None):
    rng = np.random.default_rng(seed)
    h, w, n = 21, 17, 5
    frames = []
    for i in range(n):
        a = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        a[..., 3] = rng.choice([0, 7, 128, 255], (h, w))
        if i:   # a shared half makes PIL write a sub-rectangle frame
            a[:h // 2] = np.asarray(frames[-1].convert("RGBA"))[:h // 2]
        im = Image.fromarray(a, "RGBA")
        frames.append(im.convert("RGB").quantize(16) if mode == "P"
                      else im.convert(mode))
    # PIL writes dispose op 1 (background, which op 2 on the first frame
    # becomes) for RGB(A) frames only
    ops = (0, 1, 2) if mode in ("RGB", "RGBA", "LA") else (0, 2)
    disposal = [int(rng.choice(ops)) for _ in range(n)]
    if mode in ("L", "P"):
        disposal[0] = 0
    kw = dict(save_all=True, append_images=frames[1:], disposal=disposal,
              blend=[int(rng.integers(0, 2)) for _ in range(n)],
              default_image=default_image)
    if transparency is not None:
        kw["transparency"] = transparency
    return pil_bytes(frames[0], "PNG", **kw)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode,extra", [
    ("RGBA", {}), ("RGBA", {"default_image": True}), ("RGB", {}),
    ("RGB", {"transparency": (0, 0, 0)}), ("LA", {}), ("L", {}),
    ("P", {"transparency": 3})])
def test_apng_frames_equal_pil(mode, extra, seed):
    """Dispose ops 0-2 and blend ops source/over, as PIL's seek()
    composes them; the first frame alone and up to 8 sampled frames."""
    data = _apng(mode, seed, **extra)
    same_image(data)
    same_frames(data)
    same_frames(data, max_frames=3)
    # every frame, not only the sampled ones
    ref = Image.open(io.BytesIO(data))
    for i, frame in enumerate(tpng.PNGImage(data).frames()):
        ref.seek(i)
        np.testing.assert_array_equal(frame,
                                      np.asarray(ref.convert("RGB")))


# ---------------------------------------------------------------------------
# GIF

def _gif(mode: str, seed: int, n: int, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    frames = []
    for i in range(n):
        a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        if i and seed % 2:
            a[:h // 2] = np.asarray(frames[-1].convert("RGB"))[:h // 2]
        im = Image.fromarray(a)
        if mode == "P":
            im = im.quantize(int(rng.integers(2, 200)))
        elif mode == "L":
            im = im.convert("L")
        elif mode == "RGBA":
            im = Image.fromarray(np.concatenate(
                [a, rng.choice([0, 255], (h, w, 1)).astype(np.uint8)], 2),
                "RGBA")
        frames.append(im)
    disposal = [int(rng.integers(0, 4)) for _ in range(n)]
    return pil_bytes(frames[0], "GIF", save_all=True,
                     append_images=frames[1:],
                     disposal=disposal if n > 1 else disposal[0],
                     interlace=bool(seed % 2), optimize=bool(seed % 3 == 0),
                     **kw)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode,kw", [
    ("P", {}), ("P", {"transparency": 2}), ("P", {"background": 3}),
    ("L", {}), ("L", {"transparency": 1}), ("RGB", {}), ("RGBA", {})])
@pytest.mark.parametrize("n", [1, 5])
def test_gif_frames_equal_pil(mode, kw, n, seed):
    """Static and animated GIFs: global and local palettes (each frame
    quantized apart), interlace, disposal 0-3, transparency."""
    data = _gif(mode, seed, n, **kw)
    same_image(data)
    same_frames(data)
    ref = Image.open(io.BytesIO(data))
    for i, frame in enumerate(tgif.GIFImage(data).frames()):
        ref.seek(i)
        np.testing.assert_array_equal(frame,
                                      np.asarray(ref.convert("RGB")))


def test_gif_sampled_frames_follow_the_reference_schedule():
    """12 frames, max 8: round(i * 11 / 7) as the JAX package picks."""
    frames = [Image.fromarray(np.full((4, 4, 3), 20 * i, np.uint8))
              for i in range(12)]
    data = pil_bytes(frames[0], "GIF", save_all=True,
                     append_images=frames[1:])
    got = same_frames(data)
    assert [int(f[0, 0, 0]) for f in got] == [
        20 * round(i * 11 / 7) for i in range(8)]


# ---------------------------------------------------------------------------
# JPEG

def jpeg_close(data: bytes, exact: bool = False) -> None:
    ref = jmedia.decode_image(data).astype(np.int64)
    got = tmedia.decode_image(data).astype(np.int64)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    if exact:
        assert d.max() == 0
    assert d.max() <= JPEG_MAX
    assert d.reshape(-1, 3).mean(axis=0).max() <= JPEG_MEAN


@pytest.mark.parametrize("kind", ["grad", "edge", "noise"])
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_baseline_within_tolerance(subsampling, quality, kind):
    for h, w in ((37, 23), (64, 64), (17, 129), (1, 1), (3, 5)):
        data = pil_bytes(picture(h, w, kind, seed=h), "JPEG",
                         quality=quality, subsampling=subsampling)
        jpeg_close(data, exact=subsampling == 0)


@pytest.mark.parametrize("kind", ["grad", "edge", "noise"])
@pytest.mark.parametrize("case", ["gray", "progressive-444", "progressive-420",
                                  "progressive-gray", "restart",
                                  "restart-progressive", "4:1:1", "rgb"])
def test_jpeg_modes_within_tolerance(case, kind):
    img = picture(45, 61, kind)
    kw = {"quality": 85}
    if case == "gray":
        img = Image.fromarray(img).convert("L")
    elif case.startswith("progressive"):
        kw["progressive"] = True
        if case.endswith("gray"):
            img = Image.fromarray(img).convert("L")
        else:
            kw["subsampling"] = 0 if case.endswith("444") else 2
    elif case == "restart":
        kw["restart_marker_blocks"] = 3
    elif case == "restart-progressive":
        kw.update(restart_marker_rows=1, progressive=True)
    elif case == "4:1:1":
        kw["subsampling"] = "4:1:1"
    else:
        kw["keep_rgb"] = True   # Adobe transform 0: no colour conversion
    jpeg_close(pil_bytes(img, "JPEG", **kw))


# a minimal baseline encoder for what PIL does not write (4:4:0 and
# other sampling factors), with flat Huffman tables: DC's 12 categories
# in 4 bits, every AC symbol in 8 bits (254) or 9 (2); no code is all
# ones, as libjpeg requires

def _huffman_table(lengths: tuple) -> tuple[bytes, dict]:
    counts = [0] * 16
    codes, code = {}, 0
    for length, n in lengths:
        counts[length - 1] = n
        for _ in range(n):
            codes[len(codes)] = (code, length)
            code += 1
        code <<= 1
    return bytes(counts) + bytes(range(len(codes))), codes


def _dct_matrix() -> np.ndarray:
    m = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)]) * 0.5
    m[0] /= np.sqrt(2)
    return m


def jpeg_encode(rgb: np.ndarray, factors, q: int = 4) -> bytes:
    """Baseline JFIF with per-component (h, v) sampling factors."""
    H, W = rgb.shape[:2]
    f = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
        -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128,
        0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128,
    ], -1)
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    M = _dct_matrix()
    dc_table, dc_codes = _huffman_table(((4, 12),))
    table, codes = _huffman_table(((8, 254), (9, 2)))
    blocks = []
    for c, (h, v) in enumerate(factors):
        plane = np.pad(ycc[..., c], ((0, my * vmax * 8 - H),
                                     (0, mx * hmax * 8 - W)), mode="edge")
        sy, sx = vmax // v, hmax // h
        plane = plane.reshape(plane.shape[0] // sy, sy, plane.shape[1] // sx,
                              sx).mean(axis=(1, 3)) - 128
        b = plane.reshape(my * v, 8, mx * h, 8).transpose(0, 2, 1, 3)
        blocks.append(np.rint(M @ b @ M.T / q).astype(np.int64))
    bits: list[int] = []

    def put(value: int, n: int) -> None:
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def put_value(v: int) -> int:
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = [0] * len(factors)
    for yy in range(my):
        for xx in range(mx):
            for c, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        blk = blocks[c][yy * v + by, xx * h + bx].reshape(64)
                        zz = blk[tjpeg.ZIGZAG]
                        s, val = put_value(int(zz[0]) - pred[c])
                        pred[c] = int(zz[0])
                        put(*dc_codes[s])
                        put(val, s)
                        run = 0
                        for k in range(1, 64):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*codes[0xF0])
                                run -= 16
                            s, val = put_value(int(zz[k]))
                            put(*codes[(run << 4) | s])
                            put(val, s)
                            run = 0
                        if run:
                            put(*codes[0])
    bits.extend([1] * (-len(bits) % 8))
    data = bytearray()
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        data.append(byte)
        if byte == 0xFF:
            data.append(0)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    n = len(factors)
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")
    out += seg(0xDB, bytes([0]) + bytes([q] * 64))
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, n) + b"".join(
        bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(factors)))
    out += seg(0xC4, bytes([0x00]) + dc_table) + seg(0xC4, bytes([0x10])
                                                     + table)
    out += seg(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0])
                                           for i in range(n)) + b"\0\x3f\0")
    return out + bytes(data) + b"\xff\xd9"


@pytest.mark.parametrize("factors", [((1, 2), (1, 1), (1, 1)),
                                     ((2, 2), (1, 1), (1, 1)),
                                     ((2, 1), (1, 1), (1, 1)),
                                     ((1, 1), (1, 1), (1, 1)),
                                     ((2, 2), (2, 1), (1, 2))])
@pytest.mark.parametrize("size", [(37, 23), (16, 16), (5, 3)])
def test_jpeg_sampling_factors_within_tolerance(factors, size):
    """4:4:0 (h1v2 fancy upsampling) and mixed factors, from the encoder
    above."""
    jpeg_close(jpeg_encode(picture(*size, "edge"), factors))


def test_jpeg_decode_time_is_recorded_640x480():
    """The smoke's JPEG size decodes in a few hundred ms here (a CPU
    time, not a device one); the bound only catches a pathological
    walk."""
    import time

    data = pil_bytes(picture(480, 640, "grad"), "JPEG", quality=90,
                     subsampling=2)
    t = time.perf_counter()
    tmedia.decode_image(data)
    assert time.perf_counter() - t < 20


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 96), w=st.integers(1, 96),
       fmt=st.sampled_from(["PNG", "PNG-RGBA", "PNG-P", "GIF", "JPEG-444",
                            "JPEG-420", "JPEG-prog"]),
       seed=st.integers(0, 2**16))
def test_any_size_and_format_decodes_as_pil(h, w, fmt, seed):
    img = picture(h, w, "noise" if seed % 2 else "grad", seed=seed)
    if fmt == "PNG":
        same_image(pil_bytes(img, "PNG"))
    elif fmt == "PNG-RGBA":
        same_image(pil_bytes(Image.fromarray(img).convert("RGBA"), "PNG"))
    elif fmt == "PNG-P":
        same_image(pil_bytes(Image.fromarray(img).quantize(50), "PNG"))
    elif fmt == "GIF":
        same_image(pil_bytes(img, "GIF"))
    else:
        kw = {"quality": 75, "subsampling": 0 if fmt == "JPEG-444" else 2,
              "progressive": fmt == "JPEG-prog"}
        jpeg_close(pil_bytes(img, "JPEG", **kw))


# ---------------------------------------------------------------------------
# the committed fixtures of the card's media phase

FIXTURES = Path(__file__).resolve().parent / "data" / "media"


def test_committed_media_fixtures_are_the_generators_and_pils():
    """tests/data/media holds what scripts/make_media_fixtures.py writes,
    bit for bit, and each reference PNG is PIL's decode of its file, which
    the port's decoders give (the smoke checks them on the card's machine,
    where there is no PIL)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_media_fixtures", FIXTURES.parents[2] / "scripts"
        / "make_media_fixtures.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    made = gen.fixtures()
    assert sorted(made) == ["photo.jpg", "progressive.jpg", "rgba.png",
                            "video.gif"]
    total = 0
    for name, data in made.items():
        assert (FIXTURES / name).read_bytes() == data, name
        ref_png = (FIXTURES / (name + ".ref.png")).read_bytes()
        total += len(data) + len(ref_png)
        ref = tmedia.decode_image(ref_png)
        np.testing.assert_array_equal(ref, jmedia.decode_image(ref_png))
        np.testing.assert_array_equal(ref, gen.reference(data))
        frames = tmedia.decode_video_frames(data)
        got = np.concatenate(frames, axis=0)
        if name.endswith(".jpg"):
            d = np.abs(got.astype(int) - ref)
            assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN
        else:
            np.testing.assert_array_equal(got, ref)
    assert total < 2_000_000


# ---------------------------------------------------------------------------
# resize

@pytest.mark.parametrize("src", [(1, 1), (3, 2), (17, 400), (480, 640),
                                 (336, 336), (600, 800), (1000, 30)])
@pytest.mark.parametrize("dst", [(336, 336), (32, 32), (13, 700)])
def test_bicubic_resize_equals_pil(src, dst):
    for kind in ("noise", "grad"):
        img = picture(*src, kind)
        ref = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
        np.testing.assert_array_equal(resize(img, dst), ref)


# ---------------------------------------------------------------------------
# references and errors

class _Files(http.server.BaseHTTPRequestHandler):
    files: dict = {}

    def do_GET(self):  # noqa: N802 — http.server's name
        body = self.files.get(self.path)
        if body is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def file_server():
    png_data = pil_bytes(picture(9, 7, "edge"), "PNG")
    gif_data = _gif("P", 1, 5)
    _Files.files = {"/a.png": png_data, "/v.gif": gif_data,
                    "/big": b"\0" * (tmedia.MAX_IMAGE_BYTES + 1)}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Files)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except jmedia.MediaError as e:
        return ("error", str(e).split(":")[0])
    except tmedia.MediaError as e:
        return ("error", str(e).split(":")[0])
    if isinstance(out, list):
        return ("frames", [np.asarray(f).tobytes() for f in out])
    return ("value", np.asarray(out).tobytes() if not isinstance(
        out, bytes) else out)


def test_reference_forms_equal_the_reference(file_server):
    png_data = _Files.files["/a.png"]
    b64 = base64.b64encode(png_data).decode()
    for ref in (f"data:image/png;base64,{b64}", b64, f" {b64}\n",
                file_server + "/a.png", "data:image/png;base64,@@@@",
                "not base64 at all!", file_server + "/missing.png",
                file_server + "/big"):
        assert _outcome(tmedia.fetch_image_bytes, ref, timeout=10) == \
            _outcome(jmedia.fetch_image_bytes, ref, timeout=10), ref
        assert _outcome(tmedia.fetch_image, ref, timeout=10) == \
            _outcome(jmedia.fetch_image, ref, timeout=10), ref
    vid = file_server + "/v.gif"
    assert _outcome(tmedia.fetch_video_frames, vid, timeout=10) == \
        _outcome(jmedia.fetch_video_frames, vid, timeout=10)
    with pytest.raises(tmedia.MediaError, match="video_url is neither"):
        tmedia.fetch_video_frames("?not-a-ref?")


def _refused() -> dict:
    rgb = picture(16, 16, "grad")
    base = pil_bytes(rgb, "JPEG", quality=80)
    sof = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    out = {
        "WebP": pil_bytes(rgb, "WEBP"),
        "TIFF": pil_bytes(rgb, "TIFF"),
        "BMP": pil_bytes(rgb, "BMP"),
        "ICO": pil_bytes(rgb, "ICO"),
        "CMYK JPEG": pil_bytes(Image.fromarray(rgb).convert("CMYK"), "JPEG"),
        "arithmetic-coded JPEG": base[:sof + 1] + b"\xc9" + base[sof + 2:],
        "lossless JPEG": base[:sof + 1] + b"\xc3" + base[sof + 2:],
        "12-bit JPEG": bytes(twelve),
        "MP4/MOV video": b"\0\0\0\x18ftypisom" + b"\0" * 32,
        "WebM/Matroska video": b"\x1aE\xdf\xa3" + b"\0" * 32,
    }
    return out


@pytest.mark.parametrize("fmt", sorted(_refused()))
def test_unsupported_formats_are_refused_by_name(fmt):
    data = _refused()[fmt]
    with pytest.raises(tmedia.MediaError, match=fmt):
        tmedia.decode_image(data)
    with pytest.raises(tmedia.MediaError, match=fmt):
        tmedia.decode_video_frames(data)


@pytest.mark.parametrize("data", [b"", b"garbage bytes", tpng.SIGNATURE,
                                  b"\xff\xd8\xff\xe0\0\x10JFIF",
                                  b"GIF89a\1\0"])
def test_corrupt_data_is_a_media_error_on_both(data):
    with pytest.raises(jmedia.MediaError):
        jmedia.decode_image(data)
    with pytest.raises(tmedia.MediaError, match="cannot decode image"):
        tmedia.decode_image(data)


def test_decompression_bomb_is_refused_on_both():
    """A 60000 x 60000 header (PIL's limit is 2 x MAX_IMAGE_PIXELS): a
    media error from both, before any pixel buffer is allocated."""
    ihdr = struct.pack(">IIBBBBB", 60000, 60000, 8, 2, 0, 0, 0)
    data = (tpng.SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"")) + _chunk(b"IEND", b""))
    with pytest.raises(jmedia.MediaError):
        jmedia.decode_image(data)
    with pytest.raises(tmedia.MediaError, match="decompression bomb"):
        tmedia.decode_image(data)


@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_decode_or_raise_a_media_error(seed):
    """Bytes changed, cut out or cut off in valid files of each format:
    the port either decodes them or raises MediaError (a 400), never
    another exception."""
    rng = np.random.default_rng(seed)
    sources = [pil_bytes(picture(23, 31, "edge"), "PNG"),
               pil_bytes(picture(23, 31, "grad"), "JPEG", quality=80),
               pil_bytes(picture(23, 31, "grad"), "JPEG", quality=80,
                         progressive=True, subsampling=2),
               pil_bytes(picture(23, 31, "grad"), "JPEG", quality=80,
                         restart_marker_blocks=2),
               _gif("P", 1, 3), _apng("RGBA", 0)]
    for t in range(150):
        d = bytearray(sources[t % len(sources)])
        for _ in range(int(rng.integers(1, 6))):
            if len(d) < 2:
                break
            i = int(rng.integers(0, len(d)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                d[i] = int(rng.integers(0, 256))
            elif kind == 1:
                del d[i:i + int(rng.integers(1, 50))]
            else:
                del d[max(i, 1):]
        for fn in (tmedia.decode_image, tmedia.decode_video_frames):
            try:
                out = fn(bytes(d))
            except tmedia.MediaError:
                continue
            frames = out if isinstance(out, list) else [out]
            assert all(f.dtype == np.uint8 and f.ndim == 3
                       and f.shape[2] == 3 for f in frames)
