"""JPEG decoding in Python and numpy, as libjpeg-turbo decodes for PIL.

The counterpart of PIL's JPEG reader (libjpeg-turbo) as
``localai_tpu/utils/media.py`` reaches it:
``Image.open(...).convert("RGB")``. The card's machine has no PIL.

  * Baseline and extended sequential Huffman (SOF0/SOF1) and progressive
    Huffman (SOF2: spectral selection, DC and AC successive approximation,
    EOB runs); greyscale and 3-component YCbCr (or RGB, by the Adobe
    marker or the component ids, as libjpeg guesses); any sampling
    factors; restart intervals (DRI/RSTn).
  * The Huffman walk is Python: each entropy-coded interval is unstuffed,
    split at its RSTn markers, and read through a list of 32-bit windows
    (one per byte), so a 16-bit lookahead table gives each symbol's code
    length and value in one lookup.
  * Everything after it is vectorised over all blocks: libjpeg's integer
    "islow" IDCT (``jidctint.c``, its range-limit table included), fancy
    (triangle) chroma upsampling (``jdsample.c``: h2v1, h1v2, h2v2, with
    edge rows and columns replicated; box replication for other ratios
    and for components two samples wide or less), and the fixed-point
    YCbCr→RGB tables of ``jdcolor.c``.
  * EXIF orientation is not applied (PIL's ``convert("RGB")`` does not).

Refused with the format named: arithmetic coding, lossless and
hierarchical JPEG, 12-bit samples, CMYK/YCCK and 2-component files.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from localai_tpu_torch.utils.png import check_size

# zigzag position → natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = ZIGZAG.tolist() + [63] * 16   # libjpeg pads the table against overrun

_SOF_REFUSED = {
    0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
    0xC6: "hierarchical JPEG", 0xC7: "hierarchical lossless JPEG",
    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded JPEG",
    0xCB: "arithmetic-coded lossless JPEG",
    0xCD: "arithmetic-coded hierarchical JPEG",
    0xCE: "arithmetic-coded hierarchical JPEG",
    0xCF: "arithmetic-coded hierarchical JPEG",
}


def _post_idct_table() -> np.ndarray:
    """libjpeg's range limit after the IDCT, indexed by ``x & 1023``:
    x + 128 clamped to 0..255 for |x| < 512, wrapping beyond."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(
        i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


_RANGE = _post_idct_table()


def _idct_1d(d: list) -> list:
    """One pass of ``jpeg_idct_islow`` over 8 int64 arrays (undescaled)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[N, 64] coefficients (natural order) × quant [64] → [N, 8, 8]
    uint8 samples, bit for bit as libjpeg's ``jpeg_idct_islow``."""
    c = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (over the row index), descaled by CONST_BITS-PASS1
    ws = _idct_1d([c[:, k, :] for k in range(8)])
    ws = np.stack([(w + 1024) >> 11 for w in ws], axis=1)
    # pass 2: rows, descaled by CONST_BITS+PASS1+3, then range-limited
    out = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([(o + (1 << 17)) >> 18 for o in out], axis=2)
    return _RANGE[out & 1023]


def _fancy_h(s: np.ndarray, b0: int, b1: int, shift: int) -> np.ndarray:
    """Horizontal 2x triangle filter on [h, w] (already x4 weights when
    ``shift`` is 4): out[2j] = (3s[j] + s[j-1] + b0) >> shift and
    out[2j+1] = (3s[j] + s[j+1] + b1) >> shift, edges replicated."""
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    out = np.empty((s.shape[0], s.shape[1] * 2), np.int64)
    out[:, 0::2] = (3 * s + left + b0) >> shift
    out[:, 1::2] = (3 * s + right + b1) >> shift
    return out


def upsample(comp: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """One component's [h, w] samples → [h·vr, w·hr], as libjpeg's
    upsampler with ``do_fancy_upsampling`` (its default, which PIL
    keeps)."""
    if hr == 1 and vr == 1:
        return comp
    s = comp.astype(np.int64)
    w = s.shape[1]
    if hr == 2 and vr == 1 and w > 2:            # h2v1_fancy_upsample
        return _fancy_h(s, 1, 2, 2).astype(np.uint8)
    if hr == 1 and vr == 2:                      # h1v2_fancy_upsample
        up = np.concatenate([s[:1], s[:-1]], axis=0)
        dn = np.concatenate([s[1:], s[-1:]], axis=0)
        out = np.empty((s.shape[0] * 2, w), np.int64)
        out[0::2] = (3 * s + up + 1) >> 2
        out[1::2] = (3 * s + dn + 2) >> 2
        return out.astype(np.uint8)
    if hr == 2 and vr == 2 and w > 2:            # h2v2_fancy_upsample
        up = np.concatenate([s[:1], s[:-1]], axis=0)
        dn = np.concatenate([s[1:], s[-1:]], axis=0)
        out = np.empty((s.shape[0] * 2, w * 2), np.int64)
        out[0::2] = _fancy_h(3 * s + up, 8, 7, 4)
        out[1::2] = _fancy_h(3 * s + dn, 8, 7, 4)
        return out.astype(np.uint8)
    return np.repeat(np.repeat(comp, vr, axis=0), hr, axis=1)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` with its fixed-point tables."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -- entropy decoding ------------------------------------------------------

def _huff_lut(counts: bytes, symbols: bytes) -> list:
    """16-bit lookahead table: entry (length << 8) | symbol for every
    16-bit window whose leading bits are a code; 0 for none."""
    lut = [0] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise ValueError("bad Huffman table")
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > 65536:
                raise ValueError("bad Huffman table")
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _windows(seg: bytes) -> list:
    """Unstuffed entropy bytes → 32-bit big-endian windows, one per byte,
    zeros past the end (libjpeg reads zeros once the data runs out)."""
    a = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\0" * 8,
                      np.uint8).astype(np.uint32)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
            | a[3:]).tolist()


class _Comp:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "pbw", "pbh", "coef",
                 "quant", "pred", "dc", "ac")


def _scan_segments(data: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded data from ``pos``, split at RSTn markers; returns
    (segments, position of the marker that ends the scan)."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("image file is truncated")
        m = data[i + 1]
        if m == 0 or m == 0xFF:
            pos = i + 1 if m == 0xFF else i + 2
            continue
        if 0xD0 <= m <= 0xD7:
            segs.append(data[start:i])
            start = pos = i + 2
            continue
        segs.append(data[start:i])
        return segs, i


def _decode_scan(scomps: list, ss: int, se: int, ah: int,
                 al: int, progressive: bool, segs: list, restart: int,
                 mcux: int, mcuy: int) -> None:
    """Decode one scan into the components' coefficient lists."""
    if len(scomps) == 1:
        c = scomps[0]
        blocks = [[(c, (r * c.pbw + col) * 64)]
                  for r in range(c.bh) for col in range(c.bw)]
    else:
        blocks = []
        for my in range(mcuy):
            for mx in range(mcux):
                blocks.append([
                    (c, ((my * c.v + by) * c.pbw + mx * c.h + bx) * 64)
                    for c in scomps for by in range(c.v)
                    for bx in range(c.h)])
    per = restart or len(blocks)
    zz = _ZZ
    for iv in range(0, len(blocks), per):
        k_seg = iv // per
        W = _windows(segs[k_seg] if k_seg < len(segs) else b"")
        p = 0
        eobrun = 0
        for c in scomps:
            c.pred = 0
        for mcu in blocks[iv:iv + per]:
            for c, base in mcu:
                coef = c.coef
                if not progressive or (ss == 0 and ah == 0):
                    # DC: first scan (or sequential)
                    lut = c.dc
                    e = lut[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG data: bad Huffman "
                                         "code")
                    p += e >> 8
                    s = e & 0xFF
                    v = 0
                    if s:
                        v = (W[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                    c.pred += v
                    coef[base] = c.pred << al
                    if progressive:
                        continue
                    # sequential AC
                    lut = c.ac
                    k = 1
                    while k < 64:
                        e = lut[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("corrupt JPEG data: bad "
                                             "Huffman code")
                        p += e >> 8
                        rs = e & 0xFF
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            v = (W[p >> 3] >> (32 - (p & 7) - s)) & \
                                ((1 << s) - 1)
                            p += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            coef[base + zz[k]] = v
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
                elif ss == 0:
                    # DC refinement: one bit
                    if (W[p >> 3] >> (31 - (p & 7))) & 1:
                        coef[base] |= 1 << al
                    p += 1
                elif ah == 0:
                    # AC first scan, spectral band ss..se
                    if eobrun:
                        eobrun -= 1
                        continue
                    lut = c.ac
                    k = ss
                    while k <= se:
                        e = lut[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("corrupt JPEG data: bad "
                                             "Huffman code")
                        p += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = (W[p >> 3] >> (32 - (p & 7) - s)) & \
                                ((1 << s) - 1)
                            p += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            coef[base + zz[k]] = v << al
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += (W[p >> 3] >> (32 - (p & 7) - r)) \
                                    & ((1 << r) - 1)
                                p += r
                            eobrun -= 1
                            break
                else:
                    # AC refinement (jdphuff.c decode_mcu_AC_refine)
                    p1, m1 = 1 << al, -1 << al
                    lut = c.ac
                    k = ss
                    if not eobrun:
                        while k <= se:
                            e = lut[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError("corrupt JPEG data: bad "
                                                 "Huffman code")
                            p += e >> 8
                            rs = e & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s:
                                bit = (W[p >> 3] >> (31 - (p & 7))) & 1
                                p += 1
                                s = p1 if bit else m1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (W[p >> 3] >> (32 - (p & 7)
                                                             - r)) \
                                        & ((1 << r) - 1)
                                    p += r
                                break
                            while k <= se:
                                pos = base + zz[k]
                                cur = coef[pos]
                                if cur:
                                    if (W[p >> 3] >> (31 - (p & 7))) & 1 \
                                            and not cur & p1:
                                        coef[pos] = cur + (p1 if cur >= 0
                                                           else m1)
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                coef[base + zz[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            pos = base + zz[k]
                            cur = coef[pos]
                            if cur:
                                if (W[p >> 3] >> (31 - (p & 7))) & 1 \
                                        and not cur & p1:
                                    coef[pos] = cur + (p1 if cur >= 0
                                                       else m1)
                                p += 1
                            k += 1
                        eobrun -= 1


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes → RGB uint8 [H, W, 3], as PIL's
    ``Image.open(...).convert("RGB")`` gives it."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    qt: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, list] = {}
    ac_tabs: dict[int, list] = {}
    comps: list[_Comp] = []
    restart = 0
    progressive = False
    jfif = False
    adobe: Optional[int] = None
    width = height = 0
    mcux = mcuy = 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1      # libjpeg skips garbage before a marker
            continue
        m = data[pos + 1] if pos + 1 < len(data) else 0xD9
        pos += 2
        if m == 0xFF or m == 0x01 or 0xD0 <= m <= 0xD7:
            if m == 0xFF:
                pos -= 1
            continue
        if m == 0xD9:
            break
        if pos + 2 > len(data):
            raise ValueError("image file is truncated")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if len(seg) < length - 2:
            raise ValueError("image file is truncated")
        nxt = pos + length
        if m in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[m]} is not supported")
        if m == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported")
        if m in (0xC0, 0xC1, 0xC2):
            if comps:
                raise ValueError("JPEG has more than one frame")
            progressive = m == 0xC2
            prec, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported")
            if not height:
                raise ValueError("JPEG with a DNL height is not supported")
            check_size(width, height)
            if nf == 4:
                raise ValueError(
                    ("YCCK" if adobe == 2 else "CMYK")
                    + " JPEG is not supported")
            if nf not in (1, 3):
                raise ValueError(f"{nf}-component JPEG is not supported")
            for i in range(nf):
                c = _Comp()
                c.cid, hv, c.tq = seg[6 + 3 * i:9 + 3 * i]
                c.h, c.v = hv >> 4, hv & 15
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                    raise ValueError("bad JPEG sampling factors")
                c.quant = None
                comps.append(c)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                cw = -(-width * c.h // hmax)
                ch = -(-height * c.v // vmax)
                c.bw, c.bh = -(-cw // 8), -(-ch // 8)
                c.pbw, c.pbh = mcux * c.h, mcuy * c.v
                c.coef = [0] * (c.pbw * c.pbh * 64)
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                syms = seg[i + 17:i + 17 + n]
                lut = _huff_lut(counts, syms)
                (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = lut
                i += 17 + n
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, i + 1)
                    i += 129
                else:
                    vals = np.frombuffer(seg, np.uint8, 64, i + 1)
                    i += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[tq] = q
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xE0 and seg.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if not comps:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            scomps = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i:3 + 2 * i]
                c = next((c for c in comps if c.cid == cid), None)
                if c is None:
                    raise ValueError("JPEG scan names an unknown component")
                c.dc = dc_tabs.get(t >> 4)
                c.ac = ac_tabs.get(t & 15)
                if c.quant is None:    # libjpeg latches tables at first use
                    if c.tq not in qt:
                        raise ValueError("JPEG quantization table missing")
                    c.quant = qt[c.tq]
                scomps.append(c)
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            for c in scomps:
                need_dc = ss == 0 and ah == 0
                need_ac = ss > 0 and ah == 0 or not progressive or (
                    ss > 0 and ah > 0)
                if (need_dc and c.dc is None) or (need_ac and c.ac is None):
                    raise ValueError("JPEG Huffman table missing")
            segs, nxt = _scan_segments(data, nxt)
            try:
                _decode_scan(scomps, ss, se, ah, al, progressive, segs,
                             restart, mcux, mcuy)
            except IndexError:
                raise ValueError("corrupt JPEG data: premature end of data "
                                 "segment") from None
        pos = nxt
    if not comps or any(c.quant is None for c in comps):
        raise ValueError("JPEG has no image data")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        coef = np.asarray(c.coef, np.int64).reshape(
            c.pbh, c.pbw, 64)
        blocks = idct_islow(coef.reshape(-1, 64), c.quant)
        px = blocks.reshape(c.pbh, c.pbw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(c.pbh * 8, c.pbw * 8)
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        if hmax % c.h or vmax % c.v:
            raise ValueError("fractional JPEG sampling is not supported")
        up = upsample(px[:ch, :cw], hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66]
    if rgb:
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)
