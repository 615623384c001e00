"""Bicubic resize of uint8 RGB images, as PIL's ``Image.resize(size,
Image.BICUBIC)`` computes it (``libImaging/Resample.c``).

The vision tower's ``preprocess`` resizes every image to the tower's
square; the JAX package calls PIL for it, and the card's machine has no
PIL. Pillow's algorithm, step for step:

  * a separable convolution with the cubic kernel of a = -0.5, its
    support (2) scaled by the downscale factor when shrinking;
  * each output pixel's window and weights computed in double precision,
    normalised by their sum, then turned into fixed point with
    ``PRECISION_BITS = 22`` (rounded half away from zero);
  * the horizontal pass first, its result rounded and clipped to uint8,
    then the vertical pass over it.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def coefficients(in_size: int, out_size: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``:
    ([out, 2] window (start, count), [out, ksize] int fixed-point
    weights)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = 1 << PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        xmax -= xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            kk[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (1 = horizontal, 0 = vertical)."""
    bounds, kk = coefficients(img.shape[axis], out_size)
    ksize = kk.shape[1]
    src = np.moveaxis(img, axis, 0).astype(np.int64)      # [in, other, c]
    idx = bounds[:, :1] + np.arange(ksize)[None, :]       # [out, ksize]
    valid = np.arange(ksize)[None, :] < bounds[:, 1:]
    idx = np.where(valid, idx, 0)
    w = np.where(valid, kk, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    extra = (None,) * (src.ndim - 1)
    for k in range(ksize):
        acc += w[(slice(None), k) + extra] * src[idx[:, k]]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] → [h, w, C] for ``size`` = (w, h), PIL's order."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, 1)
    if h != img.shape[0]:
        out = _pass(out, h, 0)
    return out if out is not img else img.copy()
