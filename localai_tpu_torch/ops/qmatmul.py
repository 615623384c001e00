"""Quantized-weight matmuls: the hand-written CUDA kernels and their plain
versions.

Port of ``localai_tpu/ops/qmatmul.py`` — the Pallas TPU kernels
``w8_matmul`` (kernel ``_kernel``) and ``w4_matmul`` (``_w4_kernel``).
The CUDA sources are ``csrc/w8_matmul.cu`` and ``csrc/w4_matmul.cu``,
built with nvcc for sm_90a at first use (``ops._build``) and called
through a plain C interface.

The wrappers take a CPU tensor to the plain PyTorch version and launch
the kernel for a CUDA tensor; a CUDA shape the kernel does not take
raises — there is no fallback. ``w8_matmul.launches`` /
``w4_matmul.launches`` count kernel launches.

The JAX package enables its kernels only under ``LOCALAI_W8_KERNEL``;
the port's ``models.quant.matmul`` calls them whenever ``eligible`` /
``w4_eligible`` hold (the same gates as JAX's): the same function, a
different selection.

The w4 weight layout is defined here, once: :func:`pack_w4`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from localai_tpu_torch.ops import _build

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_M = 256


# ---------------------------------------------------------------------------
# w4 layout
# ---------------------------------------------------------------------------

def pack_w4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int8 values in [-8, 7] → uint8, packed along ``axis``: rows 2i and
    2i+1 land in the low and high nibble of byte i. A [K, N] weight is
    stored [K/2, N]; both rows of a byte share a scale group, and a warp
    reading a packed row along N reads contiguous bytes."""
    if q.shape[axis] % 2:
        raise ValueError(f"w4 packing needs an even axis {axis}, got "
                         f"shape {tuple(q.shape)}")
    qm = q.to(torch.int8).movedim(axis, 0)
    packed = (qm[0::2] & 0x0F) | (qm[1::2] << 4)
    return packed.view(torch.uint8).movedim(0, axis).contiguous()


def unpack_w4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`pack_w4`: uint8 → int8 in [-8, 7] with ``axis``
    doubled. Nibbles sign-extend through arithmetic shifts."""
    p = packed.view(torch.int8).movedim(axis, 0)
    lo = (p << 4) >> 4
    hi = p >> 4
    out = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], *p.shape[1:])
    return out.movedim(0, axis).contiguous()


# ---------------------------------------------------------------------------
# gates (the JAX package's conditions)
# ---------------------------------------------------------------------------

def eligible(x_shape: tuple, q: torch.Tensor, scale: torch.Tensor,
             transpose_w: bool) -> bool:
    """2-D int8 weight, 1-D scale, 128-aligned K and N, M <= 256."""
    if q.dim() != 2 or scale.dim() != 1 or q.dtype != torch.int8:
        return False
    K = q.shape[1] if transpose_w else q.shape[0]
    N = q.shape[0] if transpose_w else q.shape[1]
    return (x_shape[-1] == K and K % 128 == 0 and N % 128 == 0
            and math.prod(x_shape[:-1]) <= MAX_M)


def w4_eligible(x_shape: tuple, q: torch.Tensor,
                scale: torch.Tensor) -> bool:
    """2-D packed int4 weight [K/2, N], 2-D scale [K/group, N] with a
    128-aligned group, 128-aligned K and N, M <= 256."""
    if q.dim() != 2 or scale.dim() != 2 or q.dtype != torch.uint8:
        return False
    K, N = 2 * q.shape[0], q.shape[1]
    if scale.shape[1] != N or K % scale.shape[0]:
        return False
    group = K // scale.shape[0]
    return (x_shape[-1] == K and group % 128 == 0 and K % 128 == 0
            and N % 128 == 0 and math.prod(x_shape[:-1]) <= MAX_M)


# ---------------------------------------------------------------------------
# plain versions (the Pallas kernels' math)
# ---------------------------------------------------------------------------

def w8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  transpose_w: bool = False) -> torch.Tensor:
    """x [M, K] × int8 q [K, N] (or [N, K] with ``transpose_w``): f32
    accumulation, the per-output-channel scale applied to the f32
    accumulator, then a cast to x's dtype."""
    w = q.float()
    acc = x.float() @ (w.T if transpose_w else w)
    return (acc * scale.float()).to(x.dtype)


def w4_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] × packed int4 q [K/2, N] with scale [K/group, N]: one f32
    partial dot per group, times the group's scale, summed."""
    M, K = x.shape
    gc, N = scale.shape
    w = unpack_w4(q, 0).float().reshape(gc, K // gc, N)
    part = torch.einsum("mgk,gkn->mgn", x.float().reshape(M, gc, K // gc), w)
    return (part * scale.float()[None]).sum(1).to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _fn(name: str):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} (kernel takes bfloat16/float32)")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def w8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
              transpose_w: bool = False) -> torch.Tensor:
    """x [M, K] (bf16/f32) × int8 weight → [M, N] in x's dtype.
    ``transpose_w=False``: q [K, N], scale [N]; ``transpose_w=True``:
    q [N, K] (the tied lm_head table), scale [N], computing x @ q.T.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return w8_matmul_ref(x, q, scale, transpose_w)
    _check(x, q, scale)
    if x.dim() != 2 or not eligible(tuple(x.shape), q, scale, transpose_w):
        raise ValueError(
            f"w8 kernel does not take x {tuple(x.shape)}, q "
            f"{tuple(q.shape)} {q.dtype}, scale {tuple(scale.shape)}")
    M, K = x.shape
    N = q.shape[0] if transpose_w else q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _fn("w8_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, int(transpose_w), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8 matmul kernel launch failed (code {rc})")
    _build.count_launch(w8_matmul)
    return out


w8_matmul.launches = 0


def w4_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16/f32) × group-wise int4 weight, packed [K/2, N]
    (:func:`pack_w4`), scale [K/group, N] → [M, N] in x's dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return w4_matmul_ref(x, q, scale)
    _check(x, q, scale)
    if x.dim() != 2 or not w4_eligible(tuple(x.shape), q, scale):
        raise ValueError(
            f"w4 kernel does not take x {tuple(x.shape)}, q "
            f"{tuple(q.shape)} {q.dtype}, scale {tuple(scale.shape)}")
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _fn("w4_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, K // scale.shape[0], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w4 matmul kernel launch failed (code {rc})")
    _build.count_launch(w4_matmul)
    return out


w4_matmul.launches = 0
