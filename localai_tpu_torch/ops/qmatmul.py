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

``w8_matmul_experts`` runs the expert products of a sparse-MoE layer on
K4 in one launch per projection (the expert on the grid's z axis). The
JAX package computes them as XLA einsums over the dequantized int8 stack
(``models/quant.py`` ``moe_up`` / ``moe_down``, outside Pallas); routing
them to K4 is the same function with another selection, as for the dense
projections. ``w8_matmul_experts.launches`` counts its launches, and
``w8_matmul_experts.up.launches`` / ``.down.launches`` those of the up
(shared x) and down projections.

bf16 x takes a tensor-core tile (``csrc/qmm_mma.cuh``) whose K is split
over CUDA blocks by :func:`qmm_split_plan`; ``w4_matmul_split_ref`` and
``w8_matmul_split_ref`` are plain models of that partition (tests only).
f32 x keeps the CUDA-core kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Optional

import torch

from localai_tpu_torch.ops import _build

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_M = 256
# the bf16 tile (csrc/qmm_mma.cuh): output columns per CUDA block and K
# rows per cp.async stage (the edge every split of K falls on)
QMM_BN = 128
QMM_BK = 128
# the split plan, from scripts/qmm_timing.py's sweep of 1-32 splits at
# Llama-3-8B's decode shapes (PERF.md §5-6): a grid narrower than the card
# aims at QMM_CTAS_PER_SM[kind] CUDA blocks per SM (K5's stage holds half
# K4's bytes, so it takes twice the blocks for the same bytes in flight),
# and a split walks at least QMM_MIN_SPLIT_K rows (two stages: a one-stage
# split is all pipeline prologue)
QMM_CTAS_PER_SM = {"w8": 2, "w4": 4}
QMM_MIN_SPLIT_K = 2 * QMM_BK


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
# split plan of the bf16 tile
# ---------------------------------------------------------------------------

def _mi(M: int) -> int:
    """n8 tiles of x rows per CUDA block of the bf16 tile."""
    return 1 if M <= 8 else 2 if M <= 16 else 4


def qmm_split_plan(M: int, K: int, N: int, group: int, sms: int,
                   kind: str, experts: int = 1) -> tuple[int, int, int]:
    """(mi, splits, split_k) of the bf16 tile of ``kind`` ("w8" or "w4")
    for x [M, K] against a [K, N] weight on a card of ``sms`` SMs: ``mi``
    n8 tiles of x rows per CUDA block (1 up to M = 8, 2 up to 16, else 4),
    and K cut into ``splits`` runs of ``split_k`` rows (the last may be
    shorter), each a whole number of ``group``-row groups (w4's scale
    group; QMM_BK for w8), so no group straddles two CUDA blocks. A grid
    of N / QMM_BN column tiles x M tiles that covers the SMs is not split
    (a wide weight, a long M); a narrower one aims at
    ``QMM_CTAS_PER_SM[kind]`` blocks per SM, with splits of at least
    QMM_MIN_SPLIT_K rows (N = 1024 at M = 8: 8 column tiles, 16 splits of
    256 rows). ``experts`` products of one shape in one launch (an MoE
    projection, :func:`w8_matmul_experts`) multiply the tiles: Mixtral's
    8 experts x 112 column tiles of an up projection at M = 8 fill the
    card unsplit. Shapes in, never data."""
    if (min(M, K, N, group, sms, experts) < 1 or N % QMM_BN
            or group % QMM_BK or K % group or kind not in QMM_CTAS_PER_SM):
        raise ValueError(f"no qmm split plan for M={M}, K={K}, N={N}, "
                         f"group={group}, sms={sms}, kind {kind!r}, "
                         f"experts={experts}")
    mi = _mi(M)
    tiles = experts * (N // QMM_BN) * -(-M // (8 * mi))
    groups = K // group
    most = max(1, K // max(group, QMM_MIN_SPLIT_K))
    want = (1 if tiles >= sms else
            (QMM_CTAS_PER_SM[kind] * sms + tiles // 2) // tiles)
    per_split = -(-groups // max(1, min(most, want)))
    return mi, -(-groups // per_split), per_split * group


@functools.lru_cache(maxsize=None)
def _device_plan(M: int, K: int, N: int, group: int, kind: str,
                 index: int, experts: int = 1) -> tuple[int, int, int]:
    """``qmm_split_plan`` on card ``index``, once per shape."""
    return qmm_split_plan(M, K, N, group, torch.cuda.get_device_properties(
        index).multi_processor_count, kind, experts)


def _forced_plan(M: int, K: int, group: int,
                 k_splits: int) -> tuple[int, int, int]:
    """The plan with ``k_splits`` splits on group edges (tests, timing),
    or ValueError when group edges cannot cut K into that many runs."""
    groups = K // group
    per_split = -(-groups // max(1, k_splits))
    if not 1 <= k_splits <= groups or -(-groups // per_split) != k_splits:
        raise ValueError(f"K={K} in groups of {group} cannot be cut into "
                         f"{k_splits} splits")
    return _mi(M), k_splits, per_split * group


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


def w8_matmul_experts_ref(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The E expert products of one MoE projection: x [M, K] (every
    expert reads the same rows) or [M, E, K] (expert e reads x[:, e])
    against the int8 stack q [E, K, N] with scale [E, N] → [M, E, N]:
    f32 accumulation, each expert's per-output-channel scale on its f32
    accumulator, one cast to x's dtype — K4's math per expert."""
    eq = "mk,ekn->men" if x.dim() == 2 else "mek,ekn->men"
    acc = torch.einsum(eq, x.float(), q.float())
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


def w8_matmul_split_ref(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor, k_splits: int,
                        transpose_w: bool = False) -> torch.Tensor:
    """Plain model of the bf16 tile's partition of K4 (q [K, N], or the
    [N, K] table with ``transpose_w``): K cut on QMM_BK edges as
    ``_forced_plan`` cuts it, an f32 partial x_s @ q_s per split, the
    partials summed in split order, then the scale and one cast — the
    order of the kernel's fold (tests only)."""
    M, K = x.shape
    _, splits, split_k = _forced_plan(M, K, QMM_BK, k_splits)
    xf, w = x.float(), (q.T if transpose_w else q).float()
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(splits):
        ks = slice(i * split_k, min(K, (i + 1) * split_k))
        acc = acc + xf[:, ks] @ w[ks]
    return (acc * scale.float()).to(x.dtype)


def w4_matmul_split_ref(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor, k_splits: int) -> torch.Tensor:
    """Plain model of the bf16 tile's partition of K5: K cut on group
    edges as ``_forced_plan`` cuts it; inside a split each group's f32
    partial dot times its scale row is added in group order, and the
    splits' sums are added in split order, then one cast (tests only)."""
    M, K = x.shape
    gc, N = scale.shape
    group = K // gc
    _, splits, split_k = _forced_plan(M, K, group, k_splits)
    w = unpack_w4(q, 0).float().reshape(gc, group, N)
    part = torch.einsum("mgk,gkn->mgn", x.float().reshape(M, gc, group), w)
    part = part * scale.float()[None]
    per = split_k // group
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for i in range(splits):
        acc = torch.zeros_like(out)
        for gi in range(i * per, min(gc, (i + 1) * per)):
            acc = acc + part[:, gi]
        out = out + acc
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

# x, q, scale, out, partial; M, K, N, transpose_w | group, is_bf16, mi,
# splits, split_k; stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# w8_matmul_experts: x, q, scale, out, partial; M, K, N, E, shared_x,
# is_bf16, mi, splits, split_k; stream
_EXPERT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])


def _fn(name: str, source: Optional[str] = None, argtypes=_ARGTYPES):
    fn = getattr(_build.load(source or name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _stream(x: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on x's card. The raw getter
    skips building a Stream object on each of the 225 calls of an 8B
    decode step, a step that is bound by the host."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _plan(x: torch.Tensor, K: int, N: int, group: int, kind: str,
          k_splits: Optional[int], experts: int = 1):
    """(plan, scratch) of the bf16 tile: the card's plan, or ``k_splits``
    splits when given, and an f32 scratch [experts x splits, M, N] from
    the caching allocator when K is split (None otherwise)."""
    M = x.shape[0]
    if k_splits is None:
        plan = _device_plan(M, K, N, group, kind, x.device.index, experts)
    else:
        plan = _forced_plan(M, K, group, k_splits)
    scratch = (torch.empty((experts * plan[1], M, N), dtype=torch.float32,
                           device=x.device) if plan[1] > 1 else None)
    return plan, scratch


def w8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
              transpose_w: bool = False,
              k_splits: Optional[int] = None) -> torch.Tensor:
    """x [M, K] (bf16/f32) × int8 weight → [M, N] in x's dtype.
    ``transpose_w=False``: q [K, N], scale [N]; ``transpose_w=True``:
    q [N, K] (the tied lm_head table), scale [N], computing x @ q.T.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. bf16 x takes the tensor-core tile in either orientation, K
    split by :func:`qmm_split_plan` (``k_splits`` forces a split count:
    tests and timing)."""
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
    tiled = x.dtype == torch.bfloat16
    (mi, splits, split_k), scratch = (
        _plan(x, K, N, QMM_BK, "w8", k_splits) if tiled
        else ((0, 0, 0), None))
    rc = _fn("w8_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0,
        M, K, N, int(transpose_w), int(tiled), mi, splits, split_k,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"w8 matmul kernel launch failed (code {rc})")
    _build.count_launch(w8_matmul)
    return out


w8_matmul.launches = 0


def w4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
              k_splits: Optional[int] = None) -> torch.Tensor:
    """x [M, K] (bf16/f32) × group-wise int4 weight, packed [K/2, N]
    (:func:`pack_w4`), scale [K/group, N] → [M, N] in x's dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise. bf16 x takes the tensor-core tile, K split on group edges by
    :func:`qmm_split_plan` (``k_splits`` forces a split count: tests and
    timing)."""
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
    group = K // scale.shape[0]
    tiled = x.dtype == torch.bfloat16
    (mi, splits, split_k), scratch = (
        _plan(x, K, N, group, "w4", k_splits) if tiled
        else ((0, 0, 0), None))
    rc = _fn("w4_matmul")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0,
        M, K, N, group, int(tiled), mi, splits, split_k,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"w4 matmul kernel launch failed (code {rc})")
    _build.count_launch(w4_matmul)
    return out


w4_matmul.launches = 0


def experts_eligible(x_shape: tuple, q: torch.Tensor,
                     scale: torch.Tensor) -> bool:
    """An int8 expert stack q [E, K, N] with scale [E, N], 128-aligned K
    and N, and x [..., K] (shared rows) or [..., E, K]. Any number of rows:
    the expert kernel has no Pallas counterpart whose M gate it keeps."""
    if q.dim() != 3 or scale.dim() != 2 or q.dtype != torch.int8:
        return False
    E, K, N = q.shape
    return (tuple(scale.shape) == (E, N) and x_shape[-1] == K
            and K % 128 == 0 and N % 128 == 0)


def w8_matmul_experts(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      *, k_splits: Optional[int] = None) -> torch.Tensor:
    """The E expert products of one MoE projection on K4, one launch: x
    [M, K] (``moe_up``: every expert reads the same rows) or [M, E, K]
    (``moe_down``: expert e reads x[:, e]) against q [E, K, N] int8 with
    scale [E, N] → [M, E, N] in x's dtype. CPU tensors take
    :func:`w8_matmul_experts_ref`; CUDA tensors launch the kernel or raise.
    bf16 x takes the tensor-core tile, K split by :func:`qmm_split_plan`
    over all E experts' tiles (``k_splits`` forces a count); f32 x the
    CUDA-core kernel."""
    if x.device.type == "cpu":
        return w8_matmul_experts_ref(x, q, scale)
    _check(x, q, scale)
    E = q.shape[0] if q.dim() == 3 else 0
    shared = x.dim() == 2
    if (not (shared or (x.dim() == 3 and x.shape[1] == E))
            or not experts_eligible(tuple(x.shape), q, scale)):
        raise ValueError(
            f"w8 expert kernel does not take x {tuple(x.shape)}, q "
            f"{tuple(q.shape)} {q.dtype}, scale {tuple(scale.shape)}")
    M = x.shape[0]
    _, K, N = q.shape
    out = torch.empty((M, E, N), dtype=x.dtype, device=x.device)
    tiled = x.dtype == torch.bfloat16
    (mi, splits, split_k), scratch = (
        _plan(x, K, N, QMM_BK, "w8", k_splits, E) if tiled
        else ((0, 0, 0), None))
    rc = _fn("w8_matmul_experts", "w8_matmul", _EXPERT_ARGTYPES)(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0,
        M, K, N, E, int(shared), int(tiled), mi, splits, split_k,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"w8 expert kernel launch failed (code {rc})")
    _build.count_launch(w8_matmul_experts)
    _build.count_launch(w8_matmul_experts.up if shared
                        else w8_matmul_experts.down)
    return out


w8_matmul_experts.launches = 0
# the launches of up projections (gate and up: x shared by every expert)
# and of down projections (each expert its own rows), counted apart
w8_matmul_experts.up = types.SimpleNamespace(launches=0)
w8_matmul_experts.down = types.SimpleNamespace(launches=0)
