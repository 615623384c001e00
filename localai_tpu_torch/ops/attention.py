"""Decode and prefill attention: hand-written CUDA kernels and their plain
versions.

Ports of the three Pallas TPU kernels of ``localai_tpu/ops/attention.py``:

  * ``paged_decode_attention`` (K1, ``_paged_decode_kernel``): one query
    token per slot over a paged block pool, for bf16/f32 pools and scaled
    int8 and int4 pools (``k_scale``/``v_scale`` [N, Hkv, bt] f32; an int4
    pool is nibble-packed and detected, as in the JAX package, by its last
    dim hd/2). Source ``csrc/paged_decode_attention.cu``: each slot's
    block walk is split over several CUDA blocks (``paged_split_plan``)
    whose partial softmax states a second kernel merges;
    ``paged_decode_attention_split_ref`` is the plain model of that
    split.
  * ``decode_attention`` (K2, ``_decode_kernel``): the same over the
    contiguous slot cache [S, Hkv, C, hd], bf16/f32 or scaled int8 (scales
    [S, Hkv, C]). Source ``csrc/decode_attention.cu``: K1's split walk
    and merge with the cache row's ``DECODE_TILE``-row tiles in place of
    the table entries (``decode_split_plan``);
    ``decode_attention_split_ref`` is the plain model of that split.
  * ``prefill_attention`` (K3, ``_prefill_kernel``): causal GQA attention
    for one sequence, q [T, Hq, hd] against head-major k/v [Hkv, T, hd],
    masked to a real length and a window. Source
    ``csrc/prefill_attention.cu``; a bf16 CUDA block takes 64 or 128 query
    rows (``prefill_block_rows``).

The sources are built with nvcc for sm_90a at first use (``ops._build``)
and called through plain C interfaces. Each wrapper takes a CPU tensor to
its plain PyTorch version (``*_ref``) and launches the kernel for a CUDA
tensor; a CUDA shape the kernel was not compiled for raises — there is no
fallback. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from localai_tpu_torch.ops import _build

_NEG_INF = -1e30

# what the three sources are compiled for
KERNEL_HEAD_DIMS = (32, 64, 128)
# every GQA group of the llama/mistral/qwen2 checkpoints (Llama-3.1-405B's
# 128 q / 8 kv heads is the largest). K1/K2 are compiled for the group
# capacities of DECODE_GROUPS and run a group on the smallest capacity
# that holds it, rows past the group masked; K3 reads the group at run time
KERNEL_GROUPS = tuple(range(1, 17))
DECODE_GROUPS = (1, 2, 4, 8, 16)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# KV storage the decode kernels read: the compute dtype itself (""), or
# scaled int8 / int4 (the template parameter P = 0, 1, 2; K2 has no int4)
KERNEL_POOLS = ("", "int8", "int4")
MAX_SMEM_BYTES = 232448  # H100 opt-in shared memory per block
DECODE_TILE = 64         # cache rows per tile in csrc/decode_attention.cu
# K1's split plan, from scripts/k1_timing.py's sweep of 1-32 table entries
# per split at the 8-slot, 8-kv-head, 64-entry serving shape and three
# traffic mixes (PERF.md §5): full tables give at most SPLIT_CTAS_PER_SM
# CUDA blocks per SM, each split walking at least MIN_SPLIT_BLOCKS[pool]
# entries. A bf16 (f32) pool's CUDA block stages 64 (128) KB of tiles, so
# few share an SM, and 2-entry splits, whose cp.async double buffer
# overlaps a copy with a fold, were fastest or tied at long contexts; an
# int8 (int4) pool's stages a half (a quarter) of bf16's, more share an
# SM, and 1-entry splits were fastest at every mix.
SPLIT_CTAS_PER_SM = 32
MIN_SPLIT_BLOCKS = {"": 2, "int8": 1, "int4": 1}


def paged_split_plan(S: int, Hkv: int, MB: int, sms: int,
                     pool: str = "") -> tuple[int, int]:
    """(blocks_per_split, splits) of K1's walk over ``MB``-entry block
    tables for ``S`` slots and ``Hkv`` kv heads on a card of ``sms`` SMs,
    for a pool of kind ``pool`` (``KERNEL_POOLS``).

    It reads shapes only, never the positions (reading them would
    synchronise the decode step), so it plans for full tables: at most
    ``SPLIT_CTAS_PER_SM`` CUDA blocks per SM, each walking at least
    ``MIN_SPLIT_BLOCKS[pool]`` entries; a table that short is one split.
    The splits cover [0, MB) exactly; a split that holds no live block of
    a slot costs the kernel one early exit, and the merge skips it."""
    if min(S, Hkv, MB, sms) < 1 or pool not in MIN_SPLIT_BLOCKS:
        raise ValueError(f"no split plan for S={S}, Hkv={Hkv}, MB={MB}, "
                         f"sms={sms}, pool {pool!r}")
    per_walk = max(1, SPLIT_CTAS_PER_SM * sms // (S * Hkv))
    bps = min(MB, max(MIN_SPLIT_BLOCKS[pool], -(-MB // per_walk)))
    return bps, -(-MB // bps)


def decode_split_plan(S: int, Hkv: int, C: int, sms: int,
                      pool: str = "") -> tuple[int, int]:
    """(tiles_per_split, splits) of K2's walk over a ``C``-row contiguous
    cache: K1's plan (``paged_split_plan``) with the cache row's
    ``DECODE_TILE``-row tiles as the table entries. Shapes in, never the
    positions."""
    if C < 1:
        raise ValueError(f"no split plan for a context of {C} rows")
    return paged_split_plan(S, Hkv, -(-C // DECODE_TILE), sms, pool)


@functools.lru_cache(maxsize=None)
def _decode_device_plan(S: int, Hkv: int, C: int, pool: str,
                        index: int) -> tuple[int, int]:
    """``decode_split_plan`` on card ``index``, once per shape."""
    return decode_split_plan(
        S, Hkv, C, torch.cuda.get_device_properties(index)
        .multi_processor_count, pool)


@functools.lru_cache(maxsize=None)
def _device_plan(S: int, Hkv: int, MB: int, pool: str,
                 index: int) -> tuple[int, int]:
    """``paged_split_plan`` on card ``index``, once per shape: the decode
    step is bound by the host, so a call looks its plan up."""
    return paged_split_plan(
        S, Hkv, MB, torch.cuda.get_device_properties(index)
        .multi_processor_count, pool)


# query rows (position x GQA group) a bf16 K3 CUDA block of 4 warps takes:
# at 128 (32 a warp) every K/V fragment read from shared memory feeds
# twice the tensor-core work of 64 (16 a warp), but a shorter prompt then
# gives too few blocks to keep two on every SM (scripts/attn_timing.py's
# rows_spun_ms times both sizes at 512-4096 tokens)
PREFILL_ROWS = (64, 128)
PREFILL_BLOCKS_PER_SM = 2   # 128-row blocks that fit an SM at once


def prefill_block_rows(T: int, Hq: int, Hkv: int, sms: int) -> int:
    """Query rows a bf16 K3 CUDA block takes for a ``T``-token prompt of
    ``Hq`` query and ``Hkv`` kv heads on a card of ``sms`` SMs: 128 when
    128-row blocks (one per kv head and 128 // (Hq/Hkv) positions,
    ``prefill_grid``) still number ``PREFILL_BLOCKS_PER_SM`` per SM, else
    64. Shapes in only."""
    if min(T, Hq, Hkv, sms) < 1 or Hq % Hkv:
        raise ValueError(f"no prefill plan for T={T}, Hq={Hq}, Hkv={Hkv}, "
                         f"sms={sms}")
    rows = PREFILL_ROWS[-1]
    blocks = Hkv * prefill_grid(T, Hq // Hkv, rows)[1]
    return (rows if blocks >= PREFILL_BLOCKS_PER_SM * sms
            else PREFILL_ROWS[0])


def prefill_grid(T: int, g: int, rows: int) -> tuple[int, int]:
    """(positions a block, blocks a kv head) of K3 at GQA group ``g`` with
    ``rows``-row CUDA blocks: ``rows // g`` positions, and enough blocks to
    cover ``T`` (the launch's grid in ``csrc/prefill_attention.cu``)."""
    if not 1 <= g <= rows:
        raise ValueError(f"group {g} does not fit a {rows}-row block")
    bq = rows // g
    return bq, -(-T // bq)


def prefill_row_map(block: int, T: int, g: int,
                    rows: int) -> list[Optional[tuple[int, int]]]:
    """The (position, q head within the kv head's group) that each row
    of K3's CUDA block ``block`` (in launch order) loads and writes, or
    None for a row that loads no q and writes nothing: the kernel's
    ``row_pos`` map in plain Python, for tests. Rows r < bq * g map to
    (q0 + r // g, r % g); the ``rows % g`` rows left over, and rows whose
    position falls at or past ``T``, are masked."""
    bq, _ = prefill_grid(T, g, rows)
    q0 = block * bq
    out: list[Optional[tuple[int, int]]] = []
    for r in range(rows):
        pos = q0 + r // g if r < bq * g else T
        out.append((pos, r % g) if pos < T else None)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of card ``index``, looked up once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_group(g: int) -> int:
    """The compiled group capacity G (``DECODE_GROUPS``) that K1/K2 run a
    GQA group ``g`` of ``KERNEL_GROUPS`` on: the smallest G >= g; rows
    r >= g of G are masked (no q load, nothing written)."""
    for G in DECODE_GROUPS:
        if g <= G:
            return G
    raise ValueError(f"GQA group {g} above the kernels' "
                     f"{KERNEL_GROUPS[-1]}")


def kernel_smem_bytes(dtype: torch.dtype, hd: int, g: int, bt: int,
                      pool: str = "") -> int:
    """Shared memory one decode CUDA block uses at GQA group ``g``
    (mirrors ``smem_bytes`` in ``csrc/paged_decode_attention.cu`` and
    ``csrc/decode_attention.cu``, instantiated at ``decode_group(g)``):
    two stages of K and V tiles (and of their scale rows for a quantized
    pool), q rows, scores, row stats. ``dtype`` is the compute dtype of
    q."""
    g = decode_group(g)
    if pool == "int8":
        row = hd
    elif pool == "int4":
        row = hd // 2
    else:
        row = hd * torch.empty((), dtype=dtype).element_size()
    scales = 4 * bt * 4 if pool else 0
    return 4 * bt * row + scales + g * hd * 4 + g * bt * 4 + 3 * g * 4


def shape_gate(dtype: torch.dtype, hd: int, g: int,
               what: str = "dtype") -> str:
    """Why a kernel of this module cannot take (dtype, head_dim, GQA
    group) ("" when it can): all three are compiled for the same set."""
    if dtype not in KERNEL_DTYPES:
        return f"{what} {dtype} (kernel takes bfloat16/float32)"
    if hd not in KERNEL_HEAD_DIMS:
        return f"head_dim {hd} (kernel compiled for {KERNEL_HEAD_DIMS})"
    if g not in KERNEL_GROUPS:
        return (f"GQA group {g} (kernels take groups {KERNEL_GROUPS[0]}-"
                f"{KERNEL_GROUPS[-1]})")
    return ""


def kernel_gate(dtype: torch.dtype, hd: int, g: int, bt: int,
                pool: str = "") -> str:
    """Why a decode kernel (K1 with ``bt``-token blocks, K2 with its
    ``DECODE_TILE``-row tiles) cannot take this shape ("" when it can).
    ``dtype`` is the compute dtype (q and the output); ``pool`` is "" for
    KV storage in that dtype, or "int8"/"int4" for scaled storage."""
    if pool not in KERNEL_POOLS:
        return f"pool {pool!r} (kernel takes {KERNEL_POOLS[1:]} or none)"
    why = shape_gate(dtype, hd, g,
                     "pool dtype" if not pool else "compute dtype")
    if why:
        return why
    if pool and bt % 4:
        return f"block_tokens {bt} (quantized pools need a multiple of 4)"
    smem = kernel_smem_bytes(dtype, hd, g, bt, pool)
    if smem > MAX_SMEM_BYTES:
        return (f"block_tokens {bt} needs {smem} B of shared memory "
                f"(max {MAX_SMEM_BYTES})")
    return ""


def gather_blocks(cache: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[N, H, bt, hd] block pool + [S, MB] tables -> [S, H, MB*bt, hd]
    logical context rows (the pool gather of the plain paths)."""
    S, MB = tables.shape
    _, H, bt, hd = cache.shape
    g = cache[tables]                              # [S, MB, H, bt, hd]
    return g.permute(0, 2, 1, 3, 4).reshape(S, H, MB * bt, hd)


def gather_block_scales(scales: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """[N, H, bt] scale pool + [S, MB] tables -> [S, H, MB*bt]."""
    S, MB = tables.shape
    _, H, bt = scales.shape
    g = scales[tables]                             # [S, MB, H, bt]
    return g.permute(0, 2, 1, 3).reshape(S, H, MB * bt)


def pool_kind(q: torch.Tensor, k_cache: torch.Tensor,
              k_scale: Optional[torch.Tensor]) -> str:
    """"" for a pool in a float dtype, "int8" or "int4" for a scaled pool;
    an int4 pool is self-describing: its last dim is the packed hd/2."""
    if k_scale is None:
        return ""
    return "int4" if k_cache.shape[-1] * 2 == q.shape[-1] else "int8"


def paged_decode_attention_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [N, Hkv, bt, hd] (int4: [N, Hkv, bt, hd/2])
    v_cache: torch.Tensor,
    tables: torch.Tensor,     # [S, MB] int
    positions: torch.Tensor,  # [S] int
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv, bt] f32 (int8/int4)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch paged decode attention: the pool gathered through the
    tables, then ``decode_attention_ref``. Returns [S, Hq, hd] in q's
    dtype."""
    keys = gather_blocks(k_cache, tables)
    values = gather_blocks(v_cache, tables)
    if pool_kind(q, k_cache, k_scale) == "int4":
        # imported here: models.quant imports the ops package
        from localai_tpu_torch.models.quant import unpack_int4_lastdim

        keys = unpack_int4_lastdim(keys)
        values = unpack_int4_lastdim(values)
    if k_scale is not None:
        k_scale = gather_block_scales(k_scale, tables)
        v_scale = gather_block_scales(v_scale, tables)
    return decode_attention_ref(q, keys, values, positions, k_scale, v_scale,
                                sliding_window=sliding_window)


def paged_decode_attention_split_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [N, Hkv, bt, hd] (int4: [N, Hkv, bt, hd/2])
    v_cache: torch.Tensor,
    tables: torch.Tensor,     # [S, MB] int
    positions: torch.Tensor,  # [S] int
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv, bt] f32 (int8/int4)
    v_scale: Optional[torch.Tensor] = None,
    *,
    split_blocks: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch model of the kernel's split walk: split k of a slot
    folds table entries [k*split_blocks, (k+1)*split_blocks) clamped to
    the slot's walk [lo, nb) into an unnormalised (m, l, acc) with the
    -1e30 masking (a split with no live block gives (-1e30, 0, 0)), then
    the splits merge as the kernel's second pass does (an empty split
    adds nothing, so merging every split equals the kernel's merge of the
    live ones). For tests; the runner never calls it. Returns [S, Hq, hd]
    in q's dtype."""
    keys = gather_blocks(k_cache, tables)
    values = gather_blocks(v_cache, tables)
    if pool_kind(q, k_cache, k_scale) == "int4":
        from localai_tpu_torch.models.quant import unpack_int4_lastdim

        keys = unpack_int4_lastdim(keys)
        values = unpack_int4_lastdim(values)
    if k_scale is not None:
        k_scale = gather_block_scales(k_scale, tables)
        v_scale = gather_block_scales(v_scale, tables)
    return _split_walk_ref(q, keys, values, positions, k_scale, v_scale,
                           tile=k_cache.shape[2], per_split=split_blocks,
                           sliding_window=sliding_window)


def _split_walk_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    keys: torch.Tensor,       # [S, Hkv, R, hd] a slot's R context rows
    values: torch.Tensor,
    positions: torch.Tensor,  # [S] int
    k_scale: Optional[torch.Tensor],  # [S, Hkv, R] f32, or None
    v_scale: Optional[torch.Tensor],
    *,
    tile: int,
    per_split: int,
    sliding_window: Optional[int],
) -> torch.Tensor:
    """The split walk both decode kernels run, in plain PyTorch: the R
    rows are cut into ``tile``-row units (K1's table entries, K2's cache
    tiles); split k folds units [k*per_split, (k+1)*per_split) clamped to
    the slot's walk [lo, nb) into an unnormalised (m, l, acc) with the
    -1e30 masking (a split with no live unit gives (-1e30, 0, 0)), then
    the splits merge as the kernels' second pass does (an empty split adds
    nothing, so merging every split equals merging the live ones).
    Returns [S, Hq, hd] in q's dtype."""
    S, Hq, hd = q.shape
    Hkv, R = keys.shape[1], keys.shape[2]
    g = Hq // Hkv
    units = -(-R // tile)
    splits = -(-units // per_split)
    keys, values = keys.float(), values.float()
    if k_scale is not None:
        keys = keys * k_scale[..., None]
        values = values * v_scale[..., None]
    rows = splits * per_split * tile   # the tail past R is 0 and masked
    pad = (0, 0, 0, rows - R)
    keys = torch.nn.functional.pad(keys, pad)
    values = torch.nn.functional.pad(values, pad)
    qg = q.reshape(S, Hkv, g, hd).float() * hd ** -0.5
    scores = torch.einsum("skgh,sklh->skgl", qg, keys)
    pos = positions.long()
    idx = torch.arange(rows, device=q.device)[None, :]
    keep = (idx <= pos[:, None]) & (idx < R)
    nb = torch.clamp(pos // tile + 1, max=units)
    lo = torch.zeros_like(pos)
    if sliding_window is not None:
        keep &= idx > pos[:, None] - sliding_window
        lo = torch.clamp((pos - sliding_window + 1) // tile, min=0)
    scores = scores.masked_fill(~keep[:, None, None, :], _NEG_INF)
    first = torch.arange(splits, device=q.device)[None, :] * per_split
    live = (torch.maximum(first, lo[:, None])
            < torch.minimum(first + per_split, nb[:, None]))  # [S, splits]
    live = live[:, None, None, :]
    sc = scores.reshape(S, Hkv, g, splits, per_split * tile)
    m = sc.amax(-1)              # -1e30 where no row is kept  [S,Hkv,g,n]
    p = torch.exp(sc - m[..., None]) * live[..., None]
    l = p.sum(-1)
    acc = torch.einsum("skgnj,sknjh->skgnh", p,
                       values.reshape(S, Hkv, splits, per_split * tile, hd))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = ((w[..., None] * acc).sum(-2)
           / torch.clamp((w * l).sum(-1), min=1e-30)[..., None])
    return out.reshape(S, Hq, hd).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [S, Hkv, C, hd] (int8 with scales)
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [S] int
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv, C] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch contiguous decode attention: dequantize in f32, masked
    softmax in f32. Returns [S, Hq, hd] in q's dtype."""
    S, Hq, hd = q.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    keys = k_cache.float()
    values = v_cache.float()
    if k_scale is not None:
        keys = keys * k_scale[..., None]
        values = values * v_scale[..., None]
    qg = q.reshape(S, Hkv, g, hd).float() * hd ** -0.5
    scores = torch.einsum("skgh,sklh->skgl", qg, keys)
    idx = torch.arange(C, device=q.device)[None, None, None, :]
    pos = positions.long()[:, None, None, None]
    keep = idx <= pos
    if sliding_window is not None:
        keep &= idx > pos - sliding_window
    scores = scores.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skgl,sklh->skgh", probs, values)
    return out.reshape(S, Hq, hd).to(q.dtype)


def decode_attention_split_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [S, Hkv, C, hd] (int8 with scales)
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [S] int
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv, C] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
    *,
    split_tiles: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch model of K2's split walk: the cache row is cut into
    ``DECODE_TILE``-row tiles; split k of a slot folds tiles
    [k*split_tiles, (k+1)*split_tiles) clamped to the slot's walk [lo, nb)
    into an unnormalised (m, l, acc) with the -1e30 masking (a split with
    no live tile gives (-1e30, 0, 0)), then the splits merge as the
    kernel's second pass does. For tests; the runner never calls it.
    Returns [S, Hq, hd] in q's dtype."""
    return _split_walk_ref(q, k_cache, v_cache, positions, k_scale, v_scale,
                           tile=DECODE_TILE, per_split=split_tiles,
                           sliding_window=sliding_window)


def prefill_attention_ref(
    q: torch.Tensor,          # [T, Hq, hd]
    k: torch.Tensor,          # [Hkv, T, hd] head-major chunk
    v: torch.Tensor,
    length: int,
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch causal GQA prefill attention in f32: key j is kept for
    the row at position t when j <= t, j < length and j > t - window (the
    JAX package's ``prefill_mask``). Returns [T, Hq, hd] in q's dtype."""
    T, Hq, hd = q.shape
    Hkv = k.shape[0]
    g = Hq // Hkv
    qg = q.reshape(T, Hkv, g, hd).float() * hd ** -0.5
    scores = torch.einsum("tkgh,klh->kgtl", qg, k.float())
    t = torch.arange(T, device=q.device)
    keep = (t[:, None] >= t[None, :]) & (t[None, :] < length)
    if sliding_window is not None:
        keep &= t[None, :] > t[:, None] - sliding_window
    scores = scores.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgtl,klh->tkgh", probs, v.float())
    return out.reshape(T, Hq, hd).to(q.dtype)


def _check_cuda(q: torch.Tensor, tensors, aligned=()) -> None:
    """Device, contiguity and 16-byte alignment of a kernel's operands."""
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _fn(name: str, argtypes):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PAGED_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p]
_DECODE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]
_PREFILL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def paged_decode_attention(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [N, Hkv, bt, hd] block pool
                              # (int4: nibble-packed [N, Hkv, bt, hd/2])
    v_cache: torch.Tensor,
    tables: torch.Tensor,     # [S, MB] int32 per-slot block tables
    positions: torch.Tensor,  # [S] int32 — current token's KV position
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv, bt] f32 (int8/int4)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    split_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA decode attention over a paged block pool. Returns
    [S, Hq, hd] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise: one CUDA block per (split of the
    slot's block table, kv head, slot), then a merge of the splits.
    ``split_blocks`` (tests and the smoke only) forces the table entries
    per split — MB is a single walk, 1 the finest split; None takes
    ``paged_split_plan``. One call counts one launch."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_cache, v_cache, tables, positions, k_scale, v_scale,
            sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    S, Hq, hd = q.shape
    N, Hkv, bt, row = k_cache.shape
    MB = tables.shape[1]
    pool = pool_kind(q, k_cache, k_scale)
    if ((row * 2 if pool == "int4" else row) != hd
            or v_cache.shape != k_cache.shape or Hq % Hkv
            or tables.shape[0] != S or positions.shape != (S,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pool "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, tables "
            f"{tuple(tables.shape)}, positions {tuple(positions.shape)}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("tables", tables), ("positions", positions)]
    if pool:
        if v_scale is None:
            raise ValueError("k_scale given without v_scale")
        if not (k_cache.dtype == v_cache.dtype == torch.int8):
            raise ValueError(f"a scaled pool must be int8, got "
                             f"{k_cache.dtype}/{v_cache.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (N, Hkv, bt) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {(N, Hkv, bt)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    elif not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"dtype mismatch: q {q.dtype}, pool {k_cache.dtype}")
    why = kernel_gate(q.dtype, hd, Hq // Hkv, bt, pool)
    if why:
        raise ValueError(f"paged decode kernel does not take {why}")
    for name, t in (("tables", tables), ("positions", positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    _check_cuda(q, tensors, ("k_cache", "v_cache", "k_scale", "v_scale"))
    if split_blocks is None:
        index = q.device.index
        bps, splits = _device_plan(S, Hkv, MB, pool,
                                   torch.cuda.current_device()
                                   if index is None else index)
    elif 1 <= split_blocks <= MB:
        bps, splits = split_blocks, -(-MB // split_blocks)
    else:
        raise ValueError(f"split_blocks {split_blocks} outside [1, {MB}]")
    window = int(sliding_window or 0)
    out = torch.empty_like(q)
    # the splits' f32 (m, l, acc), which the kernel lays out in one buffer
    part = torch.empty(S * Hq * splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    fn = _fn("paged_decode_attention", _PAGED_ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if pool else 0,
            v_scale.data_ptr() if pool else 0,
            tables.data_ptr(), positions.data_ptr(), part.data_ptr(),
            out.data_ptr(),
            S, Hq, Hkv, hd, bt, MB, window, bps, splits,
            int(q.dtype == torch.bfloat16), KERNEL_POOLS.index(pool),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed (code {rc})")
    _build.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0


def decode_attention(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [S, Hkv, C, hd] head-major slot cache
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [S] int32 — current token's KV position
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv, C] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    split_tiles: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA decode attention over the contiguous slot cache. Returns
    [S, Hq, hd] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise: one CUDA block per (split of the
    slot's ``DECODE_TILE``-row tiles, kv head, slot), then a merge of the
    splits. ``split_tiles`` (tests and the smoke only) forces the tiles
    per split — ceil(C / DECODE_TILE) is a single walk, 1 the finest
    split; None takes ``decode_split_plan``. One call counts one
    launch."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, k_scale,
                                    v_scale, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    S, Hq, hd = q.shape
    _, Hkv, C, _ = k_cache.shape
    if (k_cache.shape != (S, Hkv, C, hd) or v_cache.shape != k_cache.shape
            or Hq % Hkv or positions.shape != (S,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, positions "
            f"{tuple(positions.shape)}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("positions", positions)]
    pool = "" if k_scale is None else "int8"
    if pool:
        if v_scale is None:
            raise ValueError("k_scale given without v_scale")
        if not (k_cache.dtype == v_cache.dtype == torch.int8):
            raise ValueError(f"a scaled cache must be int8, got "
                             f"{k_cache.dtype}/{v_cache.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (S, Hkv, C) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {(S, Hkv, C)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        if C % 4:
            raise ValueError(f"an int8 cache needs a context that is a "
                             f"multiple of 4, got {C}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    elif not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"dtype mismatch: q {q.dtype}, cache {k_cache.dtype}")
    why = kernel_gate(q.dtype, hd, Hq // Hkv, DECODE_TILE, pool)
    if why:
        raise ValueError(f"decode kernel does not take {why}")
    if positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32, got {positions.dtype}")
    _check_cuda(q, tensors, ("k_cache", "v_cache", "k_scale", "v_scale"))
    ntiles = -(-C // DECODE_TILE)
    if split_tiles is None:
        index = q.device.index
        tps, splits = _decode_device_plan(S, Hkv, C, pool,
                                          torch.cuda.current_device()
                                          if index is None else index)
    elif 1 <= split_tiles <= ntiles:
        tps, splits = split_tiles, -(-ntiles // split_tiles)
    else:
        raise ValueError(f"split_tiles {split_tiles} outside [1, {ntiles}]")
    out = torch.empty_like(q)
    # the splits' f32 (m, l, acc), which the kernel lays out in one buffer
    part = torch.empty(S * Hq * splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    fn = _fn("decode_attention", _DECODE_ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if pool else 0,
            v_scale.data_ptr() if pool else 0,
            positions.data_ptr(), part.data_ptr(), out.data_ptr(), S, Hq,
            Hkv, hd, C, int(sliding_window or 0), tps, splits,
            int(q.dtype == torch.bfloat16), int(bool(pool)), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed (code {rc})")
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0


def prefill_attention(
    q: torch.Tensor,          # [T, Hq, hd]
    k: torch.Tensor,          # [Hkv, T, hd] head-major chunk
    v: torch.Tensor,          # [Hkv, T, hd]
    length: int,              # real (unpadded) length, a host int
    *,
    sliding_window: Optional[int] = None,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Flash causal GQA prefill attention for one sequence. Returns
    [T, Hq, hd] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel (one CUDA block per (kv head, tile of query
    positions)) or raise. ``block_rows`` (tests and the smoke only) forces
    the query rows of a bf16 CUDA block, one of ``PREFILL_ROWS``; None
    takes ``prefill_block_rows``."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v, length,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    T, Hq, hd = q.shape
    Hkv = k.shape[0]
    if (k.shape != (Hkv, T, hd) or v.shape != k.shape or Hq % Hkv
            or T < 1):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: q {q.dtype}, k/v {k.dtype}/"
                         f"{v.dtype}")
    why = shape_gate(q.dtype, hd, Hq // Hkv)
    if why:
        raise ValueError(f"prefill kernel does not take {why}")
    _check_cuda(q, [("q", q), ("k", k), ("v", v)], ("k", "v"))
    if block_rows is None:
        index = q.device.index
        block_rows = prefill_block_rows(
            T, Hq, Hkv, _sm_count(
                torch.cuda.current_device() if index is None else index))
    elif block_rows not in PREFILL_ROWS:
        raise ValueError(f"block_rows {block_rows} not one of "
                         f"{PREFILL_ROWS}")
    out = torch.empty_like(q)
    fn = _fn("prefill_attention", _PREFILL_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), T, Hq,
            Hkv, hd, int(length), int(sliding_window or 0), block_rows,
            int(q.dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prefill kernel launch failed (code {rc})")
    _build.count_launch(prefill_attention)
    return out


prefill_attention.launches = 0
