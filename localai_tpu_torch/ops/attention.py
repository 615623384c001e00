"""Paged decode attention: the hand-written CUDA kernel and its plain version.

Port of ``localai_tpu/ops/attention.py::paged_decode_attention`` (the
Pallas TPU kernel ``_paged_decode_kernel``) for bf16/f32 pools and for
scaled int8 and int4 pools (``k_scale``/``v_scale`` [N, Hkv, bt] f32; an
int4 pool is nibble-packed and detected, as in the JAX package, by its
last dim hd/2). The CUDA source is ``csrc/paged_decode_attention.cu``; it
is built with nvcc for sm_90a at first use (``ops._build``) and called
through a plain C interface.

``paged_decode_attention`` takes a CPU tensor to the plain PyTorch version
(``paged_decode_attention_ref``) and launches the kernel for a CUDA
tensor; a CUDA shape the kernel was not compiled for raises — there is no
fallback. ``paged_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from localai_tpu_torch.ops import _build

_NEG_INF = -1e30

# what csrc/paged_decode_attention.cu is compiled for
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# pool storage the kernel reads: the compute dtype itself (""), or
# scaled int8 / int4 (the source's template parameter P = 0, 1, 2)
KERNEL_POOLS = ("", "int8", "int4")
MAX_SMEM_BYTES = 232448  # H100 opt-in shared memory per block


def kernel_smem_bytes(dtype: torch.dtype, hd: int, g: int, bt: int,
                      pool: str = "") -> int:
    """Shared memory one CUDA block uses (mirrors ``smem_bytes`` in the
    source): two stages of K and V tiles (and of their scale rows for a
    quantized pool), q rows, scores, row stats. ``dtype`` is the compute
    dtype of q."""
    if pool == "int8":
        row = hd
    elif pool == "int4":
        row = hd // 2
    else:
        row = hd * torch.empty((), dtype=dtype).element_size()
    scales = 4 * bt * 4 if pool else 0
    return 4 * bt * row + scales + g * hd * 4 + g * bt * 4 + 3 * g * 4


def kernel_gate(dtype: torch.dtype, hd: int, g: int, bt: int,
                pool: str = "") -> str:
    """Why the kernel cannot take this shape ("" when it can). ``dtype``
    is the compute dtype (q and the output); ``pool`` is "" for a pool in
    that dtype, or "int8"/"int4" for a scaled quantized pool."""
    if dtype not in KERNEL_DTYPES:
        what = "pool dtype" if not pool else "compute dtype"
        return f"{what} {dtype} (kernel takes bfloat16/float32)"
    if pool not in KERNEL_POOLS:
        return f"pool {pool!r} (kernel takes {KERNEL_POOLS[1:]} or none)"
    if hd not in KERNEL_HEAD_DIMS:
        return f"head_dim {hd} (kernel compiled for {KERNEL_HEAD_DIMS})"
    if g not in KERNEL_GROUPS:
        return f"GQA group {g} (kernel compiled for {KERNEL_GROUPS})"
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
    """Plain PyTorch paged decode attention (gather + masked softmax in
    f32) for bf16/f32, scaled-int8 and nibble-packed int4 pools. Returns
    [S, Hq, hd] in q's dtype."""
    S, Hq, hd = q.shape
    Hkv, bt = k_cache.shape[1], k_cache.shape[2]
    MB = tables.shape[1]
    g = Hq // Hkv
    keys = gather_blocks(k_cache, tables)
    values = gather_blocks(v_cache, tables)
    if pool_kind(q, k_cache, k_scale) == "int4":
        # imported here: models.quant imports the ops package
        from localai_tpu_torch.models.quant import unpack_int4_lastdim

        keys = unpack_int4_lastdim(keys)
        values = unpack_int4_lastdim(values)
    keys = keys.float()
    values = values.float()
    if k_scale is not None:
        keys = keys * gather_block_scales(k_scale, tables)[..., None]
        values = values * gather_block_scales(v_scale, tables)[..., None]
    qg = q.reshape(S, Hkv, g, hd).float() * hd ** -0.5
    scores = torch.einsum("skgh,sklh->skgl", qg, keys)
    idx = torch.arange(MB * bt, device=q.device)[None, None, None, :]
    pos = positions.long()[:, None, None, None]
    keep = idx <= pos
    if sliding_window is not None:
        keep &= idx > pos - sliding_window
    scores = scores.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skgl,sklh->skgh", probs, values)
    return out.reshape(S, Hq, hd).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p]


def _lib():
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
) -> torch.Tensor:
    """Flash GQA decode attention over a paged block pool. Returns
    [S, Hq, hd] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel (one CUDA block per (slot, kv head), walking
    the slot's block table) or raise."""
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
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("k_cache", "v_cache", "k_scale", "v_scale") and (
                t.data_ptr() % 16):
            raise ValueError(f"{name} must be 16-byte aligned")
    window = int(sliding_window or 0)
    out = torch.empty_like(q)
    fn = _lib()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if pool else 0,
            v_scale.data_ptr() if pool else 0,
            tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            S, Hq, Hkv, hd, bt, MB, window,
            int(q.dtype == torch.bfloat16), KERNEL_POOLS.index(pool),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed (code {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
