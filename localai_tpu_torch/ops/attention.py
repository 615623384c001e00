"""Paged decode attention: the hand-written CUDA kernel and its plain version.

Port of ``localai_tpu/ops/attention.py::paged_decode_attention`` (the
Pallas TPU kernel ``_paged_decode_kernel``). The CUDA source is
``csrc/paged_decode_attention.cu``; it is built with nvcc for sm_90a at
first use (``ops._build``) and called through a plain C interface.

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
MAX_SMEM_BYTES = 232448  # H100 opt-in shared memory per block


def kernel_smem_bytes(dtype: torch.dtype, hd: int, g: int, bt: int) -> int:
    """Shared memory one CUDA block uses (mirrors ``smem_bytes`` in the
    source): two stages of K and V tiles, q rows, scores, row stats."""
    elem = torch.empty((), dtype=dtype).element_size()
    return 4 * bt * hd * elem + g * hd * 4 + g * bt * 4 + 3 * g * 4


def kernel_gate(dtype: torch.dtype, hd: int, g: int, bt: int) -> str:
    """Why the kernel cannot take this shape ("" when it can)."""
    if dtype not in KERNEL_DTYPES:
        return f"pool dtype {dtype} (kernel takes bfloat16/float32)"
    if hd not in KERNEL_HEAD_DIMS:
        return f"head_dim {hd} (kernel compiled for {KERNEL_HEAD_DIMS})"
    if g not in KERNEL_GROUPS:
        return f"GQA group {g} (kernel compiled for {KERNEL_GROUPS})"
    smem = kernel_smem_bytes(dtype, hd, g, bt)
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


def paged_decode_attention_ref(
    q: torch.Tensor,          # [S, Hq, hd]
    k_cache: torch.Tensor,    # [N, Hkv, bt, hd]
    v_cache: torch.Tensor,
    tables: torch.Tensor,     # [S, MB] int
    positions: torch.Tensor,  # [S] int
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch paged decode attention (gather + masked softmax in
    f32) for bf16/f32 pools. Returns [S, Hq, hd] in q's dtype."""
    S, Hq, hd = q.shape
    Hkv, bt = k_cache.shape[1], k_cache.shape[2]
    MB = tables.shape[1]
    g = Hq // Hkv
    keys = gather_blocks(k_cache, tables).float()
    values = gather_blocks(v_cache, tables).float()
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


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
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
    v_cache: torch.Tensor,
    tables: torch.Tensor,     # [S, MB] int32 per-slot block tables
    positions: torch.Tensor,  # [S] int32 — current token's KV position
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA decode attention over a paged block pool. Returns
    [S, Hq, hd] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel (one CUDA block per (slot, kv head), walking
    the slot's block table) or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_cache, v_cache, tables, positions,
            sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    S, Hq, hd = q.shape
    N, Hkv, bt, hd_k = k_cache.shape
    MB = tables.shape[1]
    if (hd_k != hd or v_cache.shape != k_cache.shape or Hq % Hkv
            or tables.shape[0] != S or positions.shape != (S,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pool "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, tables "
            f"{tuple(tables.shape)}, positions {tuple(positions.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"dtype mismatch: q {q.dtype}, pool {k_cache.dtype}")
    why = kernel_gate(q.dtype, hd, Hq // Hkv, bt)
    if why:
        raise ValueError(f"paged decode kernel does not take {why}")
    for name, t in (("tables", tables), ("positions", positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("tables", tables), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("pool must be 16-byte aligned")
    window = int(sliding_window or 0)
    out = torch.empty_like(q)
    fn = _lib()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            S, Hq, Hkv, hd, bt, MB, window,
            int(q.dtype == torch.bfloat16), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed (code {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
