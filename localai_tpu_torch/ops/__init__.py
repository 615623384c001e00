"""Hand-written CUDA kernels and their selection policy.

``select_paged_attn_impl`` reports the paged decode attention path (K1),
``select_attn_impl`` the contiguous decode (K2) and prefill (K3) path, in
the spirit of the functions of the same names in
``localai_tpu/ops/__init__.py``. There is one attention path per device:
on a CUDA device both return "kernel" or raise, and the runner's wrappers
launch the CUDA kernels; on the CPU both return "torch", and the wrappers
run their plain PyTorch versions. No shape is sent to a plain version on
the card: a shape the kernels do not take is refused when the runner is
built. The card's gates are the head dims (32/64/128), the GQA groups
(1-16: K1/K2 run a group on the next compiled group capacity with the
rows past it masked, K3 reads it at run time), the dtypes, the KV storage
kinds (bf16/f32 in the compute dtype, scaled int8, int4 for pools only),
the shared memory of a ``block_tokens`` tile, quantized pools' bt % 4 and
an int8 contiguous cache's context % 4. The TPU's Mosaic tiling gates
(128-aligned head dims and contexts) do not apply on Hopper. The JAX
package keeps its int4 pool off the Pallas kernel unless hd % 256 == 0
(the packed hd/2 lane axis must tile for Mosaic); the CUDA kernel takes
int4 at every compiled head dim, hd=128 included.

``resolve_attn_impl`` reads and checks the JAX package's attention
setting (``engine.attn_impl``, ``LOCALAI_ATTN_IMPL``,
``LOCALAI_PAGED_ATTN_IMPL``) as that package does, and selects nothing:
every accepted value runs the one path of the device.

``paged_gate`` says why K1 cannot take a paged shape ("" when it can):
``select_paged_attn_impl`` raises on its reason, the runner drops a
tuning table entry's block size on it (``ops.tuning``) and keeps the
default, and the sweep (``tools.autotune``) skips a block on it.

``ops.qmatmul`` holds the quantized-weight matmul kernels (w8, w4).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from localai_tpu_torch.ops.attention import (
    DECODE_TILE,
    decode_attention,
    decode_attention_ref,
    kernel_gate,
    paged_decode_attention,
    paged_decode_attention_ref,
    prefill_attention,
    prefill_attention_ref,
    shape_gate,
)

__all__ = [
    "decode_attention",
    "decode_attention_ref",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "prefill_attention",
    "prefill_attention_ref",
    "resolve_attn_impl",
    "local_heads",
    "paged_gate",
    "select_attn_impl",
    "select_paged_attn_impl",
]


# the values the JAX package accepts: "pallas" (its TPU kernels), "xla"
# (its plain XLA attention), "pallas_interpret" (the kernels interpreted,
# for its CPU tests), "auto"
ATTN_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")


def resolve_attn_impl(requested: str = "auto", *, paged: bool = False) -> str:
    """The attention setting as the JAX package resolves it: an explicit
    per-model value wins; "auto" or "" takes ``LOCALAI_ATTN_IMPL`` (with
    ``paged``: ``LOCALAI_PAGED_ATTN_IMPL``). Returns the value (one of
    ``ATTN_IMPLS``) and raises ``ValueError`` with the JAX package's
    message for any other. It moves nothing: the runner logs a value that
    names the TPU's XLA path and runs its device's one path whatever the
    value."""
    impl = requested
    if impl in ("auto", ""):
        impl = os.environ.get("LOCALAI_PAGED_ATTN_IMPL" if paged
                              else "LOCALAI_ATTN_IMPL", "") or "auto"
    if impl not in ATTN_IMPLS:
        what = "paged attention" if paged else "attention"
        raise ValueError(f"unknown {what} impl {impl!r}")
    return impl


def _kv_storage(kv_dtype, dtype, kernel: str) -> tuple[str, torch.dtype]:
    """(pool kind, q's dtype) of a KV storage request: "int8"/"int4" are
    scaled storage read with the compute dtype ``dtype``; a float storage
    dtype must equal the compute dtype (when given)."""
    if kv_dtype in ("int8", "int4"):
        return kv_dtype, dtype
    if dtype is not None and dtype != kv_dtype:
        raise ValueError(
            f"the {kernel} kernel needs the KV cache in the compute dtype "
            f"({dtype}) or scaled int8 storage, got {kv_dtype}")
    return "", kv_dtype


def local_heads(num_heads: int, num_kv_heads: int, tp: int = 1
                ) -> tuple[int, int]:
    """(q heads, kv heads) one rank of a ``tp``-wide tensor-parallel mesh
    attends over: Hq/tp, and Hkv/tp or, when tp is a multiple of Hkv (the
    replicate fallback, ``parallel.sharding``), the one kv head its q
    heads read. The kernels see only these."""
    if tp <= 1:
        return num_heads, num_kv_heads
    if num_heads % tp:
        raise ValueError(f"num_heads {num_heads} not divisible by "
                         f"tensor_parallel {tp}")
    if num_kv_heads % tp == 0:
        return num_heads // tp, num_kv_heads // tp
    if tp % num_kv_heads:
        raise ValueError(f"kv heads ({num_kv_heads}) neither divisible by "
                         f"nor dividing tensor_parallel ({tp})")
    return num_heads // tp, 1


def paged_gate(*, num_heads: int, num_kv_heads: int, head_dim: int,
               block_tokens: int, kv_dtype: torch.dtype | str,
               dtype: torch.dtype | None = None, tp: int = 1) -> str:
    """Why K1 on the card cannot take this paged shape, as the message to
    raise ("" when it can): a pure function of the shape and the dtypes,
    which ``select_paged_attn_impl`` takes. With ``tp`` > 1 it judges
    the group one rank attends over (``local_heads``), as the JAX
    package's gate judges the local group under a mesh."""
    if num_heads % num_kv_heads:
        return f"heads ({num_heads} q / {num_kv_heads} kv) not grouped"
    try:
        num_heads, num_kv_heads = local_heads(num_heads, num_kv_heads, tp)
    except ValueError as e:
        return str(e)
    if num_heads % num_kv_heads:
        return f"heads ({num_heads} q / {num_kv_heads} kv) not grouped"
    try:
        pool, qdtype = _kv_storage(kv_dtype, dtype, "paged decode")
    except ValueError as e:
        return str(e)
    why = kernel_gate(qdtype, head_dim, num_heads // num_kv_heads,
                      block_tokens, pool)
    return f"paged decode kernel does not take {why}" if why else ""


def select_paged_attn_impl(*, device: torch.device, num_heads: int,
                           num_kv_heads: int, head_dim: int,
                           block_tokens: int,
                           kv_dtype: torch.dtype | str,
                           dtype: torch.dtype | None = None,
                           tp: int = 1) -> tuple[str, str]:
    """Returns (impl, reason): "kernel" on a CUDA device (raising
    ``paged_gate``'s reason when the kernel cannot take the shape),
    "torch" on the CPU. ``kv_dtype`` is the pool's torch dtype, or
    "int8"/"int4" for a scaled pool; ``dtype`` is the compute dtype (q),
    which a float pool must equal; ``tp`` the tensor-parallel width (the
    gate judges one rank's group)."""
    if torch.device(device).type != "cuda":
        return "torch", "CPU tensors: the wrapper runs its plain version"
    why = paged_gate(num_heads=num_heads, num_kv_heads=num_kv_heads,
                     head_dim=head_dim, block_tokens=block_tokens,
                     kv_dtype=kv_dtype, dtype=dtype, tp=tp)
    if why:
        raise ValueError(why)
    return "kernel", ""


def select_attn_impl(*, device: torch.device, num_heads: int,
                     num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                     kv_dtype: torch.dtype | str | None = None,
                     max_ctx: Optional[int] = None) -> tuple[str, str]:
    """Returns (impl, reason) for the prefill kernel (K3, which every
    runner's embeddings forward runs) and, when ``kv_dtype`` is given (a
    contiguous runner), the contiguous decode kernel (K2) over a cache of
    ``max_ctx`` rows: "kernel" on a CUDA device (raising when a kernel
    cannot take the shape), "torch" on the CPU. ``dtype`` is the compute
    dtype; ``kv_dtype`` the cache's torch dtype, or "int8" for a scaled
    cache (there is no int4 contiguous cache)."""
    if torch.device(device).type != "cuda":
        return "torch", "CPU tensors: the wrappers run their plain versions"
    if num_heads % num_kv_heads:
        raise ValueError(f"heads ({num_heads} q / {num_kv_heads} kv) "
                         "not grouped")
    g = num_heads // num_kv_heads
    why = shape_gate(dtype, head_dim, g)
    if why:
        raise ValueError(f"prefill kernel does not take {why}")
    if kv_dtype is None:
        return "kernel", ""
    if kv_dtype == "int4":
        raise ValueError("the contiguous KV cache has no int4 storage "
                         "(int4 needs the paged layout)")
    pool, qdtype = _kv_storage(kv_dtype, dtype, "decode")
    why = kernel_gate(qdtype, head_dim, g, DECODE_TILE, pool)
    if not why and pool and max_ctx is not None and max_ctx % 4:
        why = f"context {max_ctx} (an int8 cache needs a multiple of 4)"
    if why:
        raise ValueError(f"decode kernel does not take {why}")
    return "kernel", ""
