"""Hand-written CUDA kernels and their selection policy.

``select_paged_attn_impl`` reports the paged decode attention path, in the
spirit of ``select_paged_attn_impl`` in ``localai_tpu/ops/__init__.py``.
Decode always calls ``ops.attention.paged_decode_attention``; the wrapper
launches the CUDA kernel for CUDA tensors ("kernel") and runs its plain
PyTorch version for CPU tensors ("torch"). The TPU's Mosaic tiling gates do
not apply on Hopper; the card's gates are the head dims, GQA groups,
dtypes and pool kinds (bf16/f32, scaled int8, int4) the kernel was
compiled for. A shape the kernel does not take raises — it is not
rerouted. The JAX package keeps its int4 pool off the Pallas kernel
unless hd % 256 == 0 (the packed hd/2 lane axis must tile for Mosaic);
the CUDA kernel takes int4 at every compiled head dim, hd=128 included.

``ops.qmatmul`` holds the quantized-weight matmul kernels (w8, w4).
"""

from __future__ import annotations

import torch

from localai_tpu_torch.ops.attention import (
    kernel_gate,
    paged_decode_attention,
    paged_decode_attention_ref,
)

__all__ = [
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "select_paged_attn_impl",
]


def select_paged_attn_impl(*, device: torch.device, num_heads: int,
                           num_kv_heads: int, head_dim: int,
                           block_tokens: int,
                           kv_dtype: torch.dtype | str,
                           dtype: torch.dtype | None = None,
                           ) -> tuple[str, str]:
    """Returns (impl, reason): "kernel" on a CUDA device (raising when the
    kernel cannot take the shape), "torch" on the CPU. ``kv_dtype`` is the
    pool's torch dtype, or "int8"/"int4" for a scaled pool; ``dtype`` is
    the compute dtype (q), which a float pool must equal."""
    if torch.device(device).type != "cuda":
        return "torch", "CPU tensors: the wrapper runs its plain version"
    if num_heads % num_kv_heads:
        raise ValueError(f"heads ({num_heads} q / {num_kv_heads} kv) "
                         "not grouped")
    if kv_dtype in ("int8", "int4"):
        pool, qdtype = kv_dtype, dtype
    else:
        pool, qdtype = "", kv_dtype
        if dtype is not None and dtype != kv_dtype:
            raise ValueError(
                f"the paged decode kernel needs the KV pool in the compute "
                f"dtype ({dtype}) or a scaled int8/int4 pool, got {kv_dtype}")
    why = kernel_gate(qdtype, head_dim, num_heads // num_kv_heads,
                      block_tokens, pool)
    if why:
        raise ValueError(f"paged decode kernel does not take {why}")
    return "kernel", ""
