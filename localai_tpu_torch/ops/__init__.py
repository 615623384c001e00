"""Hand-written CUDA kernels and their selection policy.

``select_paged_attn_impl`` reports the paged decode attention path, in the
spirit of ``select_paged_attn_impl`` in ``localai_tpu/ops/__init__.py``.
Decode always calls ``ops.attention.paged_decode_attention``; the wrapper
launches the CUDA kernel for CUDA tensors ("kernel") and runs its plain
PyTorch version for CPU tensors ("torch"). The TPU's Mosaic tiling gates do
not apply on Hopper; the card's gates are the head dims, GQA groups and
dtypes the kernel was compiled for. A shape the kernel does not take
raises — it is not rerouted.
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
                           kv_dtype: torch.dtype) -> tuple[str, str]:
    """Returns (impl, reason): "kernel" on a CUDA device (raising when the
    kernel cannot take the shape), "torch" on the CPU."""
    if torch.device(device).type != "cuda":
        return "torch", "CPU tensors: the wrapper runs its plain version"
    if num_heads % num_kv_heads:
        raise ValueError(f"heads ({num_heads} q / {num_kv_heads} kv) "
                         "not grouped")
    why = kernel_gate(kv_dtype, head_dim, num_heads // num_kv_heads,
                      block_tokens)
    if why:
        raise ValueError(f"paged decode kernel does not take {why}")
    return "kernel", ""
