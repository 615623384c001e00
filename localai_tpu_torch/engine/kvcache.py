"""Paged KV cache: one block pool shared by all slots through block tables.

Port of the paged subset of ``localai_tpu/engine/kvcache.py``. Layout:
k, v each [L, N, Hkv, bt, hd] — N physical blocks of bt tokens; the host
bookkeeping (free list, tables, prefix pool) is ``engine.paged``. Block 0
is the trash block: inactive slots' table rows are all zeros, so their
static-shape writes land there.

The JAX package returns an updated pool from every write and relies on
buffer donation to make that in place; here the write policies update the
pool in place directly (``index_put_`` on the layer's view of the stacked
tensor). Only bf16 and f32 pools are ported; scaled int8 and int4 pools
raise.
"""

from __future__ import annotations

import dataclasses

import torch

from localai_tpu_torch.models.llama import LlamaConfig, torch_dtype
from localai_tpu_torch.ops.attention import gather_blocks
from localai_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """k, v: [L, N, Hkv, bt, hd]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_tokens(self) -> int:
        return self.k.shape[3]

    def stacked(self):
        """The tuple whose per-layer views models.llama.forward hands to
        the write policy."""
        return (self.k, self.v)


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_tokens: int,
                     dtype: str = "bfloat16",
                     device: str | torch.device = "cuda") -> PagedKVCache:
    if str(dtype) in ("int8", "int4"):
        raise NotImplementedError(
            f"{dtype} KV pools are not ported to PyTorch yet "
            "(bfloat16/float32 only)")
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_tokens,
             cfg.hd)
    dt = torch_dtype(dtype)
    device = resolve_device(device)
    return PagedKVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device))


def paged_decode_write(tables: torch.Tensor, positions: torch.Tensor):
    """KV write policy for batched single-token decode over a block pool.

    tables: [S, MB] block tables, positions: [S]. Writes k/v_new
    [S, 1, H, hd] at pool[tables[s, pos//bt], :, pos%bt] in place and
    passes the layer's pool through: ``ops.paged_decode_attention`` walks
    the tables itself."""

    def write(layer_kv, k_new, v_new):
        k_layer, v_layer = layer_kv               # [N, H, bt, hd] views
        bt = k_layer.shape[2]
        s = torch.arange(tables.shape[0], device=tables.device)
        blk = tables[s, positions // bt]          # [S]
        off = positions % bt
        # in place (the JAX package's donated functional update)
        k_layer[blk, :, off] = k_new[:, 0].to(k_layer.dtype)
        v_layer[blk, :, off] = v_new[:, 0].to(v_layer.dtype)
        return layer_kv, k_layer, v_layer

    return write


def paged_prefill_write(table_row: torch.Tensor, offset: int, length: int):
    """KV write policy for one chunked-prefill dispatch into a block table.

    table_row: [MB], offset: absolute start position of this chunk,
    length: real (unpadded) tokens in the chunk. Token t lands at
    pool[table_row[(offset+t)//bt], :, (offset+t)%bt]; padding rows
    (t >= length) are redirected to the trash block. Exposes the gathered
    full logical context [1, H, MB*bt, hd] so chunk tokens attend over the
    kept prefix + earlier chunks (resume-style)."""

    def write(layer_kv, k_new, v_new):  # k_new [1, T, H, hd]
        k_layer, v_layer = layer_kv
        bt = k_layer.shape[2]
        MB = table_row.shape[0]
        T = k_new.shape[1]
        t = torch.arange(T, device=table_row.device)
        pos = offset + t
        blk = torch.where(t < length,
                          table_row[(pos // bt).clamp(max=MB - 1)],
                          torch.zeros_like(table_row[:1]))
        off = pos % bt
        k_layer[blk, :, off] = k_new[0].to(k_layer.dtype)
        v_layer[blk, :, off] = v_new[0].to(v_layer.dtype)
        row = table_row[None]                     # [1, MB]
        dt = k_new.dtype
        return (layer_kv, gather_blocks(k_layer, row).to(dt),
                gather_blocks(v_layer, row).to(dt))

    return write


def resume_mask(cfg: LlamaConfig, seq_len: int, offset: int, max_ctx: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """[1, T, C] mask for chunked prefill: chunk token t (absolute position
    offset+t) attends causally over the kept prefix + the chunk."""
    device = resolve_device(device)
    t = torch.arange(seq_len, device=device)[None, :, None]
    c = torch.arange(max_ctx, device=device)[None, None, :]
    pos = offset + t
    m = c <= pos
    if cfg.sliding_window:
        m &= c > pos - cfg.sliding_window
    return m

