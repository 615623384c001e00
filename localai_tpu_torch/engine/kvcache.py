"""Paged KV cache: one block pool shared by all slots through block tables.

Port of the paged subset of ``localai_tpu/engine/kvcache.py``. Layout:
k, v each [L, N, Hkv, bt, hd] — N physical blocks of bt tokens; the host
bookkeeping (free list, tables, prefix pool) is ``engine.paged``. Block 0
is the trash block: inactive slots' table rows are all zeros, so their
static-shape writes land there.

Scaled int8 pools hold symmetric per-(block, head, position) int8 rows
with f32 scales k_scale/v_scale [L, N, Hkv, bt] (``quant.quantize_lastdim``);
int4 pools hold nibble-packed int8 rows of hd/2 bytes in the halves layout
(``quant.quantize_lastdim4``) with the same scale shape. The packed last
dim is how every consumer tells int4 from int8, as in the JAX package.

The JAX package returns an updated pool from every write and relies on
buffer donation to make that in place; here the write policies update the
pool in place directly, on the layer's view of the stacked tensor
(``index_copy_`` for decode, an indexed assignment for prefill).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from localai_tpu_torch.models import quant
from localai_tpu_torch.models.llama import LlamaConfig, torch_dtype
from localai_tpu_torch.ops.attention import gather_block_scales, gather_blocks
from localai_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """k, v: [L, N, Hkv, bt, hd] (int4: hd/2); k_scale, v_scale:
    [L, N, Hkv, bt] f32 for scaled int8/int4 pools, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_tokens(self) -> int:
        return self.k.shape[3]

    def stacked(self):
        """The tuple whose per-layer views models.llama.forward hands to
        the write policy: (k, v), or (k, v, k_scale, v_scale)."""
        if self.k_scale is None:
            return (self.k, self.v)
        return (self.k, self.v, self.k_scale, self.v_scale)


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_tokens: int,
                     dtype: str = "bfloat16",
                     device: str | torch.device = "cuda") -> PagedKVCache:
    device = resolve_device(device)
    int4 = str(dtype) == "int4"
    if int4 and cfg.hd % 2:
        raise ValueError(f"int4 KV needs an even head_dim, got {cfg.hd}")
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_tokens,
             cfg.hd // 2 if int4 else cfg.hd)
    if int4 or str(dtype) == "int8":
        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=device)

        return PagedKVCache(k=zeros(shape, torch.int8),
                            v=zeros(shape, torch.int8),
                            k_scale=zeros(shape[:4], torch.float32),
                            v_scale=zeros(shape[:4], torch.float32))
    dt = torch_dtype(dtype)
    return PagedKVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device))


def _pool_quant(layer_kv, k_new: torch.Tensor):
    """The quantizer matching a paged pool's storage: int4 when the pool's
    last dim is the packed hd/2, else int8. ``k_new`` carries the full
    head_dim."""
    int4 = layer_kv[0].shape[-1] * 2 == k_new.shape[-1]
    return (quant.quantize_lastdim4 if int4 else quant.quantize_lastdim), int4


def _gather_dequant(cache, scales, tables, dt, int4: bool) -> torch.Tensor:
    """Gather + dequantize a quantized pool's logical context:
    [S, H, MB*bt, hd] in ``dt`` (int4 pools unpack first), computed in
    ``dt`` as the JAX package does."""
    g = gather_blocks(cache, tables)
    if int4:
        g = quant.unpack_int4_lastdim(g)
    return g.to(dt) * gather_block_scales(scales, tables)[..., None].to(dt)


def paged_decode_write(tables: torch.Tensor, positions: torch.Tensor):
    """KV write policy for batched single-token decode over a block pool.

    tables: [S, MB] block tables, positions: [S]. Writes k/v_new
    [S, 1, H, hd] at pool[tables[s, pos//bt], :, pos%bt] in place and
    passes the layer's pool through: ``ops.paged_decode_attention`` walks
    the tables itself. A scaled pool passes (pool, scales) pairs.

    The flat pool row of every (slot, head) is the same in every layer, so
    it is computed once per step and each write is one ``index_copy_``
    (the host cost of an advanced-index assignment per tensor per layer
    is what the decode step spends its time on)."""
    rows = {}

    def flat_rows(H: int, bt: int) -> torch.Tensor:
        # [S*H] rows of the pool viewed as [N*H*bt, row], slot-major
        if (H, bt) not in rows:
            s = torch.arange(tables.shape[0], device=tables.device)
            blk = tables[s, positions // bt]          # [S]
            h = torch.arange(H, device=tables.device)
            rows[H, bt] = ((blk[:, None] * H + h[None, :]) * bt
                           + (positions % bt)[:, None]).reshape(-1)
        return rows[H, bt]

    def put(pool: torch.Tensor, idx: torch.Tensor, new: torch.Tensor):
        # in place (the JAX package's donated functional update)
        pool.view(-1, *pool.shape[3:]).index_copy_(
            0, idx, new.reshape(-1, *pool.shape[3:]).to(pool.dtype))

    def write(layer_kv, k_new, v_new):
        idx = flat_rows(layer_kv[0].shape[1], layer_kv[0].shape[2])
        if len(layer_kv) == 4:  # scaled int8/int4 pool
            k_layer, v_layer, ks_layer, vs_layer = layer_kv
            quantize, _ = _pool_quant(layer_kv, k_new)
            # K and V in one call: rows quantize independently
            q, scale = quantize(torch.stack([k_new[:, 0], v_new[:, 0]]))
            put(k_layer, idx, q[0])
            put(v_layer, idx, q[1])
            put(ks_layer, idx, scale[0])
            put(vs_layer, idx, scale[1])
            return layer_kv, (k_layer, ks_layer), (v_layer, vs_layer)
        k_layer, v_layer = layer_kv               # [N, H, bt, hd] views
        put(k_layer, idx, k_new[:, 0])
        put(v_layer, idx, v_new[:, 0])
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
        bt = layer_kv[0].shape[2]
        MB = table_row.shape[0]
        T = k_new.shape[1]
        t = torch.arange(T, device=table_row.device)
        pos = offset + t
        blk = torch.where(t < length,
                          table_row[(pos // bt).clamp(max=MB - 1)],
                          torch.zeros_like(table_row[:1]))
        off = pos % bt
        row = table_row[None]                     # [1, MB]
        dt = k_new.dtype
        if len(layer_kv) == 4:  # scaled int8/int4 pool
            k_layer, v_layer, ks_layer, vs_layer = layer_kv
            quantize, int4 = _pool_quant(layer_kv, k_new)
            kq, ks = quantize(k_new[0])        # [T, H, hd or hd/2], [T, H]
            vq, vs = quantize(v_new[0])
            k_layer[blk, :, off] = kq
            v_layer[blk, :, off] = vq
            ks_layer[blk, :, off] = ks
            vs_layer[blk, :, off] = vs
            return (layer_kv,
                    _gather_dequant(k_layer, ks_layer, row, dt, int4),
                    _gather_dequant(v_layer, vs_layer, row, dt, int4))
        k_layer, v_layer = layer_kv
        k_layer[blk, :, off] = k_new[0].to(k_layer.dtype)
        v_layer[blk, :, off] = v_new[0].to(v_layer.dtype)
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
