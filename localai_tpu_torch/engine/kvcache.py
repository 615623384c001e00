"""KV caches: the paged block pool and the contiguous slot cache.

Port of ``localai_tpu/engine/kvcache.py``. Two layouts:

  * paged — k, v each [L, N, Hkv, bt, hd]: N physical blocks of bt tokens
    shared by all slots through block tables; the host bookkeeping (free
    list, tables, prefix pool) is ``engine.paged``. Block 0 is the trash
    block: inactive slots' table rows are all zeros, so their static-shape
    writes land there.
  * contiguous — k, v each [L, S, Hkv, C, hd]: one head-major row of C
    positions per slot, written at each slot's position (inactive slots at
    their frozen position, as in the JAX package), and kept across
    release so a later prompt can reuse its prefix.

Scaled int8 storage holds symmetric per-(row, head, position) int8 values
with f32 scales k_scale/v_scale of the same shape minus hd
(``quant.quantize_lastdim``); int4 pools (paged only) hold nibble-packed
int8 rows of hd/2 bytes in the halves layout (``quant.quantize_lastdim4``).
The packed last dim is how every consumer tells int4 from int8, as in the
JAX package.

The JAX package returns an updated cache from every write and relies on
buffer donation to make that in place; here the write policies update the
cache in place directly, on the layer's view of the stacked tensor
(``index_copy_`` for decode, an indexed or sliced assignment for prefill).
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
class KVCache:
    """Contiguous slot cache. k, v: [L, S, Hkv, C, hd]; k_scale, v_scale:
    [L, S, Hkv, C] f32 for a scaled int8 cache, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def stacked(self):
        """The tuple whose per-layer views models.llama.forward hands to
        the write policy: (k, v), or (k, v, k_scale, v_scale)."""
        if self.k_scale is None:
            return (self.k, self.v)
        return (self.k, self.v, self.k_scale, self.v_scale)


@dataclasses.dataclass
class PagedKVCache(KVCache):
    """Block pool. k, v: [L, N, Hkv, bt, hd] (int4: hd/2); k_scale,
    v_scale: [L, N, Hkv, bt] f32 for scaled int8/int4 pools, else None."""

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_tokens(self) -> int:
        return self.k.shape[3]


def _alloc(cls, shape: tuple, dtype: str, device: torch.device):
    """A zeroed cache of ``cls``: [L, *, Hkv, *, hd] float storage, or int8
    (int4: last dim hd/2, packed by the caller's shape) with f32 scales."""
    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if str(dtype) in ("int8", "int4"):
        return cls(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                   k_scale=zeros(shape[:4], torch.float32),
                   v_scale=zeros(shape[:4], torch.float32))
    dt = torch_dtype(dtype)
    return cls(k=zeros(shape, dt), v=zeros(shape, dt))


def init_cache(cfg: LlamaConfig, num_slots: int, max_ctx: int,
               dtype: str = "bfloat16",
               device: str | torch.device = "cuda") -> KVCache:
    """The contiguous slot cache; int4 storage exists for pools only."""
    if str(dtype) == "int4":
        raise ValueError("kv_dtype int4 needs the paged KV layout; use int8 "
                         "for a contiguous cache")
    return _alloc(KVCache, (cfg.num_layers, num_slots, cfg.num_kv_heads,
                            max_ctx, cfg.hd), dtype, resolve_device(device))


def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_tokens: int,
                     dtype: str = "bfloat16",
                     device: str | torch.device = "cuda") -> PagedKVCache:
    device = resolve_device(device)
    int4 = str(dtype) == "int4"
    if int4 and cfg.hd % 2:
        raise ValueError(f"int4 KV needs an even head_dim, got {cfg.hd}")
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_tokens,
             cfg.hd // 2 if int4 else cfg.hd)
    return _alloc(PagedKVCache, shape, dtype, device)


def _pool_quant(layer_kv, k_new: torch.Tensor):
    """The quantizer matching scaled storage: int4 when the last dim is
    the packed hd/2 (pools only), else int8. ``k_new`` carries the full
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


def _put_rows(layer_kv, idx: torch.Tensor, *new: torch.Tensor) -> None:
    """In place (the JAX package's donated functional update): row idx[i]
    of each layer tensor, viewed as [rows, *trailing], takes row i of the
    matching ``new`` [S, H, *trailing] (rows are (slot, head)-major)."""
    for t, n in zip(layer_kv, new):
        t.view(-1, *t.shape[3:]).index_copy_(
            0, idx, n.reshape(-1, *t.shape[3:]).to(t.dtype))


def _decode_put(layer_kv, idx: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor):
    """The decode write of both layouts: k/v_new [S, 1, H, hd] to the flat
    rows ``idx`` (quantized first for scaled storage), passing the layer's
    cache on as the decode kernels take it — the tensor, or (tensor,
    scales) pairs."""
    if len(layer_kv) == 4:  # scaled int8/int4 storage
        k_layer, v_layer, ks_layer, vs_layer = layer_kv
        quantize, _ = _pool_quant(layer_kv, k_new)
        # K and V in one call: rows quantize independently
        q, scale = quantize(torch.stack([k_new[:, 0], v_new[:, 0]]))
        _put_rows(layer_kv, idx, q[0], q[1], scale[0], scale[1])
        return layer_kv, (k_layer, ks_layer), (v_layer, vs_layer)
    _put_rows(layer_kv, idx, k_new[:, 0], v_new[:, 0])
    return layer_kv, layer_kv[0], layer_kv[1]


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

    def write(layer_kv, k_new, v_new):
        return _decode_put(layer_kv, flat_rows(layer_kv[0].shape[1],
                                               layer_kv[0].shape[2]),
                           k_new, v_new)

    return write


def paged_scatter(layer_kv, table_row: torch.Tensor, offset: int,
                  length: int, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> None:
    """Write a chunk k_new/v_new [1, T, H, hd] of one layer through a
    block table row: token t lands at pool[table_row[(offset+t)//bt], :,
    (offset+t)%bt]; padding rows (t >= length) go to the trash block."""
    bt = layer_kv[0].shape[2]
    MB = table_row.shape[0]
    T = k_new.shape[1]
    t = torch.arange(T, device=table_row.device)
    pos = offset + t
    blk = torch.where(t < length,
                      table_row[(pos // bt).clamp(max=MB - 1)],
                      torch.zeros_like(table_row[:1]))
    off = pos % bt
    if len(layer_kv) == 4:  # scaled int8/int4 pool
        k_layer, v_layer, ks_layer, vs_layer = layer_kv
        quantize, _int4 = _pool_quant(layer_kv, k_new)
        kq, ks = quantize(k_new[0])        # [T, H, hd or hd/2], [T, H]
        vq, vs = quantize(v_new[0])
        k_layer[blk, :, off] = kq
        v_layer[blk, :, off] = vq
        ks_layer[blk, :, off] = ks
        vs_layer[blk, :, off] = vs
        return
    k_layer, v_layer = layer_kv
    k_layer[blk, :, off] = k_new[0].to(k_layer.dtype)
    v_layer[blk, :, off] = v_new[0].to(v_layer.dtype)


def paged_prefill_write(table_row: torch.Tensor, offset: int, length: int):
    """KV write policy for one chunked-prefill dispatch into a block table.

    table_row: [MB], offset: absolute start position of this chunk,
    length: real (unpadded) tokens in the chunk; the rows go where
    :func:`paged_scatter` puts them. Exposes the gathered full logical
    context [1, H, MB*bt, hd] so chunk tokens attend over the kept prefix
    + earlier chunks (resume-style)."""

    def write(layer_kv, k_new, v_new):  # k_new [1, T, H, hd]
        paged_scatter(layer_kv, table_row, offset, length, k_new, v_new)
        row = table_row[None]                     # [1, MB]
        dt = k_new.dtype
        if len(layer_kv) == 4:  # scaled int8/int4 pool
            k_layer, v_layer, ks_layer, vs_layer = layer_kv
            _q, int4 = _pool_quant(layer_kv, k_new)
            return (layer_kv,
                    _gather_dequant(k_layer, ks_layer, row, dt, int4),
                    _gather_dequant(v_layer, vs_layer, row, dt, int4))
        k_layer, v_layer = layer_kv
        return (layer_kv, gather_blocks(k_layer, row).to(dt),
                gather_blocks(v_layer, row).to(dt))

    return write


def paged_verify_write(tables: torch.Tensor, positions: torch.Tensor,
                       ctx_limit: int):
    """KV write policy for the batched speculative verify forward over a
    block pool: ``paged_decode_write`` generalized to T tokens a slot.

    Window token t of slot s lands at
    ``pool[tables[s, (positions[s]+t)//bt], :, (positions[s]+t)%bt]``.
    Rows at or past ``ctx_limit`` (the runner's max_ctx) go to the trash
    block: near the context edge a window row must never wrap onto the
    slot's own earlier rows through the clamped block index. Inactive and
    mid-prefill slots' table rows are all zeros, so their writes land in
    the trash block as decode's do. Exposes the gathered logical context
    [S, H, MB*bt, hd] (dequantized in the compute dtype for a scaled
    pool) so window tokens attend over the prefix and the window so far.

    Rollback is a per-slot position rollback only: the rejected tail's
    rows (values and scale rows alike, which ride the same scatter) stay
    as garbage in the slot's reserved speculation rows and are
    overwritten before anything attends to them."""

    def write(layer_kv, k_new, v_new):  # k_new [S, T, H, hd]
        dt = k_new.dtype
        bt = layer_kv[0].shape[2]
        MB = tables.shape[1]
        S, T = k_new.shape[0], k_new.shape[1]
        s = torch.arange(S, device=tables.device)[:, None]
        pmat = (positions[:, None].long()
                + torch.arange(T, device=tables.device)[None, :])  # [S, T]
        blk = torch.where(pmat < ctx_limit,
                          tables[s, (pmat // bt).clamp(max=MB - 1)],
                          torch.zeros_like(tables[:1, :1]))
        off = pmat % bt
        if len(layer_kv) == 4:  # scaled int8/int4 pool
            k_layer, v_layer, ks_layer, vs_layer = layer_kv
            quantize, int4 = _pool_quant(layer_kv, k_new)
            kq, ks = quantize(k_new)     # [S, T, H, hd or hd/2], [S, T, H]
            vq, vs = quantize(v_new)
            k_layer[blk, :, off] = kq
            v_layer[blk, :, off] = vq
            ks_layer[blk, :, off] = ks
            vs_layer[blk, :, off] = vs
            return (layer_kv,
                    _gather_dequant(k_layer, ks_layer, tables, dt, int4),
                    _gather_dequant(v_layer, vs_layer, tables, dt, int4))
        k_layer, v_layer = layer_kv               # [N, H, bt, hd]
        k_layer[blk, :, off] = k_new.to(k_layer.dtype)
        v_layer[blk, :, off] = v_new.to(v_layer.dtype)
        return (layer_kv, gather_blocks(k_layer, tables).to(dt),
                gather_blocks(v_layer, tables).to(dt))

    return write


def verify_write(positions: torch.Tensor):
    """KV write policy for the batched speculative verify forward over the
    contiguous cache: writes the window [S, T, H, hd] at
    cache[s, :, positions[s] + t] (quantized for a scaled int8 cache) and
    exposes every slot's whole row ([S, H, C, hd], dequantized in the
    compute dtype). Rejected rows stay as garbage above the slot's
    frontier, overwritten before anything attends to them.

    A row at or past the cache's end is dropped, as the JAX package's
    scatter drops it. The window goes in one position at a time (one row
    a slot per write, so no two writes of one call meet), and a dropped
    row rewrites the row it was clamped to with that row's own value."""

    def write(layer_kv, k_new, v_new):
        dt = k_new.dtype
        S, T = k_new.shape[0], k_new.shape[1]
        C = layer_kv[0].shape[2]
        s = torch.arange(S, device=positions.device)
        if len(layer_kv) == 4:  # scaled int8 cache
            kq, ks = quant.quantize_lastdim(k_new)   # [S, T, H, hd], [S, T, H]
            vq, vs = quant.quantize_lastdim(v_new)
            new = (kq, vq, ks, vs)
        else:
            new = (k_new, v_new)
        for t in range(T):
            p = positions.long() + t
            keep = p < C
            pc = p.clamp(max=C - 1)
            for cache, n in zip(layer_kv, new):
                row = n[:, t].to(cache.dtype)            # [S, H, ...]
                fit = keep.view(S, *([1] * (row.dim() - 1)))
                cache[s, :, pc] = torch.where(fit, row, cache[s, :, pc])
        rows = [c.to(dt) for c in layer_kv]
        if len(rows) == 4:
            return (layer_kv, rows[0] * rows[2][..., None],
                    rows[1] * rows[3][..., None])
        return layer_kv, rows[0], rows[1]

    return write


def dequantized(rows, dt: torch.dtype) -> torch.Tensor:
    """A decode write's exposed cache (the tensor, or a scaled (cache,
    scales) pair) in the compute dtype ``dt``, dequantized as the JAX
    package's non-kernel decode write exposes it."""
    if isinstance(rows, tuple):
        cache, scales = rows
        return cache.to(dt) * scales[..., None].to(dt)
    return rows.to(dt)


def prefill_mask(cfg: LlamaConfig, seq_len: int, length: int,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """[1, T, T] causal mask of a fresh chunk limited to the real
    ``length`` rows (the self-extend prefill's; the prefill kernel masks
    by itself)."""
    t = torch.arange(seq_len, device=resolve_device(device))
    m = (t[None, :, None] >= t[None, None, :]) & (t[None, None, :] < length)
    if cfg.sliding_window:
        m &= t[None, None, :] > t[None, :, None] - cfg.sliding_window
    return m


def verify_mask(cfg: LlamaConfig, positions: torch.Tensor, T: int,
                max_ctx: int) -> torch.Tensor:
    """[S, T, C] mask for the speculative verify forward: window token t
    (absolute position positions[s]+t) attends causally over the slot's
    prefix and the window so far."""
    c = torch.arange(max_ctx, device=positions.device)[None, None, :]
    pos = (positions.long()[:, None, None]
           + torch.arange(T, device=positions.device)[None, :, None])
    m = c <= pos
    if cfg.sliding_window:
        m &= c > pos - cfg.sliding_window
    return m


def decode_write(positions: torch.Tensor):
    """KV write policy for batched single-token decode over the contiguous
    cache.

    positions: [S]. Writes k/v_new [S, 1, H, hd] at cache[s, :, pos[s]] in
    place for every slot (an inactive slot at its frozen position: the row
    past its valid prefix) and passes the layer's cache through:
    ``ops.decode_attention`` walks each slot's row itself. A scaled int8
    cache passes (cache, scales) pairs, dequantized inside the kernel. The
    flat cache row of every (slot, head) is computed once per step."""
    rows = {}

    def flat_rows(H: int, C: int) -> torch.Tensor:
        # [S*H] rows of the cache viewed as [S*H*C, hd], slot-major
        if (H, C) not in rows:
            s = torch.arange(positions.shape[0], device=positions.device)
            h = torch.arange(H, device=positions.device)
            rows[H, C] = ((s[:, None] * H + h[None, :]) * C
                          + positions.long()[:, None]).reshape(-1)
        return rows[H, C]

    def write(layer_kv, k_new, v_new):
        return _decode_put(layer_kv, flat_rows(layer_kv[0].shape[1],
                                               layer_kv[0].shape[2]),
                           k_new, v_new)

    return write


def _write_chunk(layer_kv, slot: int, offset: int, k_hm: torch.Tensor,
                 v_hm: torch.Tensor) -> None:
    """cache[slot, :, offset:offset+T] = the head-major chunk [1, H, T, hd]
    (quantized for a scaled int8 cache), in place; padding rows past the
    prompt land there too and are overwritten by decode before anything
    attends to them."""
    span = slice(offset, offset + k_hm.shape[2])
    if len(layer_kv) == 4:
        k_layer, v_layer, ks_layer, vs_layer = layer_kv
        kq, ks = quant.quantize_lastdim(k_hm[0])  # [H, T, hd], [H, T]
        vq, vs = quant.quantize_lastdim(v_hm[0])
        k_layer[slot, :, span] = kq
        v_layer[slot, :, span] = vq
        ks_layer[slot, :, span] = ks
        vs_layer[slot, :, span] = vs
        return
    k_layer, v_layer = layer_kv
    k_layer[slot, :, span] = k_hm[0].to(k_layer.dtype)
    v_layer[slot, :, span] = v_hm[0].to(v_layer.dtype)


def prefill_write(slot: int, offset: int = 0):
    """KV write policy for a fresh single-sequence prefill into one slot:
    writes the chunk [1, T, H, hd] at cache[slot, :, offset:offset+T] and
    exposes the unquantized chunk head-major ([1, H, T, hd]) — a fresh
    context attends over the chunk itself (T^2, not T*C), so quantization
    error only enters on later decode reads."""

    def write(layer_kv, k_new, v_new):
        k_hm, v_hm = k_new.transpose(1, 2), v_new.transpose(1, 2)
        _write_chunk(layer_kv, slot, offset, k_hm, v_hm)
        return layer_kv, k_hm, v_hm

    return write


def chunk_write(layer_kv, k_new, v_new):
    """KV write policy that stores nothing and exposes the chunk head-major
    (the embeddings forward, which has no cache)."""
    return layer_kv, k_new.transpose(1, 2), v_new.transpose(1, 2)


def resume_write(slot: int, offset: int):
    """KV write policy for suffix prefill into a slot that keeps a reused
    prefix: writes the chunk like prefill_write, but exposes the slot's
    whole cache row ([1, H, C, hd], dequantized in the compute dtype as
    the JAX package does) so the new tokens attend over the kept prefix."""

    def write(layer_kv, k_new, v_new):
        dt = k_new.dtype
        _write_chunk(layer_kv, slot, offset, k_new.transpose(1, 2),
                     v_new.transpose(1, 2))
        rows = [t[slot:slot + 1].to(dt) for t in layer_kv]
        if len(rows) == 4:
            return (layer_kv, rows[0] * rows[2][..., None],
                    rows[1] * rows[3][..., None])
        return layer_kv, rows[0], rows[1]

    return write


def resume_mask(cfg: LlamaConfig, seq_len: int, offset: int, max_ctx: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """[1, T, C] mask for chunked or suffix prefill: chunk token t
    (absolute position offset+t) attends causally over the kept prefix +
    the chunk."""
    device = resolve_device(device)
    t = torch.arange(seq_len, device=device)[None, :, None]
    c = torch.arange(max_ctx, device=device)[None, None, :]
    pos = offset + t
    m = c <= pos
    if cfg.sliding_window:
        m &= c > pos - cfg.sliding_window
    return m
