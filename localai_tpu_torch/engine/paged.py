"""Host-side block allocator for the paged KV cache.

Port of ``localai_tpu/engine/paged.py`` (pure Python + numpy, kept as an
own copy so the port imports nothing of the JAX package). The device holds
one block pool ``[L, num_blocks, Hkv, block_tokens, hd]``
(engine.kvcache.PagedKVCache) and every slot owns a block table — a
[max_blocks] int32 row mapping logical context blocks to physical pool
blocks. All allocation state lives here on the host.

  * **Reservation, not preemption.** A sequence is admitted only when the
    pool can cover its worst case (``min(prompt + max_new, max_ctx)``
    tokens), so a decode step can never run out of blocks.
  * **Whole-block prefix sharing.** A finished admission's full prompt
    blocks are keyed by a running hash of the tokens they cover and kept
    in a refcounted pool; a later prompt with the same leading blocks maps
    them read-only and prefills only the tail.
  * **Block 0 is the trash block**, the write target of inactive slots.

All mutation happens on the scheduler's engine thread; the lock guards
the read side (stats from API threads).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np


def block_tokens_default() -> int:
    """Tokens per KV block (``LOCALAI_KV_BLOCK_TOKENS``, default 64)."""
    try:
        v = int(os.environ.get("LOCALAI_KV_BLOCK_TOKENS", "64"))
    except ValueError:
        return 64
    return max(8, v)


@dataclasses.dataclass
class BlockStats:
    total: int          # allocatable blocks (pool minus the trash block)
    free: int           # immediately free
    cached: int         # prefix-pool blocks reclaimable on demand
    used: int           # referenced by at least one live sequence

    @property
    def available(self) -> int:
        return self.free + self.cached


class BlockAllocator:
    """Free list + per-sequence block tables + refcounted prefix pool."""

    def __init__(self, num_blocks: int, block_tokens: int,
                 max_blocks_per_seq: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the trash block)")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.max_blocks_per_seq = max_blocks_per_seq
        self._lock = threading.Lock()
        # block 0 reserved: the garbage-write target for inactive slots
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)
        self._ref[0] = 1  # trash never allocated
        # seq (slot) -> list of physical block ids in logical order
        self.tables: dict[int, list[int]] = {}
        # how many leading blocks of each table are shared (read-only)
        self.shared_blocks: dict[int, int] = {}
        # prefix pool: chain-hash of covered tokens -> block id, LRU order
        self._prefix: "OrderedDict[str, int]" = OrderedDict()
        self._block_key: dict[int, str] = {}

    # -- sizing -----------------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_tokens))

    def _reclaimable(self) -> int:
        """Prefix-pool blocks held only by the pool (evictable). Caller
        holds the lock."""
        return sum(1 for b in self._prefix.values() if self._ref[b] == 1)

    # -- prefix sharing ---------------------------------------------------

    @staticmethod
    def _chain(tokens: list[int], nb: int, bt: int) -> list[str]:
        """Running hash per full block: key i covers tokens[:(i+1)*bt]."""
        keys = []
        h = hashlib.sha1()
        for i in range(nb):
            h.update(np.asarray(tokens[i * bt:(i + 1) * bt],
                                np.int64).tobytes())
            keys.append(h.hexdigest())
        return keys

    def match_prefix(self, prompt: Optional[list[int]]) -> list[int]:
        """Physical block ids of the longest pool-cached full-block prefix
        of ``prompt``. Never covers the final prompt token (its logits must
        be recomputed to seed sampling), so at most (n-1)//bt blocks."""
        if not prompt:
            return []
        bt = self.block_tokens
        nb = (len(prompt) - 1) // bt
        if nb <= 0:
            return []
        out: list[int] = []
        with self._lock:
            for key in self._chain(prompt, nb, bt):
                bid = self._prefix.get(key)
                if bid is None:
                    break
                out.append(bid)
        return out

    def register_prefix(self, seq: int, prompt: list[int]) -> int:
        """Insert ``seq``'s full prompt blocks into the prefix pool (each
        gains a pool reference). Call only after the blocks' contents have
        been dispatched to the device. Returns blocks registered."""
        if not prompt:
            return 0
        added = 0
        with self._lock:
            table = self.tables.get(seq)
            if table is None:
                return 0
            bt = self.block_tokens
            nb = min((len(prompt) - 1) // bt, len(table))
            for i, key in enumerate(self._chain(prompt, nb, bt)):
                if key in self._prefix:
                    self._prefix.move_to_end(key)
                    continue
                bid = table[i]
                if bid in self._block_key:  # already caches another chain
                    continue
                self._prefix[key] = bid
                self._block_key[bid] = key
                self._ref[bid] += 1
                added += 1
        return added

    def _evict_one(self) -> Optional[int]:
        """Drop the LRU pool-only block; returns its id. Caller holds the
        lock."""
        victim = next((k for k, b in self._prefix.items()
                       if self._ref[b] == 1), None)
        if victim is None:
            return None
        bid = self._prefix.pop(victim)
        del self._block_key[bid]
        self._ref[bid] = 0
        return bid

    # -- allocate / release ----------------------------------------------

    def allocate(self, seq: int, tokens: int,
                 prompt: Optional[list[int]] = None) -> Optional[int]:
        """Build ``seq``'s block table covering ``tokens`` rows, sharing
        pool-cached prompt prefix blocks where possible. Returns the
        shared-token count, or None when the pool cannot cover the
        reservation (the caller queues the request). ``seq`` must not
        already hold a table."""
        nb = self.blocks_for(tokens)
        shared = self.match_prefix(prompt) if prompt else []
        shared = shared[: max(0, nb - 1)]  # at least one writable block
        with self._lock:
            assert seq not in self.tables, f"seq {seq} already has a table"
            # reference the shared blocks FIRST: a pool-only shared block
            # (ref==1) would otherwise be an eligible eviction victim in
            # the fresh loop below and end up in the table twice
            for bid in shared:
                self._ref[bid] += 1
                key = self._block_key.get(bid)
                if key is not None:
                    self._prefix.move_to_end(key)
            need = nb - len(shared)
            if need > len(self._free) + self._reclaimable():
                for bid in shared:  # roll the reservation back
                    self._ref[bid] -= 1
                return None
            fresh: list[int] = []
            for _ in range(need):
                if not self._free:
                    evicted = self._evict_one()
                    assert evicted is not None
                    self._free.append(evicted)
                fresh.append(self._free.pop())
            for bid in fresh:
                self._ref[bid] = 1
            self.tables[seq] = shared + fresh
            self.shared_blocks[seq] = len(shared)
        return len(shared) * self.block_tokens

    def release(self, seq: int) -> None:
        with self._lock:
            table = self.tables.pop(seq, None)
            self.shared_blocks.pop(seq, None)
            if table is None:
                return
            for bid in table:
                self._ref[bid] -= 1
                if self._ref[bid] == 0:
                    self._free.append(bid)

    # -- views ------------------------------------------------------------

    def table_row(self, seq: int) -> np.ndarray:
        """[max_blocks_per_seq] int32 device-shaped table row (trash-padded)."""
        row = np.zeros(self.max_blocks_per_seq, np.int32)
        with self._lock:
            t = list(self.tables.get(seq, []))
        row[: len(t)] = t[: self.max_blocks_per_seq]
        return row

    def stats(self) -> BlockStats:
        with self._lock:
            free = len(self._free)
            cached = self._reclaimable()
            total = self.num_blocks - 1
            return BlockStats(
                total=total,
                free=free,
                cached=cached,
                used=total - free - cached,
            )

    def check_invariants(self) -> list[str]:
        """Block-conservation audit from refcount ground truth. Returns
        violation strings (empty = healthy): every allocatable block is
        free (refcount 0) or referenced (≥ 1), the free list holds no
        duplicates and never the trash block, table blocks are live
        non-trash blocks (shared leading ones also pool-referenced), and
        the prefix pool's key↔block indices agree."""
        problems: list[str] = []
        with self._lock:
            free_set = set(self._free)
            if len(free_set) != len(self._free):
                problems.append("free list holds duplicate block ids")
            if 0 in free_set:
                problems.append("trash block 0 is on the free list")
            for bid in range(1, self.num_blocks):
                ref = int(self._ref[bid])
                if bid in free_set and ref != 0:
                    problems.append(
                        f"block {bid} is free but has refcount {ref}")
                if bid not in free_set and ref < 1:
                    problems.append(
                        f"block {bid} leaked: refcount {ref}, not free")
            for seq, table in self.tables.items():
                shared = self.shared_blocks.get(seq, 0)
                for i, bid in enumerate(table):
                    if bid == 0 or bid in free_set:
                        problems.append(
                            f"seq {seq} table block {bid} is not live")
                    elif int(self._ref[bid]) < (2 if i < shared else 1):
                        problems.append(
                            f"seq {seq} block {bid} refcount "
                            f"{int(self._ref[bid])} too low")
            for key, bid in self._prefix.items():
                if self._block_key.get(bid) != key:
                    problems.append(
                        f"prefix pool and block-key index disagree on "
                        f"block {bid}")
            if len(self._block_key) != len(self._prefix):
                problems.append("block-key index size != prefix pool size")
        return problems
