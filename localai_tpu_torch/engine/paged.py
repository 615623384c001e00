"""Host-side block allocator for the paged KV cache.

Port of ``localai_tpu/engine/paged.py`` (pure Python + numpy, kept as an
own copy so the port imports nothing of the JAX package). The device holds
one block pool ``[L, num_blocks, Hkv, block_tokens, hd]``
(engine.kvcache.PagedKVCache) and every slot owns a block table — a
[max_blocks] int32 row mapping logical context blocks to physical pool
blocks. All allocation state lives here on the host.

  * **Reservation, not preemption.** A sequence is admitted only when the
    pool can cover its worst case (``min(prompt + max_new, max_ctx)``
    tokens), so a decode step can never run out of blocks. A speculating
    engine reserves its verify window's lookahead on top
    (``spec_tokens``); the blocks that adds are recorded as speculation
    blocks, audited by ``check_invariants`` and freed with the table.
  * **Whole-block prefix sharing.** A finished admission's full prompt
    blocks are keyed by a running hash of the tokens they cover and kept
    in a refcounted pool; a later prompt with the same leading blocks maps
    them read-only and prefills only the tail.
  * **Block 0 is the trash block**, the write target of inactive slots.
  * **An optional host tier under the prefix pool**
    (``fleet.kveconomy.tiering.HostTier``, attached by the runner when
    ``LOCALAI_KV_TIER_MB`` is set): an evicted pool block's rows spill
    to host memory, and a chain walk that misses the pool but hits the
    tier re-onboards the block and walks on. The allocator stays
    device-blind: pack and load are the runner's callbacks.

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

from localai_tpu_torch.faults import registry as _faults


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
    high_watermark: int = 0  # max concurrently-used blocks since init
    spec_reserved: int = 0  # blocks held purely for speculative lookahead

    @property
    def available(self) -> int:
        return self.free + self.cached

    @property
    def utilization(self) -> float:
        return self.used / self.total if self.total else 0.0


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
        # how many trailing blocks of each table only the speculation
        # lookahead needs
        self.spec_blocks: dict[int, int] = {}
        # prefix pool: chain-hash of covered tokens -> block id, LRU order
        self._prefix: "OrderedDict[str, int]" = OrderedDict()
        self._block_key: dict[int, str] = {}
        # lifetime counters (telemetry)
        self._watermark = 0
        self.shared_tokens_total = 0
        self.evictions_total = 0     # prefix-pool blocks evicted (LRU)
        # the optional host spill tier (attach_tier) and its counters
        self._tier = None
        self._tier_pack = None
        self._tier_load = None
        self.spills_total = 0
        self.reloads_total = 0

    # -- sizing -----------------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_tokens))

    def _reclaimable(self) -> int:
        """Prefix-pool blocks held only by the pool (evictable). Caller
        holds the lock."""
        return sum(1 for b in self._prefix.values() if self._ref[b] == 1)

    # -- HBM→host tiering -------------------------------------------------

    def attach_tier(self, tier, *, pack, load) -> None:
        """Wire the host-RAM spill tier under the prefix pool.

        ``pack(bid) -> payload dict`` copies one pool block's raw rows to
        host memory; ``load(bid, payload)`` writes them back. Both are the
        runner's, so this module never touches the device. Call before
        serving starts."""
        with self._lock:
            self._tier = tier
            self._tier_pack = pack
            self._tier_load = load

    def _spill(self, key: str, bid: int) -> None:
        """Best-effort park of an evicted pool block in the host tier.
        Caller holds the lock; a failed spill is a plain eviction."""
        try:
            payload = self._tier_pack(bid)
            if payload is not None and self._tier.put(key, payload):
                self.spills_total += 1
        except Exception:  # noqa: BLE001 — a failed spill is a plain evict
            pass

    def _reload(self, key: str, exclude: list[int]) -> Optional[int]:
        """Re-onboard a spilled chain block into a free (or freshly
        evicted) pool block; returns its id as a pool-referenced prefix
        entry, or None. Caller holds the lock. ``exclude`` keeps blocks
        already matched by this walk (pool-referenced only until
        allocate() pins them) from being picked as eviction victims."""
        if not self._tier.contains(key):
            return None
        if self._free:
            bid = self._free.pop()
        else:
            bid = self._evict_one(exclude=exclude)
            if bid is None:
                return None
        payload = self._tier.take(key)
        if payload is None:  # raced away (budget churn)
            self._free.append(bid)
            return None
        try:
            self._tier_load(bid, payload)
        except Exception:  # noqa: BLE001 — a corrupt spill is a miss
            self._free.append(bid)
            return None
        self._prefix[key] = bid
        self._block_key[bid] = key
        self._ref[bid] = 1
        self.reloads_total += 1
        return bid

    def tier_stats(self) -> Optional[dict]:
        """The spill tier's accounting (None when tiering is off)."""
        with self._lock:
            tier = self._tier
            spills = self.spills_total
            reloads = self.reloads_total
        if tier is None:
            return None
        s = tier.stats()
        s["spills_total"] = spills
        s["reloads_total"] = reloads
        return s

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
                if bid is None and self._tier is not None:
                    # a pool miss, maybe a host hit: re-onboard the
                    # spilled block and keep walking the chain
                    bid = self._reload(key, exclude=out)
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
                if self._tier is not None:
                    # this chain just re-materialized in the pool from a
                    # fresh prefill: a spilled copy is stale now (a block
                    # is pool-resident XOR spilled, audited below)
                    self._tier.discard(key)
        return added

    def _evict_one(self, exclude: Optional[list[int]] = None,
                   ) -> Optional[int]:
        """Drop the LRU pool-only block; returns its id. Caller holds the
        lock. With a tier attached the victim's rows spill to host memory
        first (best effort). ``exclude`` shields blocks a chain walk
        already claimed (pool-referenced only until allocate pins them)
        from victim selection."""
        shielded = set(exclude or ())
        victim = next((k for k, b in self._prefix.items()
                       if self._ref[b] == 1 and b not in shielded), None)
        if victim is None:
            return None
        bid = self._prefix.pop(victim)
        del self._block_key[bid]
        self._ref[bid] = 0
        self.evictions_total += 1
        if self._tier is not None:
            self._spill(victim, bid)
        return bid

    # -- allocate / release ----------------------------------------------

    def _take_fresh(self, need: int) -> list[int]:
        """``need`` blocks off the free list, evicting LRU pool-only prefix
        blocks when it runs dry; the caller checked availability and holds
        the lock."""
        fresh: list[int] = []
        for _ in range(need):
            if not self._free:
                evicted = self._evict_one()
                assert evicted is not None
                self._free.append(evicted)
            bid = self._free.pop()
            self._ref[bid] = 1
            fresh.append(bid)
        used = self.num_blocks - 1 - len(self._free) - self._reclaimable()
        self._watermark = max(self._watermark, used)
        return fresh

    def allocate(self, seq: int, tokens: int,
                 prompt: Optional[list[int]] = None,
                 spec_tokens: int = 0) -> Optional[int]:
        """Build ``seq``'s block table covering ``tokens + spec_tokens``
        rows, sharing pool-cached prompt prefix blocks where possible.
        ``spec_tokens`` extra rows are the slot's speculative-decoding
        lookahead (a verify window writes up to gamma rows past the decode
        frontier); the blocks they add beyond the base reservation are
        recorded as speculation blocks. Returns the shared-token count, or
        None when the pool cannot cover the reservation (the caller queues
        the request). ``seq`` must not already hold a table."""
        if _faults.ACTIVE and _faults.apply("paged.allocate",
                                            key=str(seq)) is not None:
            return None  # injected exhaustion: report the pool full
        nb = self.blocks_for(tokens + spec_tokens)
        nb_spec = nb - self.blocks_for(tokens)
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
            self.tables[seq] = shared + self._take_fresh(need)
            self.shared_blocks[seq] = len(shared)
            if nb_spec:
                self.spec_blocks[seq] = nb_spec
            self.shared_tokens_total += len(shared) * self.block_tokens
        return len(shared) * self.block_tokens

    def extend(self, seq: int, tokens: int, spec_tokens: int = 0) -> bool:
        """Grow ``seq``'s existing table to cover ``tokens + spec_tokens``
        rows, recording the speculation lookahead as :meth:`allocate`
        does. False on exhaustion (nothing is reserved then)."""
        with self._lock:
            table = self.tables.get(seq)
            if table is None:
                return False
            nb = self.blocks_for(tokens + spec_tokens)
            nb_spec = nb - self.blocks_for(tokens)
            need = nb - len(table)
            if need <= 0:
                # the table already covers the reservation and any
                # lookahead: no distinct speculation tail to account
                self.spec_blocks.pop(seq, None)
                return True
            if need > len(self._free) + self._reclaimable():
                return False
            if nb_spec:
                self.spec_blocks[seq] = nb_spec
            else:
                self.spec_blocks.pop(seq, None)
            table.extend(self._take_fresh(need))
        return True

    def release(self, seq: int) -> None:
        with self._lock:
            table = self.tables.pop(seq, None)
            self.shared_blocks.pop(seq, None)
            self.spec_blocks.pop(seq, None)
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

    def tables_snapshot(self) -> dict[int, int]:
        """{seq: table length} under the lock — the /debug/kv view (the
        engine thread inserts and pops tables concurrently)."""
        with self._lock:
            return {seq: len(t) for seq, t in self.tables.items()}

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
                high_watermark=self._watermark,
                spec_reserved=sum(self.spec_blocks.values()),
            )

    def check_invariants(self) -> list[str]:
        """Block-conservation audit from refcount ground truth. Returns
        violation strings (empty = healthy). Invariants:

          * every allocatable block is exactly one of {free, referenced};
            free blocks carry refcount 0, referenced ones ≥ 1 — so
            ``free + used + cached == total`` by construction;
          * the free list holds no duplicates and never the trash block;
          * every table block id is a live (ref ≥ 1) non-trash block, and
            a table's shared leading blocks are also pool-referenced
            (ref ≥ 2);
          * every prefix-pool chain entry maps to a live block and the
            key↔block indices agree;
          * each speculation reservation is a tail of its own table that
            never entered the prefix pool;
          * the live blocks are exactly those reachable from a table or
            the prefix pool (the conservation census);
          * with a host tier attached, a chain lives in the pool XOR the
            tier, and the tier holds no more bytes than its budget.

        The JAX package's audit. O(blocks + table rows) under the lock —
        called from scheduler drains only behind ``LOCALAI_KV_CHECK`` and
        surfaced at ``/debug/kv``."""
        problems: list[str] = []
        with self._lock:
            free_set = set(self._free)
            if len(free_set) != len(self._free):
                problems.append("free list holds duplicate block ids")
            if 0 in free_set:
                problems.append("trash block 0 is on the free list")
            if self._ref[0] < 1:
                problems.append("trash block 0 lost its standing reference")
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
                    if bid == 0:
                        problems.append(f"seq {seq} table maps trash block")
                        continue
                    if bid in free_set:
                        problems.append(
                            f"seq {seq} table block {bid} is on the "
                            "free list")
                    want = 2 if i < shared else 1
                    if int(self._ref[bid]) < want:
                        problems.append(
                            f"seq {seq} {'shared ' if i < shared else ''}"
                            f"block {bid} refcount {int(self._ref[bid])} "
                            f"< {want}")
            for seq, nspec in self.spec_blocks.items():
                table = self.tables.get(seq)
                if table is None:
                    problems.append(
                        f"seq {seq} holds a speculation reservation "
                        f"({nspec} blocks) but no table")
                    continue
                if nspec < 0 or nspec > len(table):
                    problems.append(
                        f"seq {seq} speculation reservation {nspec} "
                        f"outside its table of {len(table)} blocks")
                    continue
                # speculation blocks are the table TAIL and must never be
                # shared through the prefix pool (a rejected draft row in
                # a shared block would poison every sharer)
                for bid in table[len(table) - nspec:]:
                    if bid in self._block_key:
                        problems.append(
                            f"seq {seq} speculation block {bid} leaked "
                            "into the prefix pool")
            for key, bid in self._prefix.items():
                if int(self._ref[bid]) < 1:
                    problems.append(
                        f"cached chain block {bid} refcount "
                        f"{int(self._ref[bid])} < 1")
                if self._block_key.get(bid) != key:
                    problems.append(
                        f"prefix pool and block-key index disagree on "
                        f"block {bid}")
            if len(self._block_key) != len(self._prefix):
                problems.append("block-key index size != prefix pool size")
            if self._tier is not None:
                # tier residency: a chain in the pool AND the tier means a
                # reload forgot to consume its spill (stale host rows
                # would shadow newer pool contents on the next churn)
                pool_keys = set(self._prefix)
                for key in self._tier.keys():
                    if key in pool_keys:
                        problems.append(
                            f"chain {key[:12]}… resident in the HBM pool "
                            "AND spilled to the host tier")
                ts = self._tier.stats()
                if ts["bytes"] > ts["budget_bytes"]:
                    problems.append(
                        f"host tier over budget: {ts['bytes']} bytes "
                        f"held vs {ts['budget_bytes']} budgeted")
            # conservation, derived INDEPENDENTLY of stats() (whose
            # ``used`` is total - free - cached by construction): every
            # live block must be reachable from a table or the prefix
            # pool, and the reachable census must add up block by block
            table_ids = {bid for t in self.tables.values() for bid in t}
            pool_ids = set(self._prefix.values())
            live = {bid for bid in range(1, self.num_blocks)
                    if int(self._ref[bid]) > 0 and bid not in free_set}
            for bid in sorted(live - table_ids - pool_ids):
                problems.append(
                    f"block {bid} leaked: refcount {int(self._ref[bid])} "
                    "but referenced by no table or pool entry")
            free = len(self._free)
            cached = self._reclaimable()
            total = self.num_blocks - 1
            used = total - free - cached
            used_census = len(
                (table_ids | pool_ids)
                - {bid for bid in pool_ids if int(self._ref[bid]) == 1})
            if used_census != used:
                problems.append(
                    f"conservation broken: {used_census} blocks live in "
                    f"tables/pool vs used {used} "
                    f"(free {free}, cached {cached}, total {total})")
        return problems
