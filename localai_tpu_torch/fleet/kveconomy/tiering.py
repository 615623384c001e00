"""Host-RAM spill tier for the paged prefix pool (HBM → host tiering).

Port of ``localai_tpu/fleet/kveconomy/tiering.py``. The paged
``BlockAllocator`` keeps finished prompts' full blocks in a refcounted
prefix pool on the card and LRU-evicts them under pressure. This tier
catches those evictions: the victim block's raw pool rows (whatever the
pool dtype: bf16 stays bf16, int4 stays nibble-packed, scales stay f32)
are copied to host memory and parked here, keyed by the same token-chain
hash the pool uses. A later ``match_prefix`` walk that misses the pool but
hits the tier re-onboards the block into a free (or freshly evicted) pool
block and keeps walking, so the prefix cache holds as many blocks as host
RAM allows instead of as many as the card does.

The tier is a byte-budgeted LRU dict of payloads. It never touches the
device: the allocator owns the pack/load callbacks (wired by
``ModelRunner`` through ``BlockAllocator.attach_tier``). A payload is a
:class:`BlockPayload`, a dict of host tensors (or numpy arrays) whose
byte count (``payload_nbytes``) equals the JAX package's for the same
pool. On the card the rows land in pinned memory by an asynchronous copy
ordered on the engine's stream, and the payload carries the CUDA event
recorded after it: a host reader calls :meth:`BlockPayload.wait` before
reading the bytes; a reload copies them back on the same stream, after
the spill's copy, and waits for nothing.

Thread-safety: the allocator calls in from the engine thread under its
own lock; stats scrapes come from API threads. Every method takes the
tier lock, and payloads are handed over whole (never mutated).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional


def tier_budget_from_env() -> int:
    """``LOCALAI_KV_TIER_MB`` → budget bytes (0 = tiering disabled)."""
    try:
        mb = float(os.environ.get("LOCALAI_KV_TIER_MB", "") or 0)
    except ValueError:
        mb = 0.0
    return max(0, int(mb * (1 << 20)))


def tier_from_env() -> Optional["HostTier"]:
    """A :class:`HostTier` sized by ``LOCALAI_KV_TIER_MB``, or None when
    the variable is unset or zero (tiering off)."""
    budget = tier_budget_from_env()
    return HostTier(budget) if budget > 0 else None


def payload_nbytes(payload: dict) -> int:
    """Bytes of a payload's arrays (torch tensors and numpy arrays alike:
    both carry ``nbytes``)."""
    return sum(int(a.nbytes) for a in payload.values())


class BlockPayload(dict):
    """One spilled block's rows by name (``k``, ``v`` and, for scaled
    pools, ``k_scale``, ``v_scale``), with the CUDA event recorded after
    their device-to-host copy (None on the CPU)."""

    event = None

    def wait(self) -> "BlockPayload":
        """Block until the rows are in host memory; returns self."""
        if self.event is not None:
            self.event.synchronize()
        return self


class HostTier:
    """Byte-budgeted LRU store of spilled block payloads, keyed by the
    allocator's chain hash (hexdigest)."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError("tier budget must be > 0 bytes")
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        # key → (payload, nbytes); LRU order, evicted from the front
        self._entries: "OrderedDict[str, tuple[dict, int]]" = OrderedDict()
        self._bytes = 0
        # lifetime accounting (the allocator keeps its own spill/reload
        # counters on top; these are the tier's internal churn)
        self.stores_total = 0
        self.takes_total = 0
        self.budget_drops_total = 0   # LRU-dropped to fit the budget
        self.oversize_rejects_total = 0

    def put(self, key: str, payload: dict) -> bool:
        """Park one spilled block. Evicts tier-LRU entries to fit the
        byte budget; returns False (nothing stored) when the payload
        alone exceeds it."""
        nb = payload_nbytes(payload)
        if nb > self.budget_bytes:
            with self._lock:
                self.oversize_rejects_total += 1
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            while self._entries and self._bytes + nb > self.budget_bytes:
                _, (_, freed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self.budget_drops_total += 1
            self._entries[key] = (payload, nb)
            self._bytes += nb
            self.stores_total += 1
        return True

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def take(self, key: str) -> Optional[dict]:
        """Pop ``key``'s payload (a reload consumes the spill: a block is
        resident in the pool XOR spilled, never both). None on a miss."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            payload, nb = entry
            self._bytes -= nb
            self.takes_total += 1
            return payload

    def discard(self, key: str) -> None:
        """Drop a stale spill (its chain re-materialized in the pool)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry[1]

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "stores_total": self.stores_total,
                "takes_total": self.takes_total,
                "budget_drops_total": self.budget_drops_total,
                "oversize_rejects_total": self.oversize_rejects_total,
            }
