"""Fleet prefix directory: which replica holds which prefix blocks.

Port of ``localai_tpu/fleet/kveconomy/directory.py``. The router's
consistent-hash affinity is a heuristic: it predicts where a prefix
should be warm. This directory is the record of where prefixes are warm:
the fleet scheduler notes (key → replica) on every completed request,
sibling transfer and migration, keyed by the same token-chain block hash
``fleet.router.affinity_key`` computes (the paged allocator's sharing
granularity). The router consults it before the ring walk, so a request
whose affinity target changed (ring remap, failover, queue override)
still lands on known-warm KV; when placement cannot follow the KV, the
fleet scheduler pulls the prefix from the holding sibling instead of
re-prefilling.

Entries are hints, never load-bearing: a stale holder (replica-side LRU
eviction, a respawn that beat the death listener) costs one failed fetch,
after which the caller drops the entry and falls back to a plain
prefill. Replica death invalidates eagerly through ``drop_replica``
(wired to the pool's death listener).

All methods are thread-safe (routing threads, dispatch threads and the
pool monitor all call in).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Iterable, Optional


def directory_capacity_from_env() -> int:
    """``LOCALAI_KV_DIR_ENTRIES`` (default 4096): max tracked keys."""
    try:
        n = int(os.environ.get("LOCALAI_KV_DIR_ENTRIES", "") or 4096)
    except ValueError:
        n = 4096
    return max(16, n)


class PrefixDirectory:
    """LRU map of affinity key → ordered set of replica ids holding it."""

    def __init__(self, max_entries: Optional[int] = None):
        self.max_entries = (directory_capacity_from_env()
                            if max_entries is None else max(1, max_entries))
        self._lock = threading.Lock()
        # key → OrderedDict[rid, None]: the most recently confirmed holder
        # LAST (lookup prefers it: the freshest KV is least likely evicted)
        self._entries: "OrderedDict[int, OrderedDict[str, None]]" = \
            OrderedDict()
        self.notes = 0
        self.hits = 0
        self.misses = 0
        self.drops = 0            # single stale holders dropped
        self.invalidations = 0    # whole-replica invalidations

    def note(self, key: Optional[int], rid: str) -> None:
        """Record that ``rid`` now holds ``key``'s prefix blocks."""
        if key is None or not rid:
            return
        with self._lock:
            holders = self._entries.get(key)
            if holders is None:
                holders = OrderedDict()
                self._entries[key] = holders
            holders.pop(rid, None)
            holders[rid] = None
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            self.notes += 1

    def lookup(self, key: Optional[int],
               eligible: Iterable[str]) -> Optional[str]:
        """Routing probe: the freshest holder of ``key`` among
        ``eligible`` replica ids, counting hit/miss. None when unknown."""
        if key is None:
            return None
        allowed = set(eligible)
        with self._lock:
            holders = self._entries.get(key)
            if holders:
                for rid in reversed(holders):
                    if rid in allowed:
                        self._entries.move_to_end(key)
                        self.hits += 1
                        return rid
            self.misses += 1
            return None

    def holder(self, key: Optional[int], eligible: Iterable[str],
               exclude: Iterable[str] = ()) -> Optional[str]:
        """Like :meth:`lookup` but counter-silent: the sibling-fetch
        probe, which runs after routing already counted this request."""
        if key is None:
            return None
        allowed = set(eligible) - set(exclude)
        with self._lock:
            holders = self._entries.get(key)
            if holders:
                for rid in reversed(holders):
                    if rid in allowed:
                        return rid
            return None

    def drop(self, key: Optional[int], rid: str) -> None:
        """A fetch against ``rid`` for ``key`` failed: the entry was stale
        (replica-side LRU eviction). Forget that holder."""
        if key is None:
            return
        with self._lock:
            holders = self._entries.get(key)
            if holders is None or rid not in holders:
                return
            del holders[rid]
            if not holders:
                del self._entries[key]
            self.drops += 1

    def drop_replica(self, rid: str) -> int:
        """The replica died, respawned or was evicted: every entry naming
        it is stale at once (a respawned engine boots cold). Returns the
        entries touched."""
        touched = 0
        with self._lock:
            dead_keys = []
            for key, holders in self._entries.items():
                if rid in holders:
                    del holders[rid]
                    touched += 1
                    if not holders:
                        dead_keys.append(key)
            for key in dead_keys:
                del self._entries[key]
            if touched:
                self.invalidations += 1
        return touched

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "notes": self.notes,
                "hits": self.hits,
                "misses": self.misses,
                "drops": self.drops,
                "invalidations": self.invalidations,
            }
