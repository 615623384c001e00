"""Cache-aware request placement over a replica fleet.

Port of ``localai_tpu/fleet/router.py``. The paged engine's whole-block
prefix pool and the prompt cache only pay off if requests sharing a
prompt prefix keep landing on the same replica. So the router keys
placement on the prompt's first K token-chain blocks (the block
granularity the paged allocator shares KV at, ``engine.paged``) and maps
that key onto a consistent-hash ring over the live replicas: adding or
losing a replica remaps only ~1/N of the keyspace.

Fallbacks, in order: a short prompt (no full block) routes least-loaded;
a replica the per-replica SLO tracker marks shedding is routed around
(next ring candidate) unless every replica is shedding; a replica that
dies mid-stream is excluded and the retry routes with reason
``failover``. The keys and the ring equal the JAX package's for the same
token ids and replica ids.
"""

from __future__ import annotations

import bisect
import hashlib
import logging
import threading
from typing import Iterable, Optional

import numpy as np

log = logging.getLogger(__name__)

# ring points per replica: one replica's share of the keyspace stays
# within ~2x of fair for small fleets
VNODES = 64
# affinity covers the first K full blocks: enough to separate prompt
# families without making every long shared preamble one hot spot
AFFINITY_BLOCKS = 4


def affinity_key(prompt: list[int], *, block_tokens: int = 64,
                 blocks: int = AFFINITY_BLOCKS) -> Optional[int]:
    """Hash of the prompt's first ``min(blocks, full blocks)`` blocks, or
    None when the prompt does not fill one block (those route
    least-loaded)."""
    if block_tokens <= 0:
        return None
    nb = min(blocks, len(prompt) // block_tokens)
    if nb <= 0:
        return None
    h = hashlib.sha1()
    h.update(np.asarray(prompt[:nb * block_tokens], np.int64).tobytes())
    return int.from_bytes(h.digest()[:8], "big")


class _Ring:
    """Consistent-hash ring: replica ids → VNODES points each."""

    def __init__(self, ids: Iterable[str], vnodes: int = VNODES):
        pts = []
        for rid in ids:
            for v in range(vnodes):
                d = hashlib.sha1(f"{rid}#{v}".encode()).digest()
                pts.append((int.from_bytes(d[:8], "big"), rid))
        self.points = sorted(pts)
        # cached across requests (Router._ring): a route costs one bisect
        # and a short walk, not a rebuild
        self._hashes = [h for h, _ in self.points]
        self._n_ids = len({rid for _, rid in self.points})

    def ordered(self, key: int) -> list[str]:
        """Distinct replica ids in clockwise ring order from ``key``: the
        failover / route-around preference order for this prompt."""
        if not self.points:
            return []
        start = bisect.bisect_left(self._hashes, key) % len(self.points)
        out: list[str] = []
        seen = set()
        for i in range(len(self.points)):
            rid = self.points[(start + i) % len(self.points)][1]
            if rid not in seen:
                seen.add(rid)
                out.append(rid)
                if len(out) == self._n_ids:
                    break
        return out


class FleetUnavailable(RuntimeError):
    """No healthy replica can take this request right now."""


class Router:
    """Stateless-per-request placement over a ReplicaPool."""

    def __init__(self, pool, slo=None, *, block_tokens: int = 64,
                 affinity_blocks: int = AFFINITY_BLOCKS,
                 queue_override: int = 0, directory=None):
        self.pool = pool
        self.slo = slo                  # per-replica SLOTracker (optional)
        self.block_tokens = block_tokens
        self.affinity_blocks = affinity_blocks
        # fleet prefix directory (kveconomy.PrefixDirectory, optional): the
        # record of which replica holds which prefix, checked before the
        # ring heuristic
        self.directory = directory
        # decode-admission hint (LOCALAI_FLEET_QUEUE_OVERRIDE, 0 = off):
        # when the affinity target's last reported decode queue depth
        # exceeds this, placement degrades to least-loaded
        self.queue_override = queue_override
        self._ring_cache: tuple[tuple, _Ring] = ((), _Ring(()))
        # every request routes from its own dispatch thread
        self._lock = threading.Lock()
        self.routed = {"affinity": 0, "least_loaded": 0, "failover": 0,
                       "queue_override": 0, "directory": 0}
        self.routed_around = 0          # shed replicas skipped on the ring

    def _ring(self, ids: tuple) -> _Ring:
        cached_ids, ring = self._ring_cache
        if cached_ids != ids:
            ring = _Ring(ids)
            self._ring_cache = (ids, ring)
        return ring

    def _shedding(self, rid: str) -> bool:
        return self.slo is not None and self.slo.shedding(rid)

    def _count(self, reason: str) -> None:
        with self._lock:
            self.routed[reason] += 1

    def route(self, prompt: list[int], *, role: str = "decode",
              exclude: Optional[set] = None,
              failover: bool = False):
        """→ (replica, reason). ``exclude`` holds replica ids that already
        failed this request; ``failover=True`` tags the re-dispatch."""
        exclude = exclude or set()
        live = [r for r in self.pool.healthy(role) if r.id not in exclude]
        if not live:
            raise FleetUnavailable(
                f"no healthy {role} replica available "
                f"(excluded: {sorted(exclude) or 'none'})")
        byid = {r.id: r for r in live}
        eligible = [r for r in live if not self._shedding(r.id)]
        skipped = len(live) - len(eligible)
        if not eligible:
            # every replica is burning budget: routing around all of them
            # would refuse traffic the model-level admission gate chose to
            # admit; degrade to least-loaded instead
            eligible = live
            skipped = 0
        with self._lock:
            self.routed_around += skipped

        def drowning(target) -> bool:
            return bool(self.queue_override
                        and getattr(target, "queue_depth", 0)
                        > self.queue_override)

        key = affinity_key(prompt, block_tokens=self.block_tokens,
                           blocks=self.affinity_blocks)
        if key is not None and self.directory is not None:
            # a replica known to hold this prefix's blocks beats the
            # ring's prediction (after a failover or a ring remap)
            rid = self.directory.lookup(key, (r.id for r in eligible))
            if rid is not None and not drowning(byid[rid]):
                reason = "failover" if failover else "directory"
                self._count(reason)
                return byid[rid], reason
            # holder drowning in queued decodes: fall through; the sibling
            # fetch moves the KV to wherever placement lands
        if key is not None:
            ring = self._ring(tuple(sorted(byid)))
            eligible_ids = {r.id for r in eligible}
            for rid in ring.ordered(key):
                if rid not in eligible_ids:
                    continue
                target = byid[rid]
                if drowning(target):
                    # prefix locality saves a prefill, not a queue wait
                    choice = min(eligible, key=lambda r: r.load)
                    if choice.id != rid:
                        reason = ("failover" if failover
                                  else "queue_override")
                        self._count(reason)
                        return choice, reason
                reason = "failover" if failover else "affinity"
                self._count(reason)
                return target, reason
        # no affinity signal (short prompt) or empty ring: least loaded
        choice = min(eligible, key=lambda r: r.load)
        reason = "failover" if failover else "least_loaded"
        self._count(reason)
        return choice, reason

    def snapshot(self) -> dict:
        with self._lock:
            routed = dict(self.routed)
            routed_around = self.routed_around
        return {
            "routed": routed,
            "routed_around": routed_around,
            "affinity_blocks": self.affinity_blocks,
            "block_tokens": self.block_tokens,
            "queue_override": self.queue_override,
            "vnodes": VNODES,
        }
