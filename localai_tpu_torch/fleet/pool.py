"""ReplicaPool: N live engine replicas for one model, kept alive.

Port of ``localai_tpu/fleet/pool.py``. Every replica is booted at start (concurrently: a cold fleet boots in one
model load, not N), a monitor thread dial-tests each replica on an
interval (timing, consecutive failures), and a replica past the failure
threshold (or whose engine died) is marked ``dead``, taken out of
routing and respawned in the background with a jittered exponential
backoff (``LOCALAI_FLEET_RESPAWN_BASE_S`` / ``_CAP_S``); it rejoins the
ring only after its respawn passes a dial again. ``spawn`` and ``remove``
are the autoscaler's and the hot swap's. Per-replica engine stats are
pulled for ``/v1/fleet`` and the ``localai_fleet_*`` gauges, never on the
dispatch path. The fault sites ``fleet.respawn`` and ``fleet.dial`` fire
here.

Remote replicas (``RemoteReplica``: ``fleet_hosts``, a registration) are
adopted into the same pool but never respawned: this process does not own
them, so a failed remote is evicted from routing and redialed on its own
backoff (``LOCALAI_FLEET_REDIAL_BASE_S`` / ``_CAP_S``), counted in the
snapshot's ``evictions``, ``redials`` and ``redial_backoff_s``."""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Optional

from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.fleet.replica import (DEAD, EVICTED, HEALTHY,
                                             RESPAWNING, BaseReplica)
from localai_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ReplicaPool:
    def __init__(self, model: str,
                 factory: Callable[[str, str], BaseReplica],
                 *, replicas: int = 2, prefill_replicas: int = 0,
                 health_interval: float = 5.0,
                 failure_threshold: int = 3,
                 dial_timeout: float = 2.0,
                 track_queue_depth: bool = False,
                 remotes: Optional[list[BaseReplica]] = None):
        self.model = model
        self.factory = factory
        self.health_interval = health_interval
        self.failure_threshold = failure_threshold
        self.dial_timeout = dial_timeout
        # refresh each healthy replica's reported decode queue depth on
        # the monitor sweep (one stats pull per replica per interval):
        # only the router's queue-override hint reads it
        self.track_queue_depth = track_queue_depth
        self.replicas: list[BaseReplica] = []
        for i in range(replicas):
            self.replicas.append(factory(f"{model}/r{i}", "decode"))
        for i in range(prefill_replicas):
            self.replicas.append(factory(f"{model}/p{i}", "prefill"))
        # runtime-spawn id minting (autoscale scale-out, hot swap): ids
        # only ever advance, so directory entries, SLO windows and backoff
        # books keyed on a retired id never name the newcomer
        self._next_index = {"decode": replicas, "prefill": prefill_replicas}
        self._lock = threading.Lock()
        self._respawning: set[str] = set()
        # death listeners: called with the replica id once per DEAD or
        # EVICTED transition (the prefix directory drops every entry naming
        # it: a respawned engine boots cold)
        self._death_listeners: list[Callable[[str], None]] = []
        self.respawns = 0
        self.adoptions = 0
        # remote lifecycle, apart from local respawns: a failed remote is
        # evicted from routing and redialed on backoff
        self.evictions = 0
        self.redials = 0
        # respawn pacing: a replica whose respawn keeps failing is retried
        # on jittered exponential backoff (base doubled per consecutive
        # failure, capped); a successful rejoin resets the clock. Exported
        # per replica as localai_fleet_respawn_backoff_s (locals) and
        # localai_fleet_redial_backoff_s (remotes)
        self.respawn_backoff_base = _env_float(
            "LOCALAI_FLEET_RESPAWN_BASE_S", 1.0)
        self.respawn_backoff_cap = _env_float(
            "LOCALAI_FLEET_RESPAWN_CAP_S", 60.0)
        self._respawn_failures: dict[str, int] = {}
        self._respawn_after: dict[str, float] = {}
        self.respawn_backoff_s: dict[str, float] = {}
        self.redial_backoff_base = _env_float(
            "LOCALAI_FLEET_REDIAL_BASE_S", self.respawn_backoff_base)
        self.redial_backoff_cap = _env_float(
            "LOCALAI_FLEET_REDIAL_CAP_S", self.respawn_backoff_cap)
        self.redial_backoff_s: dict[str, float] = {}
        self._started = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # statically adopted remotes (fleet_hosts) ride the same adopt()
        # path as runtime joins, and boot with the locals in start()
        for r in remotes or []:
            self.adopt(r)

    # -- boot / teardown ---------------------------------------------------

    def start(self) -> None:
        """Boot every replica concurrently, then start the health monitor.
        A replica that fails to boot is marked dead and left to the
        monitor's respawn path: one bad replica must not abort the
        fleet."""
        errors: dict[str, Exception] = {}

        def boot(r: BaseReplica) -> None:
            try:
                r.start()
                r.dial(self.dial_timeout)
            except Exception as e:  # noqa: BLE001
                errors[r.id] = e
                # an unreachable remote at boot is evicted with a redial,
                # and counted like any other eviction
                r.state = DEAD if r.respawnable else EVICTED
                if not r.respawnable:
                    with self._lock:
                        self.evictions += 1
                    REGISTRY.fleet_evictions.inc(model=self.model,
                                                 replica=r.id)

        members = self.members()
        threads = [threading.Thread(target=boot, args=(r,),
                                    name=f"fleet-boot-{r.id}", daemon=True)
                   for r in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rid, e in errors.items():
            log.warning("fleet %s: replica %s failed to boot: %s",
                        self.model, rid, e)
        if not any(r.state == HEALTHY for r in members):
            # free whatever did boot: without a monitor nothing else will
            for r in members:
                try:
                    r.stop()
                except Exception:  # noqa: BLE001 — teardown must finish
                    log.exception("stopping replica %s failed", r.id)
            raise RuntimeError(
                f"fleet {self.model}: no replica came up "
                f"({ {k: str(v) for k, v in errors.items()} })")
        self._monitor = threading.Thread(
            target=self._run_monitor, name=f"fleet-monitor-{self.model}",
            daemon=True)
        self._monitor.start()
        self._started = True

    def members(self) -> list[BaseReplica]:
        """Locked snapshot of the replica list: every reader iterates a
        copy, so a runtime spawn or removal never invalidates an
        iteration."""
        with self._lock:
            return list(self.replicas)

    def adopt(self, replica: BaseReplica, *, wait: bool = False) -> bool:
        """Add ``replica`` to the pool at runtime. Returns False on a
        duplicate id. Before ``start()`` the replica rides the normal
        concurrent boot; after it, the boot and first dial run on a
        background thread (``wait=True`` runs them inline: a registration
        wants the verdict) and a failed boot lands in the eviction and
        redial path (remote) or the respawn path (local). The router's ring picks the
        newcomer up on its next route (only ~1/N of the affinity keyspace
        remaps)."""
        with self._lock:
            if any(r.id == replica.id for r in self.replicas):
                return False
            self.replicas.append(replica)
            self.adoptions += 1
        REGISTRY.fleet_adoptions.inc(model=self.model)
        if not self._started:
            return True

        def boot() -> None:
            try:
                replica.start()
                if not replica.dial(self.dial_timeout):
                    raise RuntimeError(
                        f"replica {replica.id} failed its first dial")
                log.info("fleet %s: replica %s joined", self.model,
                         replica.id)
            except Exception as e:  # noqa: BLE001 — join ≠ fleet health
                log.warning("fleet %s: replica %s failed to boot: %s",
                            self.model, replica.id, e)
                replica.failures = max(replica.failures,
                                       self.failure_threshold)
                self._mark_dead(replica)

        if wait:
            boot()
        else:
            threading.Thread(target=boot, daemon=True,
                             name=f"fleet-adopt-{replica.id}").start()
        return True

    def spawn(self, role: str = "decode", *,
              wait: bool = True) -> Optional[str]:
        """Mint a new replica through the pool's factory and adopt it
        (autoscale scale-out, hot swap, cold start). Returns the new id,
        or None when the boot failed: the newcomer then stays in the
        respawn loop, so capacity still arrives once the cause clears."""
        with self._lock:
            prefix = "r" if role == "decode" else "p"
            idx = self._next_index.get(role, 0)
            self._next_index[role] = idx + 1
        rid = f"{self.model}/{prefix}{idx}"
        replica = self.factory(rid, role)
        self.adopt(replica, wait=wait)
        if wait and replica.state != HEALTHY:
            return None
        return rid

    def remove(self, rid: str, *, stop: bool = True) -> bool:
        """Retire ``rid`` from the pool (autoscale scale-in, hot swap): it
        leaves the member list (routing loses it on the next ring
        rebuild), its backoff books are cleared, and its ``retired`` flag
        parks any respawn in flight. The caller owns the drain."""
        with self._lock:
            replica = next((r for r in self.replicas if r.id == rid), None)
            if replica is None:
                return False
            replica.retired = True
            self.replicas = [r for r in self.replicas if r.id != rid]
            self._respawn_failures.pop(rid, None)
            self._respawn_after.pop(rid, None)
            self.respawn_backoff_s.pop(rid, None)
            self.redial_backoff_s.pop(rid, None)
        if stop:
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 — removal must finish
                log.exception("stopping retired replica %s failed", rid)
        log.info("fleet %s: replica %s retired from the pool",
                 self.model, rid)
        return True

    def shutdown(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(self.health_interval * 2)
            self._monitor = None
        for r in self.members():
            try:
                r.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("stopping replica %s failed", r.id)

    # -- routing surface ---------------------------------------------------

    def healthy(self, role: str = "decode") -> list[BaseReplica]:
        return [r for r in self.members()
                if r.state == HEALTHY and r.role == role]

    def get(self, rid: str) -> Optional[BaseReplica]:
        for r in self.members():
            if r.id == rid:
                return r
        return None

    def least_loaded(self, role: str = "prefill") -> Optional[BaseReplica]:
        live = self.healthy(role)
        return min(live, key=lambda r: r.load) if live else None

    def add_death_listener(self, fn: Callable[[str], None]) -> None:
        """Register ``fn(replica_id)`` to run on every DEAD or EVICTED
        transition (once per incident: ``_mark_dead`` is idempotent)."""
        with self._lock:
            self._death_listeners.append(fn)

    def note_failure(self, replica: BaseReplica) -> None:
        """A request-level transport failure on ``replica`` (called by the
        dispatch thread). A dead engine is marked dead at once, so later
        requests route around it without waiting for the next sweep, and
        its respawn starts in the background."""
        if replica.state != HEALTHY:
            return
        if not replica.process_alive() or not replica.dial(self.dial_timeout):
            replica.failures = max(replica.failures, self.failure_threshold)
            self._mark_dead(replica)

    # -- monitor -----------------------------------------------------------

    def _run_monitor(self) -> None:
        while not self._stop.wait(self.health_interval):
            self.poll_once()

    def poll_once(self) -> None:
        """One dial-test sweep (the testable unit)."""
        for r in self.members():
            if r.state == RESPAWNING or self._stop.is_set():
                continue
            if r.state in (DEAD, EVICTED):
                with self._lock:
                    hold = self._respawn_after.get(r.id, 0.0)
                if time.monotonic() >= hold:
                    self._spawn_respawn(r)
                continue
            ok = r.process_alive() and r.dial(self.dial_timeout)
            if ok and self.track_queue_depth and r.role == "decode":
                # only decode placement reads the hint
                m = r.metrics()
                # a failed scrape (the error dict) must not pin a stale
                # high reading that strips affinity traffic forever
                r.queue_depth = (int(m.get("queue_depth") or 0)
                                 if "queue_depth" in m else 0)
            if not ok and r.failures >= self.failure_threshold:
                self._mark_dead(r)
            elif not ok and not r.process_alive():
                # no engine left to dial back to life: do not burn the
                # remaining threshold sweeps on it
                r.failures = max(r.failures, self.failure_threshold)
                self._mark_dead(r)

    def _mark_dead(self, r: BaseReplica) -> None:
        # check-and-transition atomically: a dispatch thread's
        # note_failure can race the monitor sweep here, and an eviction
        # is counted once an incident
        with self._lock:
            if r.state in (DEAD, EVICTED):
                return
            r.state = DEAD if r.respawnable else EVICTED
            if not r.respawnable:
                self.evictions += 1
            listeners = list(self._death_listeners)
        for fn in listeners:
            try:
                fn(r.id)
            except Exception:  # noqa: BLE001 — bookkeeping ≠ recovery
                log.exception("death listener failed for %s", r.id)
        if r.respawnable:
            log.warning("fleet %s: replica %s marked dead "
                        "(%d consecutive dial failures)",
                        self.model, r.id, r.failures)
        else:
            # a remote's failure is the network's or the peer's: out of
            # routing, redialed on backoff, no process here to respawn
            log.warning("fleet %s: remote replica %s evicted "
                        "(%d consecutive dial failures)",
                        self.model, r.id, r.failures)
            REGISTRY.fleet_evictions.inc(model=self.model, replica=r.id)
        self._spawn_respawn(r)

    def _spawn_respawn(self, r: BaseReplica) -> None:
        """Bring a dead local replica back (respawn: stop, start) or an
        evicted remote (redial: a fresh dial and LoadModel if it came back
        empty, never a stop-and-spawn) on a thread of its own; either
        rejoins routing after a dial passes. A remote keeps state
        ``evicted`` while its attempt runs."""
        with self._lock:
            if r.id in self._respawning:
                return
            self._respawning.add(r.id)
        down_state = DEAD if r.respawnable else EVICTED
        if r.respawnable:
            r.state = RESPAWNING

        def respawn() -> None:
            try:
                if self._stop.is_set() or r.retired:
                    r.state = down_state
                    return
                try:
                    r.stop()
                except Exception:  # noqa: BLE001
                    pass
                if _faults.ACTIVE and r.respawnable:
                    # a respawn that keeps failing (exercises backoff;
                    # remotes take fleet.dial on the dial after start)
                    _faults.apply("fleet.respawn", key=r.id)
                r.start()
                if self._stop.is_set() or r.retired:
                    # shutdown (or a scale-in removal) raced the boot: its
                    # stop() sweep already ran, so free what just booted
                    try:
                        r.stop()
                    except Exception:  # noqa: BLE001
                        pass
                    r.state = down_state
                    return
                # rejoin routing only after a real dial passes (it flips
                # RESPAWNING → HEALTHY and records the timing)
                if r.dial(self.dial_timeout):
                    with self._lock:
                        if r.respawnable:
                            self.respawns += 1
                        else:
                            self.redials += 1
                    if not r.respawnable:
                        r.state = HEALTHY   # dial() flips only from
                        #                     STARTING/RESPAWNING
                        REGISTRY.fleet_redials.inc(model=self.model,
                                                   replica=r.id)
                    self._note_rejoined(r)
                    log.info("fleet %s: replica %s %s", self.model, r.id,
                             "respawned" if r.respawnable else "redialed")
                else:
                    r.state = down_state
                    self._note_respawn_failed(r)
            except Exception as e:  # noqa: BLE001
                r.state = down_state
                backoff = self._note_respawn_failed(r)
                log.warning("fleet %s: %s of %s failed: %s "
                            "(retrying in %.1fs)", self.model,
                            "respawn" if r.respawnable else "redial",
                            r.id, e, backoff)
            finally:
                with self._lock:
                    self._respawning.discard(r.id)

        threading.Thread(target=respawn, name=f"fleet-respawn-{r.id}",
                         daemon=True).start()

    def _note_respawn_failed(self, r: BaseReplica) -> float:
        """Advance the replica's jittered exponential respawn (local) or
        redial (remote) backoff: base × 2^consecutive failures, ±25%
        jitter, capped. The next sweep skips the replica until the hold
        expires. Returns the delay."""
        if r.respawnable:
            base_s, cap = self.respawn_backoff_base, self.respawn_backoff_cap
            gauge = REGISTRY.fleet_respawn_backoff
        else:
            base_s, cap = self.redial_backoff_base, self.redial_backoff_cap
            gauge = REGISTRY.fleet_redial_backoff
        with self._lock:
            n = self._respawn_failures.get(r.id, 0)
            self._respawn_failures[r.id] = n + 1
            base = min(cap, base_s * (2 ** n))
            delay = min(cap, base * (0.75 + 0.5 * random.random()))
            book = (self.respawn_backoff_s if r.respawnable
                    else self.redial_backoff_s)
            book[r.id] = delay
            self._respawn_after[r.id] = time.monotonic() + delay
        gauge.set(delay, model=self.model, replica=r.id)
        return delay

    def _note_rejoined(self, r: BaseReplica) -> None:
        """A respawn or redial passed its boot and dial: the backoff clock
        resets, so the next incident starts from the base again."""
        gauge = (REGISTRY.fleet_respawn_backoff if r.respawnable
                 else REGISTRY.fleet_redial_backoff)
        with self._lock:
            self._respawn_failures.pop(r.id, None)
            self._respawn_after.pop(r.id, None)
            self.respawn_backoff_s.pop(r.id, None)
            self.redial_backoff_s.pop(r.id, None)
        gauge.set(0.0, model=self.model, replica=r.id)

    # -- observability -----------------------------------------------------

    def states(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.members():
            out[r.state] = out.get(r.state, 0) + 1
        return out

    def snapshot(self, *, with_metrics: bool = False) -> dict:
        reps = []
        for r in self.members():
            snap = r.snapshot()
            if not r.respawnable:
                snap["remote"] = True
                snap["address"] = getattr(r, "address", None)
            if with_metrics and r.state == HEALTHY:
                m = r.metrics()
                # step-time percentiles and spec acceptance ride along so
                # /v1/fleet explains route-around decisions per replica
                snap["engine"] = {
                    k: m.get(k) for k in (
                        "occupancy", "queue_depth", "kv_utilization",
                        "total_generated_tokens", "step_ms_p50",
                        "step_ms_p99", "spec_accept_rate",
                        "spec_tokens_per_dispatch", "error",
                    ) if k in m
                }
            reps.append(snap)
        with self._lock:
            respawns = self.respawns
            evictions = self.evictions
            redials = self.redials
            adoptions = self.adoptions
            backoff = dict(self.respawn_backoff_s)
            redial_backoff = dict(self.redial_backoff_s)
        return {
            "model": self.model,
            "states": self.states(),
            "respawns": respawns,
            "evictions": evictions,
            "redials": redials,
            "adoptions": adoptions,
            "respawn_backoff_s": backoff,
            "redial_backoff_s": redial_backoff,
            "health_interval_s": self.health_interval,
            "failure_threshold": self.failure_threshold,
            "replicas": reps,
        }
