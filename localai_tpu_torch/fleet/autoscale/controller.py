"""The closed capacity loop: harvest signals, decide, actuate.

Port of ``localai_tpu/fleet/autoscale/controller.py``. One daemon per
fleet-served model. Scale-out adopts a configured standby host first
(capacity without a boot), else spawns a fresh replica through the pool's
own factory (``pool.spawn``: the boot-time path, with device pinning for
worker replicas). Scale-in is
drain-based: every in-flight slot is live-migrated off the victim
(``FleetScheduler.drain``) before it is retired from the pool, so no
request is lost, and the scale-in is deferred when a request cannot be
moved yet. The retired replica's engine is stopped, which frees its
weights and KV pool on the card.

Scale-to-zero parks ``request_capacity`` on the scheduler's ``on_cold``
hook: when routing finds no healthy replica, the dispatch thread calls
it and waits for a cold boot instead of erroring; the held request is
served by the replica its own arrival booted.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from localai_tpu_torch.fleet.autoscale import density
from localai_tpu_torch.fleet.autoscale.policy import (ACTIONS, AutoscaleConfig,
                                                AutoscalePolicy, Decision,
                                                ReplicaSignals)
from localai_tpu_torch.obs.history import HISTORY
from localai_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)


class AutoscaleController:
    """Telemetry-driven replica lifecycle for one FleetServingModel."""

    def __init__(self, fm, *, config: Optional[AutoscaleConfig] = None,
                 manager=None):
        self.fm = fm
        self.pool = fm.pool
        self.cfg = config or AutoscaleConfig.from_app(fm.app)
        self.policy = AutoscalePolicy(self.cfg)
        #: ModelManager, when attached — enables the density reaper
        self.manager = manager
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()        # serialises actuation
        self._cold_lock = threading.Lock()   # single-flight cold boot
        self.decisions = {a: 0 for a in ACTIONS}
        self.last_decision: Optional[dict] = None
        self.evictions: list = []
        self.target = len(self.pool.healthy("decode")) or fm.app.fleet_replicas
        fm.scheduler.on_cold = self.request_capacity

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"autoscale:{self.fm.name}", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        if self.fm.scheduler.on_cold is self.request_capacity:
            self.fm.scheduler.on_cold = None

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("autoscale %s: tick failed", self.fm.name)

    # -- signal harvest -----------------------------------------------------

    def signals(self) -> list:
        """Per-decode-replica policy input off the live pool: lifecycle
        state + idle clock always, engine telemetry and SLO burn for the
        healthy ones."""
        out = []
        for r in self.pool.members():
            if r.role != "decode":
                continue
            sig = ReplicaSignals(rid=r.id, state=r.state,
                                 inflight=r.inflight, idle_s=r.idle_s())
            if r.state == "healthy":
                try:
                    m = r.metrics()
                except Exception:  # noqa: BLE001 — telemetry ≠ serving
                    m = {}
                sig.queue_depth = float(m.get("queue_depth") or 0.0)
                sig.kv_util = float(m.get("kv_utilization") or 0.0)
                sig.step_p99_ms = float(m.get("step_ms_p99") or 0.0)
                sig.burn_1m = self.fm.slo.burn_rate(r.id, "1m")
                sig.burn_5m = self.fm.slo.burn_rate(r.id, "5m")
            out.append(sig)
        return out

    # -- the loop body ------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        decision = self.policy.decide(self.signals(), now)
        applied = self._apply(decision, now)
        action = decision.action if applied or decision.action == "none" \
            else "none"
        self.decisions[action] += 1
        self.target = decision.target if applied else \
            len(self.pool.healthy("decode"))
        self.last_decision = {
            "action": action, "reason": decision.reason,
            "target": decision.target, "rid": decision.rid,
            "applied": applied,
        }
        REGISTRY.autoscale_decisions.inc(model=self.fm.name, action=action)
        REGISTRY.fleet_target_replicas.set(self.target, model=self.fm.name)
        HISTORY.record(f"fleet_target_replicas.{self.fm.name}", self.target)
        if self.manager is not None:
            evicted = density.evict_lru_model(
                self.manager, keep=(self.fm.name,),
                threshold=self.cfg.hbm_threshold)
            if evicted:
                self.evictions.append(evicted)
        return decision

    def _apply(self, decision: Decision, now: float) -> bool:
        if decision.action == "none":
            return False
        # the actuation lock is held across the drain-and-poll on purpose:
        # it serialises capacity mutations (daemon tick vs. manual tick vs.
        # cold start), and nothing latency-sensitive ever waits on it
        with self._lock:
            if decision.action == "scale_out":
                ok = self._scale_out()
            elif decision.action == "scale_in":
                ok = self._scale_in(decision.rid)
            elif decision.action == "scale_to_zero":
                ok = self._scale_to_zero()
            else:
                ok = False
        if ok:
            self.policy.note(decision.action, now)
            log.info("autoscale %s: %s (%s) → target %d", self.fm.name,
                     decision.action, decision.reason, decision.target)
        return ok

    # -- actuation ----------------------------------------------------------

    def _scale_out(self) -> bool:
        for addr in self.cfg.standby_hosts:
            rid = f"{self.fm.name}/{addr}"
            if self.pool.get(rid) is not None:
                continue  # already adopted (perhaps evicted, redialing)
            res = self.fm.adopt_remote(addr)
            if res.get("state") == "healthy":
                log.info("autoscale %s: adopted standby %s", self.fm.name,
                         addr)
                return True
        return self.pool.spawn("decode", wait=True) is not None

    def _scale_in(self, rid: Optional[str]) -> bool:
        replica = self.pool.get(rid) if rid else None
        if replica is None:
            return False
        self.fm.scheduler.drain(rid)
        deadline = time.monotonic() + 10.0
        while replica.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        if replica.inflight > 0:
            # a request neither migrated nor finished — keep the replica,
            # the next tick retries; never lose a request to a scale-in
            log.warning("autoscale %s: %s still busy after drain; "
                        "deferring scale-in", self.fm.name, rid)
            return False
        return self.pool.remove(rid)

    def _scale_to_zero(self) -> bool:
        ok = True
        for r in list(self.pool.healthy("decode")):
            ok = self._scale_in(r.id) and ok
        return ok and not self.pool.healthy("decode")

    # -- cold start (scale-to-zero wakeup) ----------------------------------

    def request_capacity(self) -> bool:
        """FleetScheduler.on_cold hook: routing found no healthy replica.
        Boot one (single-flight — concurrent held requests queue on the
        lock and find the capacity the first caller brought up), then
        wait for it within the cold-start budget. True → the scheduler
        re-routes; False → the request errors as before."""
        deadline = time.monotonic() + self.cfg.cold_timeout_s
        started = False
        with self._cold_lock:
            if not self.pool.healthy("decode"):
                log.info("autoscale %s: cold start — replica requested by "
                         "held traffic", self.fm.name)
                self._scale_out()
                started = True
        if started:
            self.decisions["cold_start"] += 1
            REGISTRY.autoscale_decisions.inc(
                model=self.fm.name, action="cold_start")
        while time.monotonic() < deadline:
            if self.pool.healthy("decode"):
                self.target = max(self.target, 1)
                REGISTRY.fleet_target_replicas.set(
                    self.target, model=self.fm.name)
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.05)
        return False

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "target": self.target,
            "min": self.cfg.min_replicas,
            "max": self.cfg.max_replicas,
            "interval_s": self.cfg.interval_s,
            "zero_idle_s": self.cfg.zero_idle_s,
            "decisions": dict(self.decisions),
            "last_decision": self.last_decision,
            "density_evictions": list(self.evictions),
            "standby_hosts": list(self.cfg.standby_hosts),
        }
