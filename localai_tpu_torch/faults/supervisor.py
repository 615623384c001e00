"""EngineSupervisor: the recover half of the detect→recover loop.

Port of ``localai_tpu/faults/supervisor.py``. The obs watchdog already
turns a wedged engine into a signal — a ``kind="stall"`` forensic trace
and an ``engine_stalled`` gauge — but the engine itself would stay wedged
behind its trace. This supervisor subscribes to those stall events for
its scheduler's channel (``engine:<model>``) and escalates:

  1. **trace** — already done by the watchdog (thread stacks + flight
     snapshot recorded before this code runs);
  2. **rebuild** — :meth:`localai_tpu_torch.engine.scheduler.Scheduler.
     rebuild`: the wedged engine thread is fenced off (epoch bump — it
     exits harmlessly whenever its blocked call returns), every request
     holding engine state finishes ``error`` (the API tier maps that to a
     clean 5xx), the runner allocates fresh device state (a new KV pool,
     decode state and block tables; the old tensors are never reused, so
     a fenced thread that wakes writes nothing the new engine reads), a
     probe dispatch verifies the device answers, and a new engine thread
     resumes the still-queued requests;
  3. **backoff** — repeated rebuild attempts are spaced by jittered
     exponential backoff (``LOCALAI_REBUILD_BACKOFF_S`` base, doubled per
     attempt, capped at ``LOCALAI_REBUILD_BACKOFF_CAP_S``);
  4. **failed** — past ``LOCALAI_REBUILD_MAX`` attempts without an
     intervening healthy completion, the model is marked failed:
     everything queued resolves ``error``, ``submit()`` fails fast, and
     ``localai_engine_failed`` latches 1. The manager's dead-engine
     reload path then owns any further recovery.

A healthy completion (``note_healthy``, called by the scheduler when a
request finishes ``stop``/``length``) resets the attempt budget — the
bound is per incident, not per process lifetime.

On the card a rebuild mends host-side wedges only: a sticky CUDA error
(an illegal address, say) poisons the process's context, so every probe
fails and the supervisor escalates to failed — such an error needs a
process restart (an intended divergence, ROADMAP).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Optional

from localai_tpu_torch.obs.metrics import REGISTRY, Registry
from localai_tpu_torch.obs.watchdog import StallEvent

log = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class EngineSupervisor:
    """Self-healing policy for one Scheduler: stall → rebuild → failed."""

    def __init__(self, scheduler, *,
                 max_rebuilds: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 backoff_cap_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 registry: Optional[Registry] = None):
        if (scheduler.spec is not None
                and not getattr(scheduler.spec, "supports_rebuild",
                                False)):
            raise ValueError(
                "this speculative engine cannot be supervised (no "
                "reinit() — its draft state is not independently "
                "rebuildable; localai_tpu_torch.spec.SpecEngine is)")
        self.scheduler = scheduler
        self.registry = registry or REGISTRY
        self.model = scheduler.telemetry.model or "engine"
        self.max_rebuilds = int(max_rebuilds
                                if max_rebuilds is not None
                                else _env_float("LOCALAI_REBUILD_MAX", 3))
        self.backoff_s = (backoff_s if backoff_s is not None
                          else _env_float("LOCALAI_REBUILD_BACKOFF_S", 1.0))
        self.backoff_cap_s = (backoff_cap_s if backoff_cap_s is not None
                              else _env_float(
                                  "LOCALAI_REBUILD_BACKOFF_CAP_S", 60.0))
        self.probe_timeout_s = (probe_timeout_s
                                if probe_timeout_s is not None
                                else _env_float(
                                    "LOCALAI_REBUILD_PROBE_TIMEOUT_S", 30.0))
        self.attempts = 0          # rebuild attempts this incident window
        self._channel = scheduler._wd_channel
        self._detached = False
        self._lock = threading.Lock()
        self._recovering = False
        scheduler.supervisor = self
        scheduler.watchdog.on_stall(self._on_event)
        self.registry.engine_failed.set(0, model=self.model)

    # -- watchdog plumbing ------------------------------------------------

    def detach(self) -> None:
        """Stop reacting to stall events (scheduler shutdown). The
        watchdog drops the dead callback via remove_callback."""
        self._detached = True
        self.scheduler.watchdog.remove_callback(self._on_event)

    def _on_event(self, event: StallEvent) -> None:
        if (self._detached or event.kind != "stall"
                or event.channel != self._channel
                or self.scheduler.failed):
            return
        with self._lock:
            if self._recovering:
                return
            self._recovering = True
        # the callback runs on the watchdog's check thread — recovery
        # (backoff sleeps, device probes) gets its own thread so stall
        # detection for other channels never blocks behind it
        threading.Thread(target=self._recover, daemon=True,
                         name=f"engine-rebuild-{self.model}").start()

    def note_healthy(self) -> None:
        """A request completed naturally: the incident (if any) is over,
        the attempt budget refills."""
        if self.attempts:
            self.attempts = 0

    # -- escalation -------------------------------------------------------

    def _backoff(self, attempt: int) -> float:
        """Exponential with ±25% jitter, capped (attempt 1 → base)."""
        base = min(self.backoff_cap_s,
                   self.backoff_s * (2 ** max(0, attempt - 1)))
        return base * (0.75 + 0.5 * random.random())

    def _recover(self) -> None:
        sched = self.scheduler
        try:
            while not self._detached and not sched._stopping:
                self.attempts += 1
                if self.attempts > self.max_rebuilds:
                    log.error(
                        "engine %s: %d rebuild attempts exhausted; "
                        "marking the model failed", self.model,
                        self.max_rebuilds)
                    self.registry.engine_failed.set(1, model=self.model)
                    sched.mark_failed()
                    return
                if self.attempts > 1:
                    delay = self._backoff(self.attempts - 1)
                    log.warning(
                        "engine %s: rebuild attempt %d/%d in %.2fs",
                        self.model, self.attempts, self.max_rebuilds, delay)
                    self._sleep(delay)
                    if self._detached or sched._stopping:
                        return
                try:
                    sched.rebuild(probe_timeout=self.probe_timeout_s)
                except Exception as e:  # noqa: BLE001 — escalate, not die
                    log.warning("engine %s: rebuild attempt %d failed: %s",
                                self.model, self.attempts, e)
                    continue
                self.registry.engine_rebuilds.inc(model=self.model)
                log.warning(
                    "engine %s: rebuilt after stall (attempt %d); probe "
                    "dispatch ok, engine thread restarted", self.model,
                    self.attempts)
                return
        finally:
            with self._lock:
                self._recovering = False

    def _sleep(self, seconds: float) -> None:
        # interruptible-enough: the thread is a daemon and detach() is
        # checked after (tests replace this hook with a fake clock)
        time.sleep(seconds)

    def status(self) -> dict:
        with self._lock:
            recovering = self._recovering
        return {
            "model": self.model,
            "attempts": self.attempts,
            "max_rebuilds": self.max_rebuilds,
            "rebuilds": self.scheduler.rebuilds,
            "failed": self.scheduler.failed,
            "recovering": recovering,
        }
