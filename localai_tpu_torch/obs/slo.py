"""SLO observatory: sliding-window latency aggregates + burn-rate shedding.

A copy of ``localai_tpu/obs/slo.py`` (the windows, the burn-rate math,
the hysteresis state machine, the report and the gauges kept).

Two halves, both host-side only (no device reads anywhere):

**Observe.** Every finished generation lands one event per model —
``(ts, ttft_ms, tpot_ms, e2e_ms, queue_ms, bad)`` — in a time-ordered,
horizon-pruned series with cumulative bad counts
(:meth:`SLOTracker.observe`, fed by ``obs.engine.EngineTelemetry``), so
the per-request admission check costs two bisects, not a scan.
Percentiles per metric are computed over sliding windows (1m/5m/30m) on
demand: the windowed view of serving latency that the cumulative
``/metrics`` histograms cannot give.

**React.** Targets are p95 latency bounds in milliseconds
(``LOCALAI_SLO_TTFT_P95_MS`` / ``_TPOT_`` / ``_E2E_`` / ``_QUEUE_``, or the
matching ``AppConfig.slo_*`` fields / ``--slo-*`` CLI flags; 0/unset
disables a target). An event is *bad* when any configured target is
exceeded (or the request finished with reason ``error``). With a 95%
objective the error budget is 5%, and the **burn rate** of a window is
``bad_fraction / 0.05`` — 1.0 means burning exactly the budget. When the
fast (1m) AND slow (5m) burn rates both exceed
``LOCALAI_SLO_BURN_THRESHOLD`` (default 2.0) with at least
``LOCALAI_SLO_MIN_EVENTS`` completions in the fast window, the model
enters *shedding*: the API admission hook (``api.inference.shed_check``) refuses new generation work with
HTTP 429 + ``Retry-After`` (``localai_overload_shedding{model=...}=1``,
``localai_requests_shed_total``). Recovery is automatic with hysteresis:
shedding stops once the fast burn rate falls below
``LOCALAI_SLO_RECOVER_BURN`` (default 1.0) — which happens on its own as
the fast window slides past the violation burst (shed requests never
become events).

Multi-window burn-rate alerting follows the SRE-workbook shape; the
admission gate is the Sarathi-class "don't admit what you can't serve
inside the SLO" half, degraded gracefully to explicit 429s instead of
unbounded queueing.

``SLO`` is the process-wide instance (like ``REGISTRY``/``STORE``);
surfaced at ``GET /v1/slo`` and in the ``/metrics`` exposition at scrape
time via :meth:`SLOTracker.export_gauges`.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from localai_tpu_torch.obs.metrics import REGISTRY, Registry

# (label, seconds), fast → slow; FAST/SLOW drive the shedding decision
WINDOWS = (("1m", 60.0), ("5m", 300.0), ("30m", 1800.0))
FAST, SLOW = "1m", "5m"
_SPAN = {label: s for label, s in WINDOWS}
METRICS = ("ttft_ms", "tpot_ms", "e2e_ms", "queue_ms")
_TARGET_ENV = {
    "ttft_ms": "LOCALAI_SLO_TTFT_P95_MS",
    "tpot_ms": "LOCALAI_SLO_TPOT_P95_MS",
    "e2e_ms": "LOCALAI_SLO_E2E_P95_MS",
    "queue_ms": "LOCALAI_SLO_QUEUE_P95_MS",
}


def _env_float(name: str, fallback: float) -> float:
    try:
        return float(os.environ.get(name, "") or fallback)
    except ValueError:
        return fallback


def env_targets() -> dict[str, float]:
    """p95 targets from the environment (0/unset/garbage = no target)."""
    out = {}
    for metric, env in _TARGET_ENV.items():
        v = _env_float(env, 0.0)
        if v > 0:
            out[metric] = v
    return out


def targets_from_config(cfg) -> dict[str, float]:
    """p95 targets from AppConfig's ``slo_*_p95_ms`` fields (0 = unset)."""
    out = {}
    for metric, field in (("ttft_ms", "slo_ttft_p95_ms"),
                          ("tpot_ms", "slo_tpot_p95_ms"),
                          ("e2e_ms", "slo_e2e_p95_ms"),
                          ("queue_ms", "slo_queue_p95_ms")):
        v = float(getattr(cfg, field, 0.0) or 0.0)
        if v > 0:
            out[metric] = v
    return out


class _Event:
    __slots__ = ("ts", "ttft_ms", "tpot_ms", "e2e_ms", "queue_ms", "bad")

    def __init__(self, ts, ttft_ms, tpot_ms, e2e_ms, queue_ms, bad):
        self.ts = ts
        self.ttft_ms = ttft_ms
        self.tpot_ms = tpot_ms
        self.e2e_ms = e2e_ms
        self.queue_ms = queue_ms
        self.bad = bad


class _Series:
    """One model's completion history, time-ordered, with a parallel
    timestamp array and cumulative bad counts — so the admission path's
    per-request burn-rate checks are two bisects (O(log n)), not linear
    scans over 30 minutes of events (which would peak in cost exactly
    during the overload the gate exists to survive)."""

    __slots__ = ("events", "ts", "bad_cum")

    def __init__(self):
        self.events: list[_Event] = []
        self.ts: list[float] = []
        self.bad_cum: list[int] = []   # bad_cum[i] = bad events in [0..i]

    def append(self, e: _Event) -> None:
        # observe() stamps ts from one monotonic clock, so appends stay
        # time-ordered by construction
        self.events.append(e)
        self.ts.append(e.ts)
        prev = self.bad_cum[-1] if self.bad_cum else 0
        self.bad_cum.append(prev + (1 if e.bad else 0))

    def prune(self, horizon: float) -> None:
        """Bound memory by dropping expired events — LAZILY. Stale
        entries are already invisible to counts()/window() (both bisect
        on the cutoff), so the only reason to delete is memory; the O(n)
        rebuild runs only once the stale prefix dominates (≥ half, min
        64), which drops ≥ n/2 each time — amortized O(1) per event
        instead of a full-window rebuild on nearly every completion
        under steady traffic."""
        cut = bisect.bisect_left(self.ts, horizon)
        if cut < 64 or cut * 2 < len(self.ts):
            return
        base = self.bad_cum[cut - 1]
        del self.events[:cut]
        del self.ts[:cut]
        self.bad_cum = [b - base for b in self.bad_cum[cut:]]

    def counts(self, cutoff: float) -> tuple[int, int]:
        """(total, bad) for events with ts >= cutoff — two index ops."""
        i = bisect.bisect_left(self.ts, cutoff)
        n = len(self.ts) - i
        if n == 0:
            return 0, 0
        bad = self.bad_cum[-1] - (self.bad_cum[i - 1] if i else 0)
        return n, bad

    def window(self, cutoff: float) -> list[_Event]:
        return self.events[bisect.bisect_left(self.ts, cutoff):]


class SLOTracker:
    """Per-model sliding-window SLO aggregates + shedding state machine."""

    def __init__(self, *, registry: Optional[Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 targets: Optional[dict[str, float]] = None,
                 objective: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 recover_burn: Optional[float] = None,
                 min_events: Optional[int] = None,
                 retry_after_s: Optional[int] = None):
        self.registry = registry or REGISTRY
        self._clock = clock
        self.targets = (dict(targets) if targets is not None
                        else env_targets())
        self.objective = (objective if objective is not None
                          else _env_float("LOCALAI_SLO_OBJECTIVE", 0.95))
        self.burn_threshold = (
            burn_threshold if burn_threshold is not None
            else _env_float("LOCALAI_SLO_BURN_THRESHOLD", 2.0))
        self.recover_burn = (
            recover_burn if recover_burn is not None
            else _env_float("LOCALAI_SLO_RECOVER_BURN", 1.0))
        self.min_events = (
            min_events if min_events is not None
            else int(_env_float("LOCALAI_SLO_MIN_EVENTS", 5)))
        self.retry_after_s = (
            retry_after_s if retry_after_s is not None
            else int(_env_float("LOCALAI_SLO_RETRY_AFTER_S", 30)))
        self._lock = threading.Lock()
        self._events: dict[str, _Series] = {}
        self._shedding: dict[str, bool] = {}
        self._shed_total: dict[str, int] = {}
        # fired once per not-shedding → shedding transition (the anomaly
        # profiler hooks this: a shed ONSET is the moment worth a capture,
        # not every request refused while shedding stands)
        self._shed_callbacks: list[Callable[[str], None]] = []

    # -- configuration ----------------------------------------------------

    def configure(self, *, targets: Optional[dict[str, float]] = None,
                  objective: Optional[float] = None,
                  burn_threshold: Optional[float] = None,
                  recover_burn: Optional[float] = None,
                  min_events: Optional[int] = None,
                  retry_after_s: Optional[int] = None) -> None:
        """Replace the given knobs (server boot wires AppConfig through
        here; omitted knobs keep their current values).

        Deliberately lock-free: each knob is an atomic reference swap
        (``targets`` is replaced wholesale with a fresh dict, never
        mutated in place), and the admission path reads them lock-free —
        a reader sees the old or the new configuration, both valid.
        Taking ``_lock`` here would promote every one of those hot reads
        to a lock acquisition for no consistency gain."""
        if targets is not None:
            self.targets = {k: float(v) for k, v in targets.items()
                            if float(v) > 0}
        if objective is not None:
            self.objective = objective
        if burn_threshold is not None:
            self.burn_threshold = burn_threshold
        if recover_burn is not None:
            self.recover_burn = recover_burn
        if min_events is not None:
            self.min_events = min_events
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s

    def reset(self) -> None:
        """Drop all events and shedding state (tests, reconfiguration).
        Clears the per-model shedding gauges it owns so a stale 1 cannot
        outlive the state that justified it."""
        with self._lock:
            models = set(self._shedding) | set(self._events)
            self._events.clear()
            self._shedding.clear()
            self._shed_total.clear()
        for m in models:
            self.registry.overload_shedding.set(0, model=m)

    # -- observe ----------------------------------------------------------

    def observe(self, model: str, *, ttft_ms: Optional[float] = None,
                tpot_ms: Optional[float] = None,
                e2e_ms: Optional[float] = None,
                queue_ms: Optional[float] = None,
                error: bool = False,
                now: Optional[float] = None) -> None:
        """One finished request. ``bad`` is decided against the CURRENT
        targets at observe time; events older than the longest window are
        lazily pruned on the way in (see :meth:`_Series.prune`)."""
        now = self._clock() if now is None else now
        vals = {"ttft_ms": ttft_ms, "tpot_ms": tpot_ms,
                "e2e_ms": e2e_ms, "queue_ms": queue_ms}
        bad = error or any(
            vals[m] is not None and vals[m] > t
            for m, t in self.targets.items()
        )
        horizon = now - WINDOWS[-1][1]
        with self._lock:
            series = self._events.get(model)
            if series is None:
                series = self._events[model] = _Series()
            series.append(
                _Event(now, ttft_ms, tpot_ms, e2e_ms, queue_ms, bad))
            series.prune(horizon)

    def _counts(self, model: str, seconds: float,
                now: float) -> tuple[int, int]:
        """(total, bad) in the window — O(log n), the admission-path
        primitive (should_shed runs on every generation request)."""
        with self._lock:
            series = self._events.get(model)
            if series is None:
                return 0, 0
            return series.counts(now - seconds)

    def _window(self, model: str, seconds: float,
                now: float) -> list[_Event]:
        with self._lock:
            series = self._events.get(model)
            if series is None:
                return []
            return series.window(now - seconds)

    # -- aggregates -------------------------------------------------------

    def burn_rate(self, model: str, window: str = FAST,
                  now: Optional[float] = None) -> float:
        """bad_fraction / error_budget over the window (0.0 when empty)."""
        now = self._clock() if now is None else now
        n, bad = self._counts(model, _SPAN[window], now)
        if n == 0:
            return 0.0
        budget = max(1e-9, 1.0 - self.objective)
        return bad / n / budget

    def windows(self, model: str, now: Optional[float] = None) -> dict:
        """Per-window aggregates: count, bad count, burn rate, and
        p50/p95/p99 per latency metric."""
        now = self._clock() if now is None else now
        budget = max(1e-9, 1.0 - self.objective)
        out = {}
        for label, seconds in WINDOWS:
            events = self._window(model, seconds, now)
            agg: dict = {
                "count": len(events),
                "bad": sum(1 for e in events if e.bad),
            }
            agg["burn_rate"] = (
                round(agg["bad"] / agg["count"] / budget, 4)
                if events else 0.0
            )
            for metric in METRICS:
                vals = [getattr(e, metric) for e in events
                        if getattr(e, metric) is not None]
                if vals:
                    p50, p95, p99 = np.percentile(vals, (50, 95, 99))
                    agg[metric] = {"p50": round(float(p50), 3),
                                   "p95": round(float(p95), 3),
                                   "p99": round(float(p99), 3)}
                else:
                    agg[metric] = None
            out[label] = agg
        return out

    # -- shedding state machine -------------------------------------------

    def _update_state(self, model: str, now: float) -> bool:
        """Run the hysteresis state machine for one model and keep its
        gauge current. Called from the admission path AND from every
        export/report — recovery must not depend on another request
        arriving (a shedding model whose clients all back off would
        otherwise stay latched at 1 forever)."""
        if not self.targets:
            # no objectives configured: never shed, and un-latch any
            # state left over from a previous configuration
            with self._lock:
                was = self._shedding.pop(model, False)
            if was:
                self.registry.overload_shedding.set(0, model=model)
            return False
        fast = self.burn_rate(model, FAST, now=now)
        slow = self.burn_rate(model, SLOW, now=now)
        n_fast, _ = self._counts(model, _SPAN[FAST], now)
        with self._lock:
            was = self._shedding.get(model, False)
            shedding = was
            if shedding:
                if fast < self.recover_burn:
                    shedding = False
            elif (fast >= self.burn_threshold
                    and slow >= self.burn_threshold
                    and n_fast >= self.min_events):
                shedding = True
            # don't resurrect a reset/unknown model's entry just to say
            # "not shedding" — only track models with actual state
            if shedding or model in self._shedding:
                self._shedding[model] = shedding
            callbacks = (list(self._shed_callbacks)
                         if shedding and not was else ())
        self.registry.overload_shedding.set(1 if shedding else 0,
                                            model=model)
        for cb in callbacks:  # onset only, outside the lock
            try:
                cb(model)
            except Exception:  # noqa: BLE001 — observers must not break
                pass           # the admission path
        return shedding

    def on_shed(self, cb: Callable[[str], None]) -> None:
        """Register a callback fired once per shedding ONSET (the
        not-shedding → shedding transition) with the model name.
        Exceptions are swallowed — an observer must never break the
        admission path that detected the overload."""
        with self._lock:
            self._shed_callbacks.append(cb)

    def remove_shed_callback(self, cb: Callable[[str], None]) -> None:
        """Unregister an onset callback (the anomaly profiler detaches
        at stop() so a torn-down manager's closure is not kept alive —
        and a later install cannot double-fire)."""
        with self._lock:
            try:
                self._shed_callbacks.remove(cb)
            except ValueError:
                pass

    def should_shed(self, model: str, now: Optional[float] = None) -> bool:
        """The admission-path decision, with hysteresis.

        Not shedding → shedding when fast AND slow burn rates exceed the
        threshold with enough fast-window evidence; shedding → recovered
        when the fast burn rate falls below ``recover_burn`` (shed
        requests never become events, so the fast window drains on its
        own).
        """
        return self._update_state(
            model, self._clock() if now is None else now)

    def shed(self, model: str) -> int:
        """Record one refused request; returns the Retry-After seconds.
        Sole writer of ``localai_requests_shed_total`` (the scheduler's
        ``shed_total`` mirror feeds only the JSON metrics surface)."""
        with self._lock:
            self._shed_total[model] = self._shed_total.get(model, 0) + 1
        self.registry.requests_shed.inc(model=model)
        return self.retry_after_s

    def shedding(self, model: str, now: Optional[float] = None) -> bool:
        """Current shedding state, recovery-aware (re-runs the state
        machine so a latched flag cannot outlive its windows)."""
        return self._update_state(
            model, self._clock() if now is None else now)

    def shed_total(self, model: str) -> int:
        with self._lock:
            return self._shed_total.get(model, 0)

    # -- export -----------------------------------------------------------

    def export_gauges(self, registry: Optional[Registry] = None,
                      now: Optional[float] = None) -> None:
        """Refresh the burn-rate + shedding gauges for every observed
        model (called at /metrics scrape time — the engine thread never
        touches the registry)."""
        reg = registry or self.registry
        now = self._clock() if now is None else now
        with self._lock:
            models = set(self._events) | set(self._shedding)
        for model in models:
            for label, _ in WINDOWS:
                reg.slo_burn_rate.set(
                    round(self.burn_rate(model, label, now=now), 4),
                    model=model, window=label)
            # re-runs the state machine: a scrape must observe recovery
            # even with zero traffic. The explicit set also materializes
            # the 0 series for observed-but-never-shedding models (and
            # for no-target configs), so dashboards can key on it.
            shedding = self._update_state(model, now)
            reg.overload_shedding.set(1 if shedding else 0, model=model)

    def report(self, now: Optional[float] = None) -> dict:
        """The GET /v1/slo payload."""
        now = self._clock() if now is None else now
        with self._lock:
            models = sorted(set(self._events) | set(self._shedding))
            targets = dict(self.targets)
        return {
            "targets": targets,
            "objective": self.objective,
            "burn_threshold": self.burn_threshold,
            "recover_burn": self.recover_burn,
            "min_events": self.min_events,
            "windows": [label for label, _ in WINDOWS],
            "models": {
                m: {
                    "shedding": self.shedding(m, now=now),
                    "shed_total": self.shed_total(m),
                    "windows": self.windows(m, now=now),
                }
                for m in models
            },
        }


# the process-wide observatory (EngineTelemetry and the API default to it)
SLO = SLOTracker()
