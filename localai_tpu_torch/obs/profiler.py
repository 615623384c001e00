"""Anomaly-triggered device profiler capture: ProfileManager.

A copy of ``localai_tpu/obs/profiler.py``: the triggers, the rate limits,
the single-flight lock and the manifest kept; the capture is
``torch.profiler.profile(activities=[CPU, CUDA])`` writing a Chrome-trace
JSON where the JAX package calls ``jax.profiler.start_trace``.

A profile captured minutes after an operator notices shows a healthy
engine; the capture has to fire when the anomaly happens:

  * **Triggers.** Watchdog stall trips (the engine stopped moving), SLO
    shed onset (latency burned through the error budget), and a step-time
    p99 regression against the flight ring's own trailing window (decode
    quietly got slower). Each calls :meth:`ProfileManager.maybe_capture`
    with the trace id / model that tripped it.
  * **Bounds.** ``LOCALAI_PROFILE_ON_ANOMALY=1`` arms the triggers
    (default off — a capture is real overhead); ``LOCALAI_PROFILE_SECONDS``
    bounds each capture, ``LOCALAI_PROFILE_MAX_PER_HOUR`` +
    ``LOCALAI_PROFILE_COOLDOWN_S`` bound the rate, and a single-flight
    lock (shared with the manual ``POST /backend/trace``) keeps at most
    one capture at a time.
  * **Artifacts.** Profiles land under ``LOCALAI_PROFILE_DIR`` (default
    ``<backend assets>/profiles``); every capture appends ``{id, trigger,
    trace_id, reason, model, path, started_unix, seconds}`` to
    ``manifest.json`` (atomic rewrite), listed at ``GET /debug/profiles``
    and counted as ``localai_profiles_captured_total{trigger=...}``.

Tests inject a fake ``capture_fn`` and clock, so the trigger / rate-limit
/ single-flight state machine runs without a device.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from localai_tpu_torch.obs.metrics import REGISTRY, Registry

log = logging.getLogger(__name__)

TRIGGERS = ("stall", "slo_shed", "step_p99_regression", "manual")


def _env_float(name: str, fallback: float) -> float:
    try:
        return float(os.environ.get(name, "") or fallback)
    except ValueError:
        return fallback


def enabled_from_env() -> bool:
    return os.environ.get("LOCALAI_PROFILE_ON_ANOMALY", "0") == "1"


TRACE_FILE = "trace.json"


def torch_capture(path: str, seconds: float) -> str:
    """The real capture: a bounded ``torch.profiler`` window over the CPU
    and, with a card, CUDA activity, written as a Chrome-trace JSON
    ``path/trace.json``; returns the file's path. The capture runs on an
    HTTP or trigger thread while the engine thread issues the kernels:
    CUPTI records every kernel the process launches, whichever thread
    issued it, and the CPU ops of every thread are recorded through
    ``profile_all_threads``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        # CPU ops are recorded per thread unless asked: the capture runs
        # on its own thread, the ops it wants on the engine's
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass   # a torch without it: CUDA kernels only (CUPTI sees all)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, TRACE_FILE)
    with profile(activities=activities, **kw) as prof:
        time.sleep(seconds)
    prof.export_chrome_trace(out)
    return out


class ProfileManager:
    """Bounded, single-flight, anomaly-triggered profiler captures."""

    def __init__(self, *, enabled: Optional[bool] = None,
                 seconds: Optional[float] = None,
                 out_dir: Optional[str] = None,
                 max_per_hour: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 regression_ratio: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 registry: Optional[Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 capture_fn: Optional[Callable[[str, float], None]] = None):
        self.enabled = enabled if enabled is not None else enabled_from_env()
        self.seconds = (seconds if seconds is not None
                        else _env_float("LOCALAI_PROFILE_SECONDS", 3.0))
        self.out_dir = (out_dir if out_dir is not None
                        else os.environ.get("LOCALAI_PROFILE_DIR",
                                            "profiles"))
        self.max_per_hour = int(
            max_per_hour if max_per_hour is not None
            else _env_float("LOCALAI_PROFILE_MAX_PER_HOUR", 4))
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env_float("LOCALAI_PROFILE_COOLDOWN_S", 300.0))
        # recent-vs-trailing p99 ratio that counts as a decode regression
        self.regression_ratio = (
            regression_ratio if regression_ratio is not None
            else _env_float("LOCALAI_PROFILE_REGRESSION_RATIO", 2.0))
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float("LOCALAI_PROFILE_POLL_S", 5.0))
        self.registry = registry or REGISTRY
        self._clock = clock
        self._capture_fn = capture_fn or torch_capture
        # single-flight: at most one capture at a time, manual included
        # (POST /backend/trace acquires the same lock)
        self._capture_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()
        self._entries: list[dict] = []     
        self._recent: deque = deque()        # capture ts ring (hour cap)
        self._last_capture: Optional[float] = None
        self._seq = 0
        self._skipped: dict[str, int] = {}   # why triggers didn't capture
        # flight recorders watched for step-time regressions: name →
        # weakref (a shut-down scheduler's ring must not be kept alive)
        self._flights: dict[str, Any] = {}
        self._reg_counts: dict[str, int] = {}
        self._installed = False
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the watchdog/SLO instances the hooks were registered on, kept
        # so stop() can DEREGISTER them — otherwise a stop()+install()
        # cycle double-registers and every stall fires two captures
        self._hooked_watchdog: Optional[Any] = None
        self._hooked_slo: Optional[Any] = None

    # -- configuration -----------------------------------------------------

    def configure(self, *, out_dir: Optional[str] = None,
                  seconds: Optional[float] = None,
                  max_per_hour: Optional[int] = None,
                  cooldown_s: Optional[float] = None,
                  enabled: Optional[bool] = None) -> None:
        """Boot-time overrides (the API server points ``out_dir`` under
        the backend-assets tree). Atomic reference swaps, same contract as
        SLOTracker.configure."""
        if out_dir is not None:
            self.out_dir = out_dir
        if seconds is not None:
            self.seconds = seconds
        if max_per_hour is not None:
            self.max_per_hour = max_per_hour
        if cooldown_s is not None:
            self.cooldown_s = cooldown_s
        if enabled is not None:
            self.enabled = enabled

    # -- single-flight surface (shared with POST /backend/trace) -----------

    def acquire_capture(self) -> bool:
        """Claim the one-capture-at-a-time slot (non-blocking)."""
        return self._capture_lock.acquire(blocking=False)

    def release_capture(self) -> None:
        self._capture_lock.release()

    # -- trigger path ------------------------------------------------------

    def maybe_capture(self, trigger: str, *, trace_id: str = "",
                      reason: str = "", model: str = "",
                      sync: bool = False) -> bool:
        """One anomaly happened — capture a profile if the budget allows.

        Returns True when a capture was STARTED (async on a daemon thread
        unless ``sync``). Every refusal is cheap and accounted: disabled,
        another capture in flight (single-flight), inside the cooldown,
        or over the per-hour cap."""
        if not self.enabled:
            return False
        now = self._clock()
        with self._lock:
            if self._last_capture is not None and \
                    now - self._last_capture < self.cooldown_s:
                self._skipped["cooldown"] = \
                    self._skipped.get("cooldown", 0) + 1
                return False
            while self._recent and now - self._recent[0] > 3600.0:
                self._recent.popleft()
            if len(self._recent) >= self.max_per_hour:
                self._skipped["hourly_cap"] = \
                    self._skipped.get("hourly_cap", 0) + 1
                return False
        if not self.acquire_capture():
            with self._lock:
                self._skipped["in_flight"] = \
                    self._skipped.get("in_flight", 0) + 1
            return False
        # budget committed under the state lock BEFORE the capture runs:
        # a burst of triggers during the capture window must land on the
        # cooldown/in-flight refusals, not queue up behind it
        with self._lock:
            self._last_capture = now
            self._recent.append(now)
            self._seq += 1
            seq = self._seq
        entry = {
            "id": f"profile-{seq:04d}-{trigger}",
            "trigger": trigger,
            "trace_id": trace_id,
            "reason": reason,
            "model": model,
            "seconds": self.seconds,
            "started_unix": round(time.time(), 3),
        }
        self._idle.clear()
        if sync:
            self._run_capture(entry)
        else:
            threading.Thread(target=self._run_capture, args=(entry,),
                             daemon=True,
                             name=f"profile-capture-{seq}").start()
        return True

    def _run_capture(self, entry: dict) -> None:
        """Owns the already-acquired capture lock; releases it when the
        bounded window closes, success or not."""
        path = os.path.join(self.out_dir, entry["id"])
        try:
            os.makedirs(path, exist_ok=True)
            self._capture_fn(path, self.seconds)
            entry["path"] = path
            entry["ok"] = True
        except Exception as e:  # noqa: BLE001 — a failed capture is a receipt
            entry["path"] = path
            entry["ok"] = False
            entry["error"] = str(e)
            log.warning("anomaly profile capture failed: %s", e)
        finally:
            self.release_capture()
        with self._lock:
            self._entries.append(entry)
            entries = list(self._entries)
        self.registry.profiles_captured.inc(trigger=entry["trigger"])
        self._write_manifest(entries)
        self._idle.set()
        log.warning("anomaly profile captured: %s (trigger=%s trace=%s)",
                    entry["id"], entry["trigger"], entry["trace_id"])

    def _write_manifest(self, entries: list[dict]) -> None:
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = os.path.join(self.out_dir, ".manifest.tmp")
            with open(tmp, "w") as f:
                json.dump({"profiles": entries}, f, indent=2)
            os.replace(tmp, os.path.join(self.out_dir, "manifest.json"))
        except OSError as e:
            log.warning("could not write profile manifest: %s", e)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no capture is in flight (smoke/tests)."""
        return self._idle.wait(timeout)

    # -- views -------------------------------------------------------------

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def report(self) -> dict:
        """The GET /debug/profiles payload."""
        with self._lock:
            entries = list(self._entries)
            skipped = dict(self._skipped)
            recent = len(self._recent)
        return {
            "enabled": self.enabled,
            "seconds": self.seconds,
            "dir": self.out_dir,
            "max_per_hour": self.max_per_hour,
            "cooldown_s": self.cooldown_s,
            "captures_last_hour": recent,
            "skipped": skipped,
            "profiles": entries,
        }

    # -- step-time regression detector -------------------------------------

    def watch_flight(self, name: str, recorder: Any) -> None:
        """Watch a scheduler's flight ring for step-time p99 regressions
        (weakly — a shut-down engine's ring is dropped on the next
        sweep)."""
        with self._lock:
            self._flights[name] = weakref.ref(recorder)

    def unwatch_flight(self, name: str) -> None:
        with self._lock:
            self._flights.pop(name, None)
            self._reg_counts.pop(name, None)

    def check_regressions(self, *, recent_n: int = 32,
                          min_trailing: int = 32) -> list[str]:
        """One detection pass (the poll thread's unit; tests call it
        directly). Splits each watched ring's resident per-step samples
        into the newest ``recent_n`` vs everything before them, and fires
        when the recent p99 exceeds ``regression_ratio`` × the trailing
        p99 — "decode is suddenly N× slower than ITS OWN recent history",
        no absolute threshold to tune per model. Returns the model names
        that triggered."""
        with self._lock:
            flights = list(self._flights.items())
        fired = []
        for name, ref in flights:
            rec = ref()
            if rec is None:
                self.unwatch_flight(name)
                continue
            count = rec.count
            with self._lock:
                # don't re-judge the same records after a trigger: wait
                # for a full fresh recent window first
                if count - self._reg_counts.get(name, 0) < recent_n:
                    continue
            rows = rec.snapshot()
            steps = [r["step_ms"] for r in rows
                     if r["step_ms"] is not None and not r["compile"]]
            if len(steps) < recent_n + min_trailing:
                continue
            recent = np.asarray(steps[-recent_n:])
            trailing = np.asarray(steps[:-recent_n])
            t99 = float(np.percentile(trailing, 99))
            r99 = float(np.percentile(recent, 99))
            if t99 > 0 and r99 >= self.regression_ratio * t99:
                with self._lock:
                    self._reg_counts[name] = count
                if self.maybe_capture(
                        "step_p99_regression", model=name,
                        reason=(f"step p99 {r99:.2f}ms vs trailing "
                                f"{t99:.2f}ms over {len(trailing)} "
                                f"dispatches")):
                    fired.append(name)
        return fired

    # -- wiring ------------------------------------------------------------

    def install(self, *, watchdog: Any = None, slo: Any = None) -> None:
        """Hook the three triggers (idempotent): watchdog stall trips,
        SLO shed onsets, and the flight-ring regression poll thread."""
        with self._lock:
            if self._installed:
                return
            self._installed = True
        wd = watchdog
        if wd is None:
            from localai_tpu_torch.obs.watchdog import WATCHDOG

            wd = WATCHDOG
        wd.on_stall(self._on_stall)
        tracker = slo
        if tracker is None:
            from localai_tpu_torch.obs.slo import SLO

            tracker = SLO
        tracker.on_shed(self._on_shed)
        with self._lock:
            self._hooked_watchdog = wd
            self._hooked_slo = tracker
        self._stop.clear()
        t = threading.Thread(
            target=self._poll, name="profile-regression-poll", daemon=True)
        with self._lock:
            self._poll_thread = t
        t.start()

    def _on_stall(self, event: Any) -> None:
        if getattr(event, "kind", "") != "stall":
            return
        self.maybe_capture(
            "stall", trace_id=getattr(event, "trace_id", ""),
            reason=(f"watchdog channel {event.channel!r} made no progress "
                    f"for {event.age_seconds}s"))

    def _on_shed(self, model: str) -> None:
        self.maybe_capture(
            "slo_shed", model=model,
            reason=f"model {model!r} entered SLO burn-rate shedding")

    def _poll(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_regressions()
            except Exception:  # noqa: BLE001 — the poll outlives bugs
                pass

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._poll_thread = self._poll_thread, None
            wd, self._hooked_watchdog = self._hooked_watchdog, None
            slo, self._hooked_slo = self._hooked_slo, None
            self._installed = False
        # deregister the trigger hooks OUTSIDE the lock (they take their
        # own): a later install() must register exactly once, not stack
        # a second capture per stall on top of the first
        if wd is not None:
            wd.remove_callback(self._on_stall)
        if slo is not None:
            remove = getattr(slo, "remove_shed_callback", None)
            if remove is not None:
                remove(self._on_shed)
        if t is not None:
            t.join(timeout=5)


# the process-wide manager (like WATCHDOG/SLO); armed only when
# LOCALAI_PROFILE_ON_ANOMALY=1 wires install_from_env at server boot
PROFILER = ProfileManager()


def install_from_env(base_dir: str = "") -> bool:
    """Server-boot wiring: arm the process-wide manager when
    ``LOCALAI_PROFILE_ON_ANOMALY=1``. ``base_dir`` roots the default
    manifest dir (backend assets) unless ``LOCALAI_PROFILE_DIR`` chose
    an explicit location."""
    if not PROFILER.enabled:
        return False
    if base_dir and "LOCALAI_PROFILE_DIR" not in os.environ:
        PROFILER.configure(out_dir=os.path.join(base_dir, "profiles"))
    PROFILER.install()
    return True
