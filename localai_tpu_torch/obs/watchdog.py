"""Dispatch-heartbeat stall watchdog: the "is anything moving?" half of obs.

A copy of ``localai_tpu/obs/watchdog.py``. The failure mode it exists for:
a device round-trip that blocks forever with no exception (a wedged card,
a kernel that never returns) — the engine thread sits inside
``np.asarray(tokens)``, the API keeps accepting requests, and nothing in
the tracing layer can tell "slow" from "gone". The watchdog turns that
silence into a signal:

  * call sites wrap each blocking device round-trip in
    :meth:`Watchdog.guard` (or ``arm``/``pulse``/``disarm`` for streaming
    loops). A guarded round-trip costs two monotonic reads and a dict
    update under a lock — nothing here touches a tensor.
  * a background thread (:meth:`check` is the testable unit) looks for
    channels that are ARMED (an operation in flight) with no progress past
    ``deadline`` (``LOCALAI_STALL_DEADLINE_S``, default 60). On a trip it
    sets the ``localai_engine_stalled`` gauge, records
    ``localai_last_progress_age_seconds``, counts ``localai_stalls_total``,
    dumps EVERY thread's stack (``sys._current_frames``) into the trace
    store as a forensic ``kind="stall"`` trace (``GET
    /v1/traces?kind=stall``), and fires registered callbacks.
  * the next pulse/disarm on a stalled channel clears the gauge and fires
    a ``recovered`` event — a stall is "no observable progress", not proof
    of death: a kernel build on first use can trip it and then recover.

Channels are independent countdowns: the runner's blocking syncs share
``"device"``, each scheduler guards its drain under ``"engine:<model>"``.

``WATCHDOG`` is the process-wide instance (like ``REGISTRY``/``STORE``);
its thread starts lazily when the first Scheduler comes up.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import traceback
import uuid
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

from localai_tpu_torch.obs.metrics import REGISTRY, Registry
from localai_tpu_torch.obs.trace import STORE, RequestTrace, TraceStore


def _default_deadline() -> float:
    try:
        return float(os.environ.get("LOCALAI_STALL_DEADLINE_S", "60"))
    except ValueError:
        return 60.0


@dataclasses.dataclass
class StallEvent:
    """What a callback receives: one trip or one recovery."""

    channel: str
    kind: str                 # "stall" | "recovered"
    age_seconds: float
    trace_id: str = ""        # the forensic stack-dump trace ("" on recovery)


class _Channel:
    __slots__ = ("armed", "last_progress", "stalled", "stalled_at")

    def __init__(self, now: float):
        self.armed = 0
        self.last_progress = now
        self.stalled = False
        self.stalled_at = 0.0


def dump_stacks() -> list[dict]:
    """Every live thread's stack as [{thread, daemon, stack}] — the
    forensic payload (host-only: ``sys._current_frames`` touches no
    device)."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "thread": t.name if t else str(ident),
            "daemon": bool(t.daemon) if t else False,
            "stack": "".join(traceback.format_stack(frame)),
        })
    return out


class Watchdog:
    """Per-channel no-progress detector with forensic stack dumps."""

    def __init__(self, deadline: Optional[float] = None, *,
                 registry: Optional[Registry] = None,
                 store: Optional[TraceStore] = None,
                 poll_interval: Optional[float] = None):
        self.deadline = deadline if deadline is not None else _default_deadline()
        self.registry = registry or REGISTRY
        self.store = store or STORE
        self.poll_interval = poll_interval or max(0.25, self.deadline / 4.0)
        self._lock = threading.Lock()
        # serializes gauge emission: trip and recovery can race (check()
        # marks a channel stalled, then a pulse lands before the trip's
        # gauge write) — every emission re-reads the channel's CURRENT
        # state under this lock, so the last write always tells the truth
        self._gauge_lock = threading.Lock()
        self._channels: dict[str, _Channel] = {}
        self._callbacks: list[Callable[[StallEvent], None]] = []
        # forensic context providers: name -> zero-arg callable returning a
        # JSON-able dict attached to every stall dump (e.g. the scheduler's
        # flight-ring snapshot, so a stall trace carries the engine
        # timeline that preceded the silence)
        self._contexts: dict[str, Callable[[], dict]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- heartbeat API (hot path: two clock reads + one lock) -------------

    def _entry(self, channel: str, now: float) -> _Channel:
        ch = self._channels.get(channel)
        if ch is None:
            ch = self._channels[channel] = _Channel(now)
        return ch

    def pulse(self, channel: str = "engine") -> None:
        """Progress happened on ``channel`` (clears a standing stall)."""
        now = time.monotonic()
        recovered: Optional[StallEvent] = None
        with self._lock:
            ch = self._entry(channel, now)
            if ch.stalled:
                recovered = StallEvent(
                    channel, "recovered", round(now - ch.last_progress, 3)
                )
                ch.stalled = False
            ch.last_progress = now
        if recovered is not None:
            self._emit_clear(channel, recovered)

    def arm(self, channel: str = "engine") -> None:
        """An operation that MUST make progress started on ``channel``.
        The countdown only runs while at least one operation is armed —
        an idle engine can never stall."""
        now = time.monotonic()
        with self._lock:
            ch = self._entry(channel, now)
            if ch.armed == 0:
                ch.last_progress = now  # idle gap is not silence
            ch.armed += 1

    def disarm(self, channel: str = "engine") -> None:
        """The operation finished (counts as progress)."""
        self.pulse(channel)
        with self._lock:
            ch = self._channels.get(channel)
            if ch is not None and ch.armed > 0:
                ch.armed -= 1

    @contextmanager
    def guard(self, channel: str = "engine") -> Iterator[None]:
        """Arm around one blocking device round-trip."""
        self.arm(channel)
        try:
            yield
        finally:
            self.disarm(channel)

    # -- detection --------------------------------------------------------

    def on_stall(self, cb: Callable[[StallEvent], None]) -> None:
        """Register a callback fired on every trip AND recovery (the event's
        ``kind`` distinguishes them). Exceptions are swallowed — forensics
        must never kill the thing they observe."""
        with self._lock:
            self._callbacks.append(cb)

    def remove_callback(self, cb: Callable[[StallEvent], None]) -> None:
        """Unregister a stall callback (supervisors detach at scheduler
        shutdown so a dead engine's closure is not kept alive here)."""
        with self._lock:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    def add_context(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a forensic context provider: ``fn()`` returns a
        JSON-able dict recorded as a ``context`` event (attr ``source`` =
        ``name``) on every stall trace. Providers must be host-only and
        cheap; exceptions are swallowed per provider."""
        with self._lock:
            self._contexts[name] = fn

    def remove_context(self, name: str) -> None:
        """Unregister a provider (schedulers remove theirs at shutdown so
        a dead engine's closure is not kept alive by the watchdog)."""
        with self._lock:
            self._contexts.pop(name, None)

    def reset(self, channel: str) -> None:
        """Forget a channel's state entirely — armed count included.

        The self-healing rebuild path needs this: a truly wedged engine
        thread is parked inside a ``guard`` it will never exit, so its
        arm() has no matching disarm() and the channel would stay armed
        forever — every later idle gap past the deadline would fire a
        spurious stall (and another rebuild) on a healthy engine. The
        abandoned thread's eventual disarm() on the recreated channel is
        a no-op (disarm only decrements a positive count)."""
        with self._lock:
            self._channels.pop(channel, None)
        self._set_stall_gauge(channel)

    def stalled(self, channel: Optional[str] = None) -> bool:
        with self._lock:
            if channel is not None:
                ch = self._channels.get(channel)
                return bool(ch and ch.stalled)
            return any(c.stalled for c in self._channels.values())

    def status(self) -> dict[str, dict]:
        """Snapshot for /debug/devices: per-channel armed/age/stalled."""
        now = time.monotonic()
        with self._lock:
            return {
                name: {
                    "armed": ch.armed,
                    "stalled": ch.stalled,
                    "last_progress_age_seconds": round(
                        now - ch.last_progress, 3),
                }
                for name, ch in self._channels.items()
            }

    def check(self, now: Optional[float] = None) -> list[StallEvent]:
        """One detection pass (what the background thread runs; tests call
        it directly). Returns the trips it fired."""
        now = time.monotonic() if now is None else now
        trips: list[tuple[str, float]] = []
        with self._lock:
            for name, ch in self._channels.items():
                age = now - ch.last_progress
                if ch.armed > 0:
                    self.registry.last_progress_age.set(
                        round(age, 3), channel=name)
                elif not ch.stalled:
                    # idle channel: a stale age from the last armed scrape
                    # (e.g. a long compile that finished just under the
                    # deadline) must not keep flapping alerts
                    self.registry.last_progress_age.set(0.0, channel=name)
                if ch.armed > 0 and not ch.stalled and age > self.deadline:
                    ch.stalled = True
                    ch.stalled_at = now
                    trips.append((name, age))
        events = [self._emit_stall(name, age) for name, age in trips]
        return events

    # -- event plumbing (never under the channel lock) --------------------

    def _set_stall_gauge(self, channel: str) -> None:
        """Write engine_stalled from the channel's CURRENT state (not the
        event that triggered the write): a recovery racing a trip may emit
        in either order, and re-reading under the gauge lock guarantees
        the final write matches reality — no permanently latched 1."""
        with self._gauge_lock:
            with self._lock:
                ch = self._channels.get(channel)
                stalled = bool(ch and ch.stalled)
            self.registry.engine_stalled.set(
                1 if stalled else 0, channel=channel)
            if not stalled:
                self.registry.last_progress_age.set(0.0, channel=channel)

    def _emit_stall(self, channel: str, age: float) -> StallEvent:
        trace_id = f"stall-{uuid.uuid4().hex[:12]}"
        self.registry.last_progress_age.set(round(age, 3), channel=channel)
        self.registry.stalls.inc(channel=channel)
        self._set_stall_gauge(channel)
        try:
            tr = RequestTrace(
                trace_id, f"stall-{channel}", kind="stall",
                channel=channel,
                last_progress_age_seconds=round(age, 3),
                deadline_seconds=self.deadline,
            )
            stacks = dump_stacks()
            for s in stacks:
                tr.event("thread", **s)
            tr.annotate(threads=len(stacks))
            # attach registered forensic contexts (flight snapshots etc.):
            # the stall dump should answer "what was the engine doing for
            # the last N dispatches", not just "where is it parked now"
            with self._lock:
                contexts = list(self._contexts.items())
            for name, fn in contexts:
                try:
                    tr.event("context", source=name, **fn())
                except Exception:  # noqa: BLE001 — one provider ≠ the dump
                    tr.event("context", source=name, error="provider failed")
            self.store.record(tr)
        except Exception:  # noqa: BLE001 — forensics must not throw
            trace_id = ""
        event = StallEvent(channel, "stall", round(age, 3), trace_id)
        self._fire(event)
        return event

    def _emit_clear(self, channel: str, event: StallEvent) -> None:
        self._set_stall_gauge(channel)
        self._fire(event)

    def _fire(self, event: StallEvent) -> None:
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(event)
            except Exception:  # noqa: BLE001
                pass

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Idempotent; the thread is a daemon and shared freely."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="stall-watchdog", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog outlives bugs
                pass

    def stop(self) -> None:
        self._stop.set()
        # claim the thread under the lock so a racing start()/stop() pair
        # can't both join (or leak) the same thread; join OUTSIDE the
        # lock — holding it across a 5 s join would block start()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=5)


# the process-wide watchdog (runner/scheduler/worker default to it);
# its thread starts when the first Scheduler calls start()
WATCHDOG = Watchdog()
