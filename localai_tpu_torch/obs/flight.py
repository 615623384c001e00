"""Engine flight recorder: a fixed-size ring of per-dispatch records.

A copy of ``localai_tpu/obs/flight.py`` (host-only; the names, the record
fields and the snapshot / percentile / phase math kept). The scheduler
writes one record at every drain point: the pipelined drain, the
constrained lane's synchronous dispatch, every speculative window (its
measured yield as ``steps``, with its proposed / accepted draft counts)
and every chunk of a chunked paged admission (``prefill_chunk``, 0 steps).

  * **Zero device syncs.** Every field is a host mirror the scheduler
    already holds (slot dict sizes, queue depth, token counters,
    monotonic clocks). Nothing here touches a tensor.
  * **Lock-light, allocation-light.** The ring is column-major over
    preallocated numpy arrays; :meth:`record` writes one row in place
    under a short lock.
  * **Windowed percentiles from the ring.** Per-token step time
    (``dispatch_ms / steps``) percentiles are computed on demand from the
    resident rows, excluding a shape's first dispatch (``compile=True``:
    on the card it also pays the kernel extension's first-use load), so
    the numbers answer "what is decode doing now".

One instance per Scheduler (``Scheduler.flight``), sized by
``LOCALAI_FLIGHT_CAPACITY`` (default 512). Surfaced at ``GET
/debug/flight`` and attached to every stall trace through the watchdog's
context providers.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from localai_tpu_torch.obs.trace import mono_to_wall


def _default_capacity() -> int:
    try:
        return max(1, int(os.environ.get("LOCALAI_FLIGHT_CAPACITY", "512")))
    except ValueError:
        return 512


class FlightRecorder:
    """Column-major ring of per-dispatch engine records."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = int(capacity) if capacity else _default_capacity()
        n = self.capacity
        self._lock = threading.Lock()
        self._ts = np.zeros(n)
        self._steps = np.zeros(n, np.int64)
        self._dispatch_ms = np.zeros(n)
        self._occupancy = np.zeros(n)
        self._batch_slots = np.zeros(n, np.int64)
        self._queue_depth = np.zeros(n, np.int64)
        self._kv_utilization = np.zeros(n)
        self._tokens = np.zeros(n, np.int64)
        self._preemptions = np.zeros(n, np.int64)
        self._spec_accept = np.full(n, np.nan)
        self._spec_proposed = np.zeros(n, np.int64)
        self._spec_accepted = np.zeros(n, np.int64)
        self._gap_ms = np.zeros(n)
        self._sched_ms = np.zeros(n)
        self._launch_ms = np.zeros(n)
        self._sync_ms = np.zeros(n)
        self._compile = np.zeros(n, bool)
        self._program: list[str] = [""] * n
        self._n = 0                # records ever written (ring head = n % cap)
        self.total_tokens = 0      # cumulative, survives wraparound

    # -- hot path (engine thread) -----------------------------------------

    def record(self, *, program: str, steps: int, dispatch_ms: float,
               occupancy: float, queue_depth: int, kv_utilization: float,
               tokens: int, preemptions: int = 0,
               spec_accept: Optional[float] = None,
               spec_proposed: int = 0, spec_accepted: int = 0,
               compile: bool = False, ts: Optional[float] = None,
               batch_slots: int = 0, gap_ms: float = 0.0,
               sched_ms: float = 0.0, launch_ms: float = 0.0,
               sync_ms: float = 0.0) -> None:
        """Append one dispatch record (host scalars only).

        ``batch_slots`` tags the record with the lane mix: how many of the
        occupied slots were background batch-lane requests at drain time
        (0 = pure interactive dispatch). ``spec_proposed``/
        ``spec_accepted`` are THIS dispatch's draft-token counts (0 for
        non-speculative dispatches) — the per-window accept trace the
        cumulative ``spec_accept`` ratio can't show.

        ``gap_ms``/``sched_ms``/``launch_ms``/``sync_ms`` decompose the
        wall interval ``dispatch_ms`` accounts for (see
        :mod:`obs.anatomy` for phase semantics). The scheduler guarantees
        their sum never exceeds ``dispatch_ms``; callers that cannot
        attribute phases pass the zero defaults and the record degrades
        to the undifferentiated pre-anatomy shape."""
        now = time.monotonic() if ts is None else ts
        with self._lock:
            i = self._n % self.capacity
            self._ts[i] = now
            self._steps[i] = steps
            self._dispatch_ms[i] = dispatch_ms
            self._occupancy[i] = occupancy
            self._batch_slots[i] = batch_slots
            self._queue_depth[i] = queue_depth
            self._kv_utilization[i] = kv_utilization
            self._tokens[i] = tokens
            self._preemptions[i] = preemptions
            self._spec_accept[i] = (np.nan if spec_accept is None
                                    else spec_accept)
            self._spec_proposed[i] = spec_proposed
            self._spec_accepted[i] = spec_accepted
            self._gap_ms[i] = gap_ms
            self._sched_ms[i] = sched_ms
            self._launch_ms[i] = launch_ms
            self._sync_ms[i] = sync_ms
            self._compile[i] = compile
            self._program[i] = program
            self._n += 1
            self.total_tokens += int(tokens)

    # -- read side ---------------------------------------------------------

    @property
    def count(self) -> int:
        """Records ever written (resident rows = min(count, capacity))."""
        # a monotone int read without the lock: readers tolerate being one
        # record behind the engine thread
        return self._n

    def _order(self) -> np.ndarray:
        """Resident row indices, oldest → newest (caller holds the lock)."""
        if self._n <= self.capacity:
            return np.arange(self._n)
        head = self._n % self.capacity
        return np.concatenate([np.arange(head, self.capacity),
                               np.arange(head)])

    def snapshot(self, since: float = 0.0,
                 limit: Optional[int] = None) -> list[dict]:
        """Resident records oldest → newest as JSON-able dicts.

        ``since`` filters on the record's monotonic timestamp (pollers pass
        the ``ts`` of the last record they saw); ``limit`` keeps the newest
        N after filtering.
        """
        # copy the selected rows under the lock, format after releasing
        # it: building (up to capacity) dicts must not block the engine
        # thread's per-dispatch record() behind a scrape
        with self._lock:
            order = self._order()
            if since:
                order = order[self._ts[order] > since]
            if limit is not None and len(order) > limit:
                order = order[-limit:]
            cols = {
                "ts": self._ts[order].tolist(),
                "steps": self._steps[order].tolist(),
                "ms": self._dispatch_ms[order].tolist(),
                "occ": self._occupancy[order].tolist(),
                "batch": self._batch_slots[order].tolist(),
                "queue": self._queue_depth[order].tolist(),
                "kv": self._kv_utilization[order].tolist(),
                "tokens": self._tokens[order].tolist(),
                "preempt": self._preemptions[order].tolist(),
                "acc": self._spec_accept[order].tolist(),
                "proposed": self._spec_proposed[order].tolist(),
                "accepted": self._spec_accepted[order].tolist(),
                "gap": self._gap_ms[order].tolist(),
                "sched": self._sched_ms[order].tolist(),
                "launch": self._launch_ms[order].tolist(),
                "sync": self._sync_ms[order].tolist(),
                "compile": self._compile[order].tolist(),
                "program": [self._program[i] for i in order],
            }
        out = []
        for j in range(len(cols["ts"])):
            steps = cols["steps"][j]
            ms = cols["ms"][j]
            acc = cols["acc"][j]
            out.append({
                # ts stays unrounded: pollers feed it back as ?since=
                # and a rounded-up value would exclude its own record
                "ts": cols["ts"][j],
                "ts_unix": round(mono_to_wall(cols["ts"][j]), 6),
                "program": cols["program"][j],
                "steps": steps,
                "dispatch_ms": round(ms, 3),
                "step_ms": (round(ms / steps, 4) if steps > 0 else None),
                "occupancy": round(cols["occ"][j], 4),
                "batch_slots": cols["batch"][j],
                "queue_depth": cols["queue"][j],
                "kv_utilization": round(cols["kv"][j], 4),
                "tokens": cols["tokens"][j],
                "preemptions": cols["preempt"][j],
                "spec_accept": (None if np.isnan(acc) else round(acc, 4)),
                "spec_proposed": cols["proposed"][j],
                "spec_accepted": cols["accepted"][j],
                "gap_ms": round(cols["gap"][j], 3),
                "sched_ms": round(cols["sched"][j], 3),
                "launch_ms": round(cols["launch"][j], 3),
                "sync_ms": round(cols["sync"][j], 3),
                "compile": cols["compile"][j],
            })
        return out

    def percentiles(self, window_s: Optional[float] = None,
                    now: Optional[float] = None) -> dict:
        """Per-token step-time percentiles over the ring.

        The default window is the RING — the last ``capacity`` dispatches,
        however old (an idle engine keeps reporting its most recent
        activity rather than going blank); pass ``window_s`` to restrict
        to recent wall time. Compile-bearing first dispatches and
        speculative windows are excluded (see module docstring). Returns
        ``step_ms_p50/p90/p99`` (None when no eligible sample) plus the
        sample count.
        """
        with self._lock:
            order = self._order()
            mask = (self._steps[order] > 0) & ~self._compile[order]
            if window_s is not None:
                cutoff = (time.monotonic() if now is None else now) - window_s
                mask &= self._ts[order] >= cutoff
            rows = order[mask]
            per_step = (self._dispatch_ms[rows]
                        / np.maximum(self._steps[rows], 1))
        if len(per_step) == 0:
            return {"step_ms_p50": None, "step_ms_p90": None,
                    "step_ms_p99": None, "samples": 0}
        p50, p90, p99 = np.percentile(per_step, (50, 90, 99))
        return {
            "step_ms_p50": round(float(p50), 4),
            "step_ms_p90": round(float(p90), 4),
            "step_ms_p99": round(float(p99), 4),
            "samples": int(len(per_step)),
        }

    def phases(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> dict:
        """Per-phase dispatch-anatomy percentiles + windowed fractions.

        Same window semantics as :meth:`percentiles` (ring by default,
        ``window_s`` to restrict; compile-bearing rows excluded — a shape's
        first dispatch would drown every phase). For each
        phase in gap/sched/launch/sync: ``{phase}_ms_p50/p90/p99`` and
        ``{phase}_ms_total`` over the window, plus ``dispatch_ms_total``,
        ``host_ms_total`` (gap+sched+launch) and the two derived gauges:

        * ``host_overhead_fraction`` = host_ms_total / dispatch_ms_total —
          the share of accounted wall time the host spent NOT blocked on
          the device.
        * ``device_bubble_fraction`` — estimator of device idle share:
          per record ``max(0, (gap+sched+launch) - sync_ms)`` summed over
          the window, / dispatch_ms_total. A record whose host phases
          were fully covered by a later sync wait means the device queue
          hid the host time (no bubble); host time the device did NOT
          make the host wait for is (estimated) device idleness. An
          estimator, not a measurement — see :mod:`obs.anatomy`.
        """
        with self._lock:
            order = self._order()
            mask = ~self._compile[order]
            if window_s is not None:
                cutoff = (time.monotonic() if now is None else now) - window_s
                mask &= self._ts[order] >= cutoff
            rows = order[mask]
            ph_cols = {
                "gap": self._gap_ms[rows].copy(),
                "sched": self._sched_ms[rows].copy(),
                "launch": self._launch_ms[rows].copy(),
                "sync": self._sync_ms[rows].copy(),
            }
            dispatch = self._dispatch_ms[rows].copy()
        out: dict = {"samples": int(len(dispatch))}
        if len(dispatch) == 0:
            for ph in (*ph_cols, "host"):
                out[f"{ph}_ms_p50"] = None
                out[f"{ph}_ms_p90"] = None
                out[f"{ph}_ms_p99"] = None
            for ph in ph_cols:
                out[f"{ph}_ms_total"] = 0.0
            out["dispatch_ms_total"] = 0.0
            out["host_ms_total"] = 0.0
            out["host_overhead_fraction"] = None
            out["device_bubble_fraction"] = None
            return out
        for ph, arr in ph_cols.items():
            p50, p90, p99 = np.percentile(arr, (50, 90, 99))
            out[f"{ph}_ms_p50"] = round(float(p50), 4)
            out[f"{ph}_ms_p90"] = round(float(p90), 4)
            out[f"{ph}_ms_p99"] = round(float(p99), 4)
            out[f"{ph}_ms_total"] = round(float(arr.sum()), 3)
        host = ph_cols["gap"] + ph_cols["sched"] + ph_cols["launch"]
        # host percentiles are computed on the per-record SUM, not a sum
        # of per-phase percentiles (those don't compose)
        p50, p90, p99 = np.percentile(host, (50, 90, 99))
        out["host_ms_p50"] = round(float(p50), 4)
        out["host_ms_p90"] = round(float(p90), 4)
        out["host_ms_p99"] = round(float(p99), 4)
        bubble = np.maximum(0.0, host - ph_cols["sync"])
        total = float(dispatch.sum())
        out["dispatch_ms_total"] = round(total, 3)
        out["host_ms_total"] = round(float(host.sum()), 3)
        if total > 0:
            out["host_overhead_fraction"] = round(float(host.sum()) / total, 4)
            out["device_bubble_fraction"] = round(
                float(bubble.sum()) / total, 4)
        else:
            out["host_overhead_fraction"] = None
            out["device_bubble_fraction"] = None
        return out
