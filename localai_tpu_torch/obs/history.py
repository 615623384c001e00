"""Multi-resolution metrics history (obs subsystem).

A copy of ``localai_tpu/obs/history.py`` (rings, downsampling, the
atomic snapshot writer and the boot restore kept).

Every other signal in the stack is instantaneous: the flight ring holds
the last N dispatches, SLO windows a few minutes, /metrics the current
scrape. This module gives the key gauges/counters and the per-tenant
usage series a PERSISTENT past: each recorded point lands in three
downsampled rings at once —

====  ==========  ========  ==================================
res   capacity    span      downsample
====  ==========  ========  ==================================
1 s   600 pts     10 min    raw
10 s  720 pts     2 h       gauge: mean · counter: max
5 m   576 pts     2 d       gauge: mean · counter: max
====  ==========  ========  ==================================

Counter series carry cumulative monotone totals, so the bucket value is
the MAX total seen in the bucket (rate = successive differences);
gauge buckets keep (sum, count) and report the mean. Bucket timestamps
align to ``int(ts // res) * res`` — a point and its coarser buckets
always nest.

Persistence: when ``LOCALAI_HISTORY_DIR`` is set, a daemon writer
thread snapshots the whole store every ``LOCALAI_HISTORY_SNAPSHOT_S``
(default 30 s) seconds — JSON to a tmp file + ``os.replace`` so a crash
mid-write can never leave a torn snapshot — and boot re-onboards the
last snapshot, so the series survive a restart. All file I/O happens
on the writer thread (or a flush), never under the store lock.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Optional

log = logging.getLogger(__name__)

RESOLUTIONS = (1, 10, 300)
CAPACITY = {1: 600, 10: 720, 300: 576}
SNAPSHOT_FILE = "history.json"


class History:
    """The in-process multi-resolution series store. Mutators take one
    short lock around list/deque arithmetic; snapshots copy under the
    lock and serialize outside it (FlightRecorder discipline)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name → {"kind": str, "rings": {res: deque[[ts, sum, n, max]]}}
        self._series: dict[str, dict] = {}
        self._dirty = False
        self._dir: Optional[str] = None
        self._writer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.snapshot_s = 30.0
        self.snapshots_written = 0

    # -- write side -------------------------------------------------------

    def record(self, name: str, value: float, *, kind: str = "gauge",
               ts: Optional[float] = None) -> None:
        """One point into all three rings. ``ts`` defaults to now (wall
        clock — history outlives the process, so monotonic won't do);
        explicit timestamps place a point at its recorded time."""
        if ts is None:
            ts = time.time()
        value = float(value)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = {
                    "kind": kind,
                    "rings": {res: deque(maxlen=CAPACITY[res])
                              for res in RESOLUTIONS},
                }
            for res, ring in s["rings"].items():
                bucket = int(ts // res) * res
                if ring and ring[-1][0] == bucket:
                    cell = ring[-1]
                    cell[1] += value
                    cell[2] += 1
                    cell[3] = max(cell[3], value)
                elif ring and ring[-1][0] > bucket:
                    # out-of-order point: merge into its bucket if still
                    # resident, else drop (retention already passed it)
                    for cell in reversed(ring):
                        if cell[0] == bucket:
                            cell[1] += value
                            cell[2] += 1
                            cell[3] = max(cell[3], value)
                            break
                        if cell[0] < bucket:
                            break
                else:
                    ring.append([bucket, value, 1, value])
            self._dirty = True

    # -- read side --------------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, *, res: int = 10,
              since: float = 0.0) -> Optional[dict]:
        """Points for one series at one resolution, oldest first.
        Counter buckets report the max cumulative total in the bucket;
        gauge buckets the mean. None for an unknown series."""
        if res not in CAPACITY:
            res = min(CAPACITY, key=lambda r: abs(r - res))
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            kind = s["kind"]
            cells = [list(c) for c in s["rings"][res] if c[0] >= since]
        points = [
            {"ts": c[0],
             "value": c[3] if kind == "counter" else c[1] / max(1, c[2]),
             "count": c[2]}
            for c in cells
        ]
        return {"series": name, "kind": kind, "resolution_s": res,
                "capacity": CAPACITY[res], "points": points}

    # -- convenience feeds (scrape-time, host-side) -----------------------

    def observe_engine(self, model: str, m: dict) -> None:
        """The curated per-model engine series worth a past: called from
        the /metrics build with each scheduler's metrics dict. A dict that
        misses keys records nothing for them."""
        if "error" in m and len(m) == 1:
            return
        gauges = (("occupancy", "occupancy"),
                  ("queue_depth", "queue_depth"),
                  ("kv_utilization", "kv_utilization"),
                  # dispatch anatomy (obs.anatomy): None until the ring's
                  # window holds a non-compile dispatch — skip, don't zero
                  ("host_overhead_fraction", "host_overhead_fraction"),
                  ("device_bubble_fraction", "device_bubble_fraction"))
        for key, series in gauges:
            if m.get(key) is not None:
                self.record(f"{series}.{model}", m[key])
        counters = (("total_generated_tokens", "tokens_generated"),
                    ("total_prompt_tokens", "tokens_prompt"),
                    ("preemptions", "preemptions"),
                    ("shed_total", "requests_shed"))
        for key, series in counters:
            if key in m:
                self.record(f"{series}.{model}", m[key], kind="counter")

    def observe_ledger(self, ledger: Any) -> None:
        """Per-tenant and goodput/waste history from the process ledger
        (cumulative counters; the UI plots their differences)."""
        snap = ledger.snapshot()
        for tenant, panes in snap["tenants"].items():
            delivered = sum(p["delivered_tokens"] for p in panes.values())
            requests = sum(p["requests"] for p in panes.values())
            self.record(f"tenant_tokens.{tenant}", delivered,
                        kind="counter")
            self.record(f"tenant_requests.{tenant}", requests,
                        kind="counter")
        for model, tokens in snap["goodput_tokens"].items():
            self.record(f"goodput_tokens.{model}", tokens, kind="counter")
        waste_by_reason: dict[str, int] = {}
        for key, cell in snap["waste"].items():
            reason = key.partition("/")[0]
            waste_by_reason[reason] = (waste_by_reason.get(reason, 0)
                                       + cell["tokens"])
        for reason, tokens in waste_by_reason.items():
            self.record(f"waste_tokens.{reason}", tokens, kind="counter")

    # -- persistence ------------------------------------------------------

    def snapshot_dict(self) -> dict:
        with self._lock:
            series = {
                name: {"kind": s["kind"],
                       "rings": {str(res): [list(c) for c in ring]
                                 for res, ring in s["rings"].items()}}
                for name, s in self._series.items()
            }
        return {"version": 1, "saved_at": time.time(), "series": series}

    def save(self, directory: Optional[str] = None) -> Optional[str]:
        """Atomic snapshot: serialize outside the lock, write to a tmp
        sibling, ``os.replace`` into place. Returns the path (None when
        no directory is configured)."""
        directory = directory or self._dir
        if not directory:
            return None
        doc = self.snapshot_dict()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, SNAPSHOT_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        self.snapshots_written += 1
        return path

    def load(self, directory: Optional[str] = None) -> bool:
        """Re-onboard the last snapshot (boot restore). Missing/corrupt
        files are a warning, never a crash — history is observability,
        not serving state."""
        directory = directory or self._dir
        if not directory:
            return False
        path = os.path.join(directory, SNAPSHOT_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return False
        except (OSError, ValueError) as e:
            log.warning("history snapshot %s unreadable: %s", path, e)
            return False
        series: dict[str, dict] = {}
        for name, s in (doc.get("series") or {}).items():
            rings = {}
            for res in RESOLUTIONS:
                cells = (s.get("rings") or {}).get(str(res)) or []
                rings[res] = deque(
                    ([float(c[0]), float(c[1]), int(c[2]), float(c[3])]
                     for c in cells if len(c) == 4),
                    maxlen=CAPACITY[res])
            series[name] = {"kind": s.get("kind", "gauge"), "rings": rings}
        with self._lock:
            self._series = series
            self._dirty = False
        return True

    def configure(self, directory: Optional[str],
                  snapshot_s: float = 30.0) -> None:
        """Attach a snapshot directory: restore what's there, then start
        the periodic writer thread (idempotent)."""
        self._dir = directory
        self.snapshot_s = max(1.0, snapshot_s)
        if not directory:
            return
        self.load(directory)
        if self._writer is None or not self._writer.is_alive():
            self._stop.clear()
            self._writer = threading.Thread(
                target=self._writer_loop, name="history-writer", daemon=True
            )
            self._writer.start()

    def _writer_loop(self) -> None:
        """Writer thread: flush a snapshot every interval while dirty.
        All disk I/O lives here — record() never blocks on a write."""
        while not self._stop.wait(self.snapshot_s):
            with self._lock:
                dirty, self._dirty = self._dirty, False
            if not dirty:
                continue
            try:
                self.save()
            except OSError as e:
                log.warning("history snapshot write failed: %s", e)

    def flush(self) -> Optional[str]:
        """Synchronous snapshot (shutdown/test hook)."""
        with self._lock:
            self._dirty = False
        try:
            return self.save()
        except OSError as e:
            log.warning("history flush failed: %s", e)
            return None

    def stop(self) -> None:
        self._stop.set()

    def reset(self) -> None:
        """Test hook: drop all series (the singleton is process-global)."""
        with self._lock:
            self._series.clear()
            self._dirty = False


def install_from_env(history: Optional[History] = None) -> bool:
    """Boot hook (the API server): LOCALAI_HISTORY_DIR turns persistence on;
    LOCALAI_HISTORY_SNAPSHOT_S tunes the writer cadence."""
    h = history or HISTORY
    directory = os.environ.get("LOCALAI_HISTORY_DIR", "")
    if not directory:
        return False
    try:
        snapshot_s = float(os.environ.get("LOCALAI_HISTORY_SNAPSHOT_S", 30))
    except ValueError:
        snapshot_s = 30.0
    h.configure(directory, snapshot_s=snapshot_s)
    return True


HISTORY = History()
