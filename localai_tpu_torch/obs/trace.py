"""Lock-protected span recorder with a bounded ring-buffer trace store (a
copy of ``localai_tpu/obs/trace.py``, the names kept).

Design constraints (they shape everything here):

  * **Zero device syncs.** Every timestamp is ``time.monotonic()`` taken on
    the host; no code path ever touches a device tensor, so recording a
    span from the engine thread costs a list append under a lock — it
    cannot stall a dispatch or force a device→host copy.
  * **Bounded memory.** Finished traces land in a ``deque(maxlen=...)``
    ring; a trace that never finishes (a leaked handle) is still visible
    via the active table until it does.
  * **Monotonic for math, wall clock for display.** Durations are computed
    from the monotonic timeline; ``start_unix`` in the JSON view is derived
    through one wall/monotonic anchor pair captured at import.

The unit is a :class:`RequestTrace` — one trace id, one request id, a flat
list of phase spans rendered as a single-root span tree (request phases are
sequential, so the tree is root + children). The HTTP middleware records
one-span ``kind="http"`` traces into the same store, so
``/debug/timeline/{id}`` can merge the API view and the engine view of the
same trace id.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

# one anchor pair: monotonic drives all math, this converts for display
_WALL0 = time.time()
_MONO0 = time.monotonic()


def mono_to_wall(t: float) -> float:
    return _WALL0 + (t - _MONO0)


def new_trace_id() -> str:
    return "trace-" + uuid.uuid4().hex[:24]


class Span:
    """One named phase: [t0, t1] on the monotonic clock + attributes.
    ``t1 is None`` means still open; ``t1 == t0`` is a point event."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "start_unix": round(mono_to_wall(self.t0), 6),
        }
        d["duration_ms"] = (None if self.t1 is None
                            else round((self.t1 - self.t0) * 1e3, 3))
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class RequestTrace:
    """Span recorder for one request. Append-only and lock-protected: the
    submitting thread, the engine thread, and an SSE writer may all touch
    the same trace."""

    def __init__(self, trace_id: str, request_id: str, *, kind: str = "request",
                 model: str = "", **attrs: Any):
        self.trace_id = trace_id
        self.request_id = request_id
        self.kind = kind
        self.model = model
        self.attrs: dict[str, Any] = dict(attrs)
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.finished = False
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._open: dict[str, Span] = {}

    # -- recording -------------------------------------------------------

    def begin(self, name: str, **attrs: Any) -> Span:
        span = Span(name, time.monotonic(), attrs=attrs)
        with self._lock:
            self._spans.append(span)
            self._open[name] = span
        return span

    def end(self, name: str, **attrs: Any) -> Optional[Span]:
        """Close the open span ``name`` (no-op when it was never begun —
        lifecycle paths diverge: a cancelled-in-queue request has no
        prefill/decode spans to close)."""
        now = time.monotonic()
        with self._lock:
            span = self._open.pop(name, None)
            if span is None:
                return None
            span.t1 = now
            span.attrs.update(attrs)
        return span

    def event(self, name: str, **attrs: Any) -> Span:
        """Point-in-time marker (t1 == t0)."""
        now = time.monotonic()
        span = Span(name, now, now, attrs=attrs)
        with self._lock:
            self._spans.append(span)
        return span

    def annotate(self, **attrs: Any) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def close_open(self) -> None:
        """Close every still-open span (finish on an abnormal path)."""
        now = time.monotonic()
        with self._lock:
            for span in self._open.values():
                span.t1 = now
            self._open.clear()

    # -- views -----------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def to_dict(self) -> dict:
        """The span tree: one root (the request) + phase children."""
        with self._lock:
            attrs = dict(self.attrs)
            children = [s.to_dict() for s in self._spans]
        end = self.t1 if self.t1 is not None else (
            time.monotonic() if not self.finished else self.t0
        )
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "kind": self.kind,
            "model": self.model,
            "name": self.kind,
            "start_unix": round(mono_to_wall(self.t0), 6),
            "duration_ms": round((end - self.t0) * 1e3, 3),
            "finished": self.finished,
            "attrs": attrs,
            "children": children,
        }


def default_capacity() -> int:
    """Per-kind finished-trace ring size: ``LOCALAI_TRACE_CAPACITY``,
    default 256. Each trace kind (request/http/stall/batch) gets its own
    ring of this size; sizing up trades host RAM for a longer forensic
    horizon (a busy fleet front door can blow through 256 request traces
    in seconds). Exported as ``localai_trace_ring_size`` so a dashboard
    can tell 'trace evicted' from 'trace never recorded'."""
    try:
        return max(1, int(os.environ.get("LOCALAI_TRACE_CAPACITY", "")
                          or 256))
    except ValueError:
        return 256


class TraceStore:
    """Active table + bounded rings of finished traces, one ring per
    trace kind — high-volume HTTP spans (scrapes, probes) must not evict
    the engine request traces the subsystem exists to retain."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = (capacity if capacity is not None
                         else default_capacity())
        self._lock = threading.Lock()
        self._active: dict[int, RequestTrace] = {}
        self._done: dict[str, deque[RequestTrace]] = {}

    def _ring(self, kind: str) -> "deque[RequestTrace]":
        ring = self._done.get(kind)
        if ring is None:
            ring = self._done[kind] = deque(maxlen=self.capacity)
        return ring

    def start(self, trace: RequestTrace) -> RequestTrace:
        with self._lock:
            self._active[id(trace)] = trace
        return trace

    def finish(self, trace: RequestTrace) -> None:
        trace.close_open()
        trace.t1 = time.monotonic()
        trace.finished = True
        with self._lock:
            self._active.pop(id(trace), None)
            self._ring(trace.kind).append(trace)

    def record(self, trace: RequestTrace) -> None:
        """One-shot insert of an already-complete trace (HTTP spans)."""
        if trace.t1 is None:
            trace.t1 = time.monotonic()
        trace.finished = True
        with self._lock:
            self._ring(trace.kind).append(trace)

    def recent(self, limit: int = 50,
               kind: Optional[str] = None) -> list[RequestTrace]:
        """Newest-first: in-flight traces, then finished ones."""
        with self._lock:
            active = sorted(self._active.values(), key=lambda t: -t.t0)
            done = [t for ring in self._done.values() for t in ring]
        done.sort(key=lambda t: -t.t0)
        out = [t for t in active + done if kind is None or t.kind == kind]
        return out[:limit]

    def find(self, ident: str) -> list[RequestTrace]:
        """Every trace whose trace id OR request id matches, oldest first
        (the /debug/timeline lookup — one trace id may cover the HTTP span
        plus several engine requests for n>1 fan-out)."""
        with self._lock:
            pool = list(self._active.values()) + [
                t for ring in self._done.values() for t in ring
            ]
        hits = [t for t in pool
                if t.trace_id == ident or t.request_id == ident]
        hits.sort(key=lambda t: t.t0)
        return hits


STORE = TraceStore()
