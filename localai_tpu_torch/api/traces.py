"""Tracing endpoints: recent span trees and per-request timelines.

Port of ``localai_tpu/api/traces.py`` over the local trace store
(``obs.trace.STORE``); the fleet's stitched replica halves come with the
fleet (ROADMAP item 23), so ``/v1/traces/{id}`` answers the JAX package's
body with no replica pane.

``GET /v1/traces`` — newest-first span trees (``?limit=N``,
``?kind=request|http``, ``?model=name``).

``GET /v1/traces/{trace_id}`` — every trace of one trace id (or engine
request id) and their spans merged into one time-ordered waterfall.

``GET /debug/timeline/{request_id}`` — the same traces as one flat,
time-ordered timeline with offsets from the earliest span.
"""

from __future__ import annotations

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.obs.trace import STORE, mono_to_wall


def list_traces(manager, query: dict) -> dict:
    try:
        limit = max(1, min(int(query.get("limit", 50)), 500))
    except ValueError:
        raise APIError(400, "limit must be an integer") from None
    kind = query.get("kind") or None
    model = query.get("model") or None
    traces = STORE.recent(limit=limit, kind=kind)
    if model:
        traces = [t for t in traces if t.model == model]
    return {"object": "list", "traces": [t.to_dict() for t in traces]}


def _find(ident: str) -> list:
    hits = STORE.find(ident)
    if not hits:
        raise APIError(
            404, f"no trace recorded for {ident!r} (traces are kept in a "
                 f"bounded ring; see /v1/traces for what is retained)")
    return hits


def trace_detail(manager, query: dict, trace_id: str) -> dict:
    """The JAX package's stitched body for a trace that crossed no
    replica: the local traces and their spans as one waterfall."""
    local = [t.to_dict() for t in _find(trace_id)]
    origin = min((float(t["start_unix"]) for t in local), default=0.0)
    events = [{
        "replica": "",
        "source": tr.get("request_id", ""),
        "kind": tr.get("kind", ""),
        "name": span.get("name", ""),
        "offset_ms": round(
            (float(span.get("start_unix") or origin) - origin) * 1e3, 3),
        "duration_ms": span.get("duration_ms"),
        "attrs": span.get("attrs") or {},
    } for tr in local for span in tr.get("children", ())]
    events.sort(key=lambda e: e["offset_ms"])
    return {"trace_id": trace_id, "start_unix": round(origin, 6),
            "traces": local, "replicas": {}, "waterfall": events}


def timeline(manager, query: dict, request_id: str) -> dict:
    hits = _find(request_id)
    origin = min(t.t0 for t in hits)
    events = []
    for t in hits:
        for s in t.spans():
            events.append({
                "source": t.request_id,
                "kind": t.kind,
                "name": s.name,
                "offset_ms": round((s.t0 - origin) * 1e3, 3),
                "duration_ms": (None if s.t1 is None
                                else round((s.t1 - s.t0) * 1e3, 3)),
                "attrs": dict(s.attrs),
            })
    events.sort(key=lambda e: e["offset_ms"])
    return {
        "request_id": request_id,
        "start_unix": round(mono_to_wall(origin), 6),
        "traces": [t.to_dict() for t in hits],
        "timeline": events,
    }
