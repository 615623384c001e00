"""Tracing endpoints: recent span trees and per-request timelines.

Port of ``localai_tpu/api/traces.py`` over the local trace store
(``obs.trace.STORE``).

``GET /v1/traces`` — newest-first span trees (``?limit=N``,
``?kind=request|http``, ``?model=name``).

``GET /v1/traces/{trace_id}`` — one stitched waterfall for one trace id:
the front door's spans plus every fleet replica's half, harvested from
the replicas the spans name and skew-anchored to the local dispatch span
(``obs.fleetview.stitch``); a dead replica is an ``unreachable`` pane.

``GET /debug/timeline/{request_id}`` — the same traces as one flat,
time-ordered timeline with offsets from the earliest span; when the trace
crossed fleet replicas, the stitched waterfall rides along under
``fleet``.
"""

from __future__ import annotations

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.obs import fleetview
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


def _harvest_tid(ident: str, hits: list):
    """The genuine trace id to harvest replicas by: ``ident`` also matches
    engine request ids (per-replica counters), which must never be sent
    to a replica as a trace id."""
    tids = {t.trace_id for t in hits}
    return ident if ident in tids else (
        next(iter(tids)) if len(tids) == 1 else None)


def _stitched(manager, tid: str, local: list[dict]) -> dict:
    """Harvest every fleet-served model's replicas named by this trace's
    spans and stitch one waterfall."""
    harvested: dict[str, dict] = {}
    for sm in manager.loaded_snapshot().values():
        if getattr(sm, "pool", None) is not None:
            harvested.update(fleetview.harvest_for_trace(sm, tid, local))
    return fleetview.stitch(tid, local, harvested)


def trace_detail(manager, query: dict, trace_id: str) -> dict:
    hits = _find(trace_id)
    local = [t.to_dict() for t in hits]
    harvest_tid = _harvest_tid(trace_id, hits)
    if harvest_tid is None:
        return fleetview.stitch(trace_id, local, {})
    return _stitched(manager, harvest_tid, local)


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
    local = [t.to_dict() for t in hits]
    body = {
        "request_id": request_id,
        "start_unix": round(mono_to_wall(origin), 6),
        "traces": local,
        "timeline": events,
    }
    harvest_tid = _harvest_tid(request_id, hits)
    if harvest_tid is not None and fleetview.replica_ids_for_trace(local):
        stitched = _stitched(manager, harvest_tid, local)
        body["fleet"] = {"replicas": stitched["replicas"],
                         "waterfall": stitched["waterfall"]}
    return body
