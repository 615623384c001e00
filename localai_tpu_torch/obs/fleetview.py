"""Fleet-wide telemetry: one pane of glass for a replicated model.

Port of ``localai_tpu/obs/fleetview.py``. Every replica records its
spans, flight ring and step-time percentiles; this module pulls each
replica's pane (:func:`telemetry_payload`: the trace spans of one trace
id, a flight-ring snapshot, the scheduler's metrics dict, the usage
ledger) and merges the panes into the views an operator reads:

  * :func:`stitch` — one waterfall per trace id: front-door spans and
    replica-side engine spans in one time-ordered list, every remote span
    tagged ``replica=`` (``GET /v1/traces/{id}``);
  * :func:`fleet_flight` — the replicas' flight rings merged into one
    table with a ``replica`` column (``GET /debug/fleet/flight``);
  * :func:`fleet_usage` — per-replica usage panes (``GET
    /v1/usage?replicas=1``).

**Clock skew.** A harvested trace is anchored: its root is pinned to the
local RPC span's start (:func:`anchor_trace`), so its offsets are exact
relative to each other, and the applied shift is recorded as
``skew_offset_ms``. In-process replicas share the front door's trace
store and clock: their panes say ``shared_store`` and the stitcher drops
the traces it already holds instead of duplicating them.

Host-side dict work only, no device reads. Replicas are duck-typed
(``telemetry()``/``id``/``state``): the module imports nothing of the
fleet.
"""

from __future__ import annotations

import logging
from typing import Any

log = logging.getLogger(__name__)

# flight records harvested per replica by default (one /debug/flight page)
DEFAULT_FLIGHT_LIMIT = 256
# recent request traces returned by a trace-id-less harvest
DEFAULT_RECENT = 20


def telemetry_payload(scheduler: Any, *, trace_id: str = "",
                      since: float = 0.0, limit: int = DEFAULT_FLIGHT_LIMIT,
                      recent: int = DEFAULT_RECENT,
                      store: Any = None) -> dict:
    """One replica's telemetry pane, built IN the replica's process.

    The single source of a replica's pane (``InProcessReplica.
    telemetry`` calls it, as the JAX package's gRPC servicer does).
    ``scheduler`` may be ``None`` (no model loaded): the trace harvest
    still answers.
    """
    from localai_tpu_torch.obs.trace import STORE

    store = store if store is not None else STORE
    if trace_id:
        hits = store.find(trace_id)
    else:
        hits = store.recent(limit=max(0, recent), kind="request")
    payload: dict = {"traces": [t.to_dict() for t in hits],
                     "flight": None, "metrics": {}}
    if scheduler is None:
        return payload
    flight = getattr(scheduler, "flight", None)
    if flight is not None:
        payload["flight"] = {
            # limit <= 0 = "spans only, skip the rows" (the trace-stitch
            # harvest); percentiles/counters are cheap and always ride
            "records": (flight.snapshot(since=since, limit=limit)
                        if limit > 0 else []),
            "percentiles": flight.percentiles(),
            # dispatch anatomy (obs.anatomy): windowed phase breakdown +
            # host/bubble fractions, so the fleet view gets per-replica
            # bubble columns without a second RPC
            "anatomy": flight.phases(
                window_s=60.0) if hasattr(flight, "phases") else None,
            "dispatches": flight.count,
            "tokens_total": flight.total_tokens,
            "capacity": flight.capacity,
        }
    try:
        payload["metrics"] = scheduler.metrics()
    except Exception as e:  # noqa: BLE001 — a stats hiccup ≠ no pane
        payload["metrics"] = {"error": str(e)}
    # this process's usage-ledger pane (obs.ledger): per-tenant panes +
    # waste decomposition. A worker process's ledger is fed by ITS
    # engine, so the front door can drill into per-replica attribution —
    # the harvest view keys these by replica and never sums them into
    # the front-door totals (the front door's own ledger already counts
    # every tenant-stamped request once)
    try:
        from localai_tpu_torch.obs.ledger import LEDGER

        payload["usage"] = LEDGER.snapshot()
    except Exception as e:  # noqa: BLE001 — usage pane ≠ telemetry
        payload["usage"] = {"error": str(e)}
    return payload


# -- skew anchoring ----------------------------------------------------------


def anchor_trace(trace: dict, anchor_unix: float, *,
                 replica: str = "") -> dict:
    """Shift a harvested trace dict so its root starts at ``anchor_unix``
    (the local endpoint of the event both clocks observed — the dispatch
    RPC span's start).  Children shift by the same offset, so remote
    durations and relative ordering are preserved exactly; only the
    absolute placement is corrected.  Returns a new dict tagged with
    ``replica`` and the applied ``skew_offset_ms``."""
    offset = anchor_unix - float(trace.get("start_unix") or anchor_unix)
    out = dict(trace)
    out["start_unix"] = round(float(trace.get("start_unix", 0.0)) + offset, 6)
    attrs = dict(out.get("attrs") or {})
    if replica:
        attrs["replica"] = replica
    attrs["skew_offset_ms"] = round(offset * 1e3, 3)
    attrs["skew_anchored"] = True
    out["attrs"] = attrs
    children = []
    for span in trace.get("children", ()):  # each span shifts rigidly
        s = dict(span)
        if s.get("start_unix") is not None:
            s["start_unix"] = round(float(s["start_unix"]) + offset, 6)
        if replica:
            s["attrs"] = {**(s.get("attrs") or {}), "replica": replica}
        children.append(s)
    out["children"] = children
    return out


def replica_anchors(local_traces: list[dict]) -> dict[str, float]:
    """``{replica id: local anchor start_unix}`` from the front door's own
    spans: the ``rpc`` span records which replica served the dispatch, the
    ``prefix_transfer`` span which prefill/decode pair ran the handoff.
    First span wins per replica (a failover's second rpc span anchors the
    replica that actually served)."""
    anchors: dict[str, float] = {}
    for tr in local_traces:
        for span in tr.get("children", ()):
            attrs = span.get("attrs") or {}
            start = span.get("start_unix")
            if start is None:
                continue
            for key in ("replica", "prefill", "decode"):
                rid = attrs.get(key)
                if rid and rid not in anchors:
                    anchors[rid] = float(start)
    return anchors


def replica_ids_for_trace(local_traces: list[dict]) -> set[str]:
    """Every replica id the front door's spans say took part in this
    trace (dispatch targets, failover attempts, disagg prefill/decode)."""
    rids = set(replica_anchors(local_traces))
    for tr in local_traces:
        attrs = tr.get("attrs") or {}
        for key in ("replica", "prefill_replica"):
            if attrs.get(key):
                rids.add(attrs[key])
    return rids


# -- stitching ---------------------------------------------------------------


def _pull_panes(targets: list[tuple[str, Any]]) -> dict[str, dict]:
    """Run one bounded ``telemetry()`` pull per replica CONCURRENTLY:
    wedged replicas burn their deadlines in parallel, so the endpoint
    pays ~one fleet RPC deadline total, not one per wedged peer.
    ``telemetry()`` never raises (errors come back as unreachable
    panes), so gathering the futures is exception-free."""
    if not targets:
        return {}
    if len(targets) == 1:
        rid, fn = targets[0]
        return {rid: fn()}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(8, len(targets)),
                            thread_name_prefix="fleetview-pull") as ex:
        futures = [(rid, ex.submit(fn)) for rid, fn in targets]
        return {rid: f.result() for rid, f in futures}


def harvest_for_trace(sm: Any, trace_id: str,
                      local_traces: list[dict]) -> dict[str, dict]:
    """Pull the remote half of one trace from every replica the local
    spans name.  One bounded ``telemetry()`` call per replica, run
    concurrently, on the HTTP handler's own thread; a wedged replica
    degrades to an error pane, not a
    hung endpoint."""
    pool = getattr(sm, "pool", None)
    if pool is None:
        return {}
    rids = replica_ids_for_trace(local_traces)
    targets = [
        (r.id, lambda tele=r.telemetry: tele(trace_id=trace_id,
                                             limit=0, recent=0))
        for r in pool.members()
        if r.id in rids and getattr(r, "telemetry", None) is not None
    ]
    return _pull_panes(targets)


def stitch(trace_id: str, local_traces: list[dict],
           harvested: dict[str, dict]) -> dict:
    """Merge the front door's traces with each replica's harvested half
    into ONE waterfall.  Local spans keep their clocks; remote span trees
    are skew-anchored to the local rpc/prefix_transfer span for their
    replica (falling back to the earliest local root when the local spans
    never named the replica).  In-process replicas share the front door's
    trace store and mark their payloads ``shared_store``: their harvested
    traces already present locally (same trace id + request id) are
    dropped rather than duplicated.  Cross-process panes are NEVER
    deduped — request ids are per-process counters, so a worker's
    ``model-0`` legitimately coexists with the front door's
    ``model-0``."""
    anchors = replica_anchors(local_traces)
    fallback = min((float(t["start_unix"]) for t in local_traces
                    if t.get("start_unix") is not None),
                   default=0.0)
    seen = {(t.get("trace_id"), t.get("request_id")) for t in local_traces}
    panes: dict[str, dict] = {}
    stitched: list[dict] = []
    for rid, payload in harvested.items():
        if not isinstance(payload, dict) or payload.get("error"):
            panes[rid] = {
                "unreachable": True,
                "error": (payload or {}).get("error", "no payload"),
            }
            continue
        shared = bool(payload.get("shared_store"))
        anchored = []
        for rt in payload.get("traces", ()):
            if shared and (rt.get("trace_id"),
                           rt.get("request_id")) in seen:
                continue  # in-process replica: already in the local store
            anchored.append(anchor_trace(
                rt, anchors.get(rid, fallback), replica=rid))
        panes[rid] = {"traces": anchored}
        stitched.extend(anchored)
    events: list[dict] = []
    all_traces = list(local_traces) + stitched
    origin = min((float(t["start_unix"]) for t in all_traces
                  if t.get("start_unix") is not None), default=0.0)
    known = set(harvested) | set(anchors)
    for tr in all_traces:
        attrs = tr.get("attrs") or {}
        # the replica column means "recorded ON replica X", not "served
        # by X": harvested trees carry their replica from anchoring; an
        # in-process replica's engine trace sits in the LOCAL store under
        # its rid as the model name (per-replica identities); the
        # front door's own spans stay untagged
        if attrs.get("skew_anchored"):
            rid = attrs.get("replica", "")
        elif tr.get("model") in known:
            rid = tr["model"]
        else:
            rid = ""
        for span in tr.get("children", ()):
            sa = span.get("attrs") or {}
            events.append({
                # strictly "recorded ON" — a front-door rpc span's attrs
                # still say which replica it dispatched to
                "replica": rid,
                "source": tr.get("request_id", ""),
                "kind": tr.get("kind", ""),
                "name": span.get("name", ""),
                "offset_ms": round(
                    (float(span.get("start_unix") or origin) - origin) * 1e3,
                    3),
                "duration_ms": span.get("duration_ms"),
                "attrs": sa,
            })
    events.sort(key=lambda e: e["offset_ms"])
    return {
        "trace_id": trace_id,
        "start_unix": round(origin, 6),
        "traces": local_traces,
        "replicas": panes,
        "waterfall": events,
    }


def stitched_trace(sm: Any, trace_id: str,
                   local_traces: list[dict]) -> dict:
    """harvest + stitch in one call (the ``/v1/traces/{id}`` body)."""
    return stitch(trace_id, local_traces,
                  harvest_for_trace(sm, trace_id, local_traces))


# -- fleet flight merge ------------------------------------------------------


def fleet_flight(sm: Any, *, since: float = 0.0,
                 limit: int = DEFAULT_FLIGHT_LIMIT) -> dict:
    """Merge every replica's flight ring into one table with a
    ``replica`` column.  Rows are ordered by their wall-clock stamp
    (``ts_unix``) — an approximation across hosts (wall clocks skew where
    monotonic clocks don't exist at all), good enough for the "what was
    the FLEET doing" read this view exists for; per-replica sections keep
    the exact per-replica ordering.  Unhealthy or wedged replicas degrade
    to a ``state``/``unreachable`` pane, never a failed endpoint."""
    pool = getattr(sm, "pool", None)
    if pool is None:
        return {"replicas": {}, "records": []}
    panes: dict[str, dict] = {}
    merged: list[dict] = []
    targets: list[tuple[str, Any]] = []
    states: dict[str, str] = {}
    for r in pool.members():
        states[r.id] = r.state
        if r.state != "healthy":
            panes[r.id] = {"state": r.state}
            continue
        tele = getattr(r, "telemetry", None)
        if tele is None:
            panes[r.id] = {"state": r.state,
                           "error": "no telemetry surface"}
            continue
        targets.append((r.id, lambda tele=tele: tele(
            trace_id="", since=since, limit=limit, recent=0)))
    for rid, payload in _pull_panes(targets).items():
        state = states.get(rid, "")
        if not isinstance(payload, dict) or payload.get("error"):
            panes[rid] = {
                "state": state, "unreachable": True,
                "error": (payload or {}).get("error", "no payload"),
            }
            continue
        flight = payload.get("flight") or {}
        records = flight.get("records") or []
        # anatomy pane is .get()-guarded throughout: a mixed-version
        # fleet where some replicas predate the phase columns degrades
        # to None fractions / blank columns, never a KeyError
        anatomy = flight.get("anatomy") or {}
        panes[rid] = {
            "state": state,
            "records": len(records),
            "percentiles": flight.get("percentiles"),
            "anatomy": flight.get("anatomy"),
            "host_overhead_fraction": anatomy.get("host_overhead_fraction"),
            "device_bubble_fraction": anatomy.get("device_bubble_fraction"),
            "dispatches": flight.get("dispatches"),
            "tokens_total": flight.get("tokens_total"),
        }
        for rec in records:
            row = {**rec, "replica": rid}
            for ph in ("gap_ms", "sched_ms", "launch_ms", "sync_ms"):
                row.setdefault(ph, None)  # old-version replica → blank
            merged.append(row)
    merged.sort(key=lambda rec: rec.get("ts_unix") or 0.0)
    return {"replicas": panes, "records": merged, "count": len(merged)}


# -- fleet usage harvest -----------------------------------------------------


def fleet_usage(sm: Any) -> dict:
    """Per-replica usage-ledger panes (obs.ledger snapshots) for one
    fleet-served model — the drill-down half of ``GET /v1/usage``.  Keyed
    by replica id and deliberately NOT summed: the front door's own
    ledger already counts every tenant-stamped request exactly once
    ("whoever stamped the tenant owns the feed"), so these panes answer
    "which replica did tenant X's work", not "how much work was done".
    Unhealthy/wedged replicas degrade to an error pane, never a failed
    endpoint."""
    pool = getattr(sm, "pool", None)
    if pool is None:
        return {}
    targets: list[tuple[str, Any]] = []
    panes: dict[str, dict] = {}
    for r in pool.members():
        if r.state != "healthy":
            panes[r.id] = {"state": r.state}
            continue
        tele = getattr(r, "telemetry", None)
        if tele is None:
            panes[r.id] = {"error": "no telemetry surface"}
            continue
        targets.append((r.id, lambda tele=tele: tele(
            trace_id="", limit=0, recent=0)))
    for rid, payload in _pull_panes(targets).items():
        if not isinstance(payload, dict) or payload.get("error"):
            panes[rid] = {
                "unreachable": True,
                "error": (payload or {}).get("error", "no payload"),
            }
            continue
        usage = payload.get("usage")
        if payload.get("shared_store"):
            # in-process replica: its "ledger" IS the front door's
            # process-global singleton — echoing it per replica would
            # present the same totals N times as if they were distinct
            panes[rid] = {"shared_ledger": True}
        else:
            panes[rid] = usage if isinstance(usage, dict) else {}
    return panes
