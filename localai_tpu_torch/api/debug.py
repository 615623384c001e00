"""Introspection endpoints: device health, program costs, thread stacks,
the flight recorder, the dispatch anatomy, profiles, history, the KV pool.

Port of ``localai_tpu/api/debug.py`` (the query parameters and the payload
shapes kept), written, as ``api.localai`` is, as framework-free GET
handlers ``(manager, query)`` or ``(manager, query, param)`` that
``api.server`` maps HTTP onto; a bad parameter is a 400.

``GET /debug/devices`` — liveness + memory: a timeout-guarded probe on the
device (``?probe=0`` skips it, ``?probe_timeout=S`` bounds it, at most
120), each card's memory stats, the census of device memory (KV pool vs
weights vs other), the stall watchdog's channel table and the roofline.

``GET /debug/programs`` — the program cost catalog: per watched runner
program and shape, the port's reckoned FLOPs and bytes joined with the
scheduler's measured per-dispatch latency into achieved GFLOP/s, GB/s and
fractions of the roofline (``?harvest=0`` lists without the costs).

``GET /debug/stacks`` — every live thread's stack, on demand.

``GET /debug/flight`` — per-model flight rings: per-dispatch records with
windowed step-time percentiles. ``?since=<monotonic ts>`` returns only
records newer than it; ``?limit=N`` (default 256, 1–4096) keeps the
newest N. Reading it never touches a device.

``GET /debug/anatomy`` — the dispatch-anatomy breakdown per model:
windowed gap/sched/launch/sync percentiles and totals, the derived
``host_overhead_fraction`` / ``device_bubble_fraction``, per-phase wall
shares and the unattributed remainder. ``?window=S`` (default 60;
``window=0`` reads the whole ring). On the port ``launch`` is the host
issuing the eager step's kernels (see ``obs.anatomy`` for the caveats).

``GET /debug/profiles`` — the anomaly-capture manifest (``obs.profiler``).

``GET /debug/history`` / ``/debug/history/{series}`` — the persistent
multi-resolution metrics history (``?res=1|10|300``, ``?since=<unix
ts>``).

``GET /debug/fleet/flight`` — every fleet's replicas' flight rings
merged into one table with a ``replica`` column, and a pane per replica
(percentiles, anatomy fractions; a dead replica's pane says its state)
(``obs.fleetview.fleet_flight``; ``?since=``, ``?limit=`` as above).

``GET /debug/kv`` — per-model paged block-pool audit: allocator stats,
live tables, ``BlockAllocator.check_invariants()``, the violations the
scheduler's drain-time sweep has seen (``LOCALAI_KV_CHECK=1``) and, with
a host KV tier, its ``tier_stats()``; a fleet's entry is its KV economy:
the prefix directory, sibling fetches, migrations and the replicas' tier
sums.

``GET /debug/faults`` — the fault-injection registry (``faults``): whether
anything is armed, the injection sites, the armed specs with their hit
and fire counts, and each supervised engine's ``status()``. ``POST`` a
spec (``{"site", "mode", "after", "times", "match", "delay_s"}``) to arm
it; ``DELETE`` (``?site=`` for one site) clears. Like every route but the
exempt ones it needs the API key when keys are set.
"""

from __future__ import annotations

import time

from localai_tpu_torch import faults
from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.obs import anatomy as obs_anatomy
from localai_tpu_torch.obs import compile as obs_compile
from localai_tpu_torch.obs import device as obs_device
from localai_tpu_torch.obs import history as obs_history
from localai_tpu_torch.obs import watchdog as obs_watchdog
from localai_tpu_torch.obs.profiler import PROFILER


def _number(query: dict, name: str, default, cast, what: str):
    try:
        return cast(query.get(name, default))
    except (TypeError, ValueError):
        raise APIError(400, f"{name} must be {what}") from None


def _runners(manager) -> list:
    return [r for r in (getattr(sm, "runner", None)
                        for sm in manager.loaded_snapshot().values())
            if r is not None]


def _flights(manager) -> dict:
    """name → flight ring of every loaded model that has one."""
    out = {}
    for name, sm in manager.loaded_snapshot().items():
        rec = getattr(getattr(sm, "scheduler", None), "flight", None)
        if rec is not None:
            out[name] = rec
    return out


def devices(manager, query) -> dict:
    want_probe = query.get("probe", "1") != "0"
    probe_timeout = _number(query, "probe_timeout", 5.0, float, "a number")
    if not probe_timeout > 0:  # rejects 0, negatives and NaN
        raise APIError(400, "probe_timeout must be positive")
    # the probe's join blocks this handler's thread: bound it
    probe_timeout = min(probe_timeout, 120.0)
    runners = _runners(manager)
    report: dict = {
        "devices": obs_device.device_memory(),
        "census": obs_device.hbm_census(obs_device.known_arrays(runners)),
        "watchdog": obs_watchdog.WATCHDOG.status(),
        "roofline": obs_device.roofline(),
    }
    if want_probe:
        report["probe"] = obs_device.probe_device(
            timeout=probe_timeout).to_dict()
    return report


def programs(manager, query) -> dict:
    harvest = query.get("harvest", "1") != "0"
    # the live schedulers' step EMAs, so a report right after boot still
    # joins a latency (the drain-time feed is authoritative under traffic)
    for sm in manager.loaded_snapshot().values():
        sched = getattr(sm, "scheduler", None)
        ema = getattr(sched, "_step_ema", None)
        steps = getattr(sched, "last_dispatch_steps", 0)
        if ema and steps:
            prog = "decode" if steps == 1 else "decode_n"
            obs_compile.note_latency(prog, ema * steps, steps=steps)
    rl = obs_device.roofline()
    return {"roofline": rl,
            "programs": obs_compile.CATALOG.report(roofline=rl,
                                                   harvest=harvest)}


def stacks(manager, query) -> dict:
    return {"threads": obs_watchdog.dump_stacks()}


def flight(manager, query) -> dict:
    since = _number(query, "since", 0.0, float,
                    "a number (a record's monotonic ts)")
    limit = max(1, min(_number(query, "limit", 256, int, "an integer"),
                       4096))
    models = {
        name: {
            "records": rec.snapshot(since=since, limit=limit),
            "percentiles": rec.percentiles(),
            "dispatches": rec.count,
            "tokens_total": rec.total_tokens,
            "capacity": rec.capacity,
        }
        for name, rec in _flights(manager).items()}
    # the clock records are stamped with, so pollers can window
    return {"now_monotonic": round(time.monotonic(), 6), "models": models}


def fleet_flight(manager, query) -> dict:
    from localai_tpu_torch.obs import fleetview

    since = _number(query, "since", 0.0, float,
                    "a number (a record's monotonic ts)")
    limit = max(1, min(_number(query, "limit", 256, int, "an integer"),
                       4096))
    models = {name: fleetview.fleet_flight(sm, since=since, limit=limit)
              for name, sm in manager.loaded_snapshot().items()
              if getattr(sm, "pool", None) is not None}
    return {"now_monotonic": round(time.monotonic(), 6), "models": models}


def anatomy(manager, query) -> dict:
    window = _number(query, "window", obs_anatomy.DEFAULT_WINDOW_S, float,
                     "a number (seconds)")
    window_s = window if window > 0 else None  # 0 = whole ring
    models = {name: obs_anatomy.breakdown(rec, window_s=window_s)
              for name, rec in _flights(manager).items()}
    return {"now_monotonic": round(time.monotonic(), 6),
            "phases": list(obs_anatomy.PHASES), "models": models}


def profiles(manager, query) -> dict:
    return PROFILER.report()


def history_index(manager, query) -> dict:
    return {"series": obs_history.HISTORY.series_names(),
            "resolutions_s": list(obs_history.RESOLUTIONS),
            "capacity": {str(r): c
                         for r, c in obs_history.CAPACITY.items()}}


def history_series(manager, query, name: str) -> dict:
    res = _number(query, "res", 10, int, "an integer (seconds)")
    since = _number(query, "since", 0.0, float, "a unix timestamp")
    out = obs_history.HISTORY.query(name, res=res, since=since)
    if out is None:
        raise APIError(404, f"unknown series {name!r}")
    return out


def kv(manager, query) -> dict:
    models = {}
    for name, sm in manager.loaded_snapshot().items():
        sched = getattr(sm, "scheduler", None)
        alloc = getattr(getattr(sm, "runner", None), "allocator", None)
        if alloc is None:
            # a fleet facade has no allocator of its own: its KV economy
            directory = getattr(sched, "directory", None)
            if directory is not None:
                models[name] = {
                    "directory": directory.stats(),
                    "sibling_transfers": sched.sibling_transfers,
                    "sibling_fallbacks": sched.sibling_fallbacks,
                    "migrations": sched.migrations,
                    "migration_fallbacks": sched.migration_fallbacks,
                }
                m = sched.metrics()
                if "kv_tier_spills" in m:
                    models[name]["tier"] = {
                        "blocks": m.get("kv_tier_blocks", 0),
                        "bytes": m.get("kv_tier_bytes", 0),
                        "spills_total": m.get("kv_tier_spills", 0),
                        "reloads_total": m.get("kv_tier_reloads", 0),
                    }
            continue  # contiguous / non-LLM engines
        st = alloc.stats()
        models[name] = {
            "block_tokens": alloc.block_tokens,
            "blocks": {"total": st.total, "free": st.free, "used": st.used,
                       "cached": st.cached, "watermark": st.high_watermark},
            "tables": {str(s): n
                       for s, n in alloc.tables_snapshot().items()},
            "shared_tokens_total": alloc.shared_tokens_total,
            "evictions_total": alloc.evictions_total,
            "invariant_violations": alloc.check_invariants(),
            # the scheduler's drain-time sweep (LOCALAI_KV_CHECK=1)
            "violations_seen": getattr(sched, "kv_invariant_violations",
                                       0),
        }
        ts = alloc.tier_stats()
        if ts is not None:
            models[name]["tier"] = ts
    return {"models": models}


def faults_get(manager, query) -> dict:
    supervisors = {}
    for name, sm in manager.loaded_snapshot().items():
        sup = getattr(getattr(sm, "scheduler", None), "supervisor", None)
        if sup is not None:
            supervisors[name] = sup.status()
    return {"active": faults.active(), "sites": faults.SITES,
            "armed": faults.snapshot(), "supervisors": supervisors}


_SPEC_FIELDS = {"site", "mode", "after", "times", "match", "delay_s"}


def faults_post(manager, body: dict) -> dict:
    if not body.get("site"):
        raise APIError(400, 'need {"site": ..., ...}')
    unknown = set(body) - _SPEC_FIELDS
    if unknown:
        raise APIError(400, f"unknown fields {sorted(unknown)}")
    try:
        spec = faults.arm(faults.FaultSpec(**body))
    except (TypeError, ValueError) as e:
        raise APIError(400, str(e)) from None
    return {"armed": spec.to_dict()}


def faults_delete(manager, query) -> dict:
    return {"cleared": faults.clear(query.get("site") or None)}


GET = {"/debug/devices": devices, "/debug/programs": programs,
       "/debug/stacks": stacks, "/debug/flight": flight,
       "/debug/anatomy": anatomy, "/debug/profiles": profiles,
       "/debug/history": history_index, "/debug/kv": kv,
       "/debug/faults": faults_get, "/debug/fleet/flight": fleet_flight}
POST = {"/debug/faults": faults_post}
DELETE = {"/debug/faults": faults_delete}
GET_PARAM = (("/debug/history/{series}", history_series),)
