"""The fleet telemetry plane of the PyTorch port against the JAX package's,
on the CPU.

  * ``anchor_trace``, ``replica_anchors``, ``replica_ids_for_trace`` and
    ``stitch`` give the JAX package's answers on the same inputs (the
    anchoring shift, shared-store dedupe, unreachable panes, the
    fallback anchor, cross-process panes never deduped);
  * ``telemetry_payload``, ``fleet_flight`` and ``fleet_usage`` build the
    JAX package's panes from the same replicas (stub panes of several
    shapes, a dead replica, a replica that predates the anatomy columns);
  * a port fleet behind the port's HTTP server: ``/v1/traces/{id}`` is the
    JAX package's stitch of the same traces and panes and names the
    replicas, ``/debug/timeline/{id}`` carries the ``fleet`` half,
    ``/debug/fleet/flight`` merges the replicas' rings with a ``replica``
    column, ``/debug/kv`` shows the fleet's KV economy and ``/v1/usage
    ?replicas=1`` the per-replica panes.
"""

import json
import urllib.request
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from localai_tpu.obs import fleetview as jfleetview  # noqa: E402
from localai_tpu.obs.flight import FlightRecorder as JaxFlight  # noqa: E402
from localai_tpu.obs.trace import RequestTrace as JaxTrace  # noqa: E402
from localai_tpu.obs.trace import TraceStore as JaxStore  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.fleet.replica import InProcessReplica  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.obs import fleetview  # noqa: E402
from localai_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from localai_tpu_torch.obs.trace import STORE, RequestTrace, TraceStore  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

PKGS = {"port": fleetview, "jax": jfleetview}


def _trace_dict(trace_id="t1", request_id="req-0", model="m", start=100.0,
                spans=(), attrs=None):
    return {
        "trace_id": trace_id, "request_id": request_id, "kind": "request",
        "model": model, "name": "request", "start_unix": start,
        "duration_ms": 10.0, "finished": True, "attrs": dict(attrs or {}),
        "children": [{"name": n, "start_unix": s, "duration_ms": d,
                      "attrs": dict(a)} for n, s, d, a in spans],
    }


def _both(fn_name, *args, **kw):
    out = {p: getattr(m, fn_name)(*args, **kw) for p, m in PKGS.items()}
    assert out["port"] == out["jax"], fn_name
    return out["port"]


def test_anchor_trace_as_the_jax_package():
    remote = _trace_dict(start=5000.0, spans=(("queued", 5000.0, 0.5, {}),
                                              ("decode", 5000.25, 3.0, {})))
    out = _both("anchor_trace", remote, 100.5, replica="m/r0")
    assert out["start_unix"] == pytest.approx(100.5)
    assert out["attrs"]["skew_offset_ms"] == pytest.approx(-4899500.0)
    assert remote["start_unix"] == 5000.0


def test_anchors_and_replica_ids_as_the_jax_package():
    local = [_trace_dict(
        model="m", attrs={"replica": "m/r1", "prefill_replica": "m/p0"},
        spans=(("route", 100.0, 0.1, {"replica": "m/r1"}),
               ("prefix_transfer", 100.2, 2.0,
                {"prefill": "m/p0", "decode": "m/r1"}),
               ("rpc", 102.5, 5.0, {"replica": "m/r1"})))]
    assert _both("replica_anchors", local) == {"m/r1": 100.0,
                                               "m/p0": 100.2}
    assert _both("replica_ids_for_trace", local) == {"m/r1", "m/p0"}


_LOCAL = [_trace_dict(trace_id="tx", request_id="front-0", model="m",
                      attrs={"replica": "m/r0"},
                      spans=(("rpc", 100.0, 5.0, {"replica": "m/r0"}),
                             ("route", 99.9, 0.05, {"replica": "m/r1"})))]


@pytest.mark.parametrize("case", ["dedupe", "cross-process", "fallback",
                                  "unreachable", "none"])
def test_stitch_as_the_jax_package(case):
    dup = _trace_dict(trace_id="tx", request_id="front-0", model="m")
    remote = _trace_dict(trace_id="tx", request_id="m/r0-0", model="m/r0",
                         start=7777.0, spans=(("decode", 7777.5, 2.0, {}),))
    harvested = {
        "dedupe": {"m/r0": {"traces": [dup, remote], "shared_store": True}},
        "cross-process": {"m/r0": {"traces": [dup, remote]}},
        "fallback": {"m/r9": {"traces": [remote]}},
        "unreachable": {"m/r1": {"error": "deadline", "unreachable": True},
                        "m/r0": None},
        "none": {},
    }[case]
    out = _both("stitch", "tx", _LOCAL, harvested)
    offsets = [e["offset_ms"] for e in out["waterfall"]]
    assert offsets == sorted(offsets)
    if case == "dedupe":
        assert len(out["replicas"]["m/r0"]["traces"]) == 1
        assert ("m/r0", "decode") in {(e["replica"], e["name"])
                                      for e in out["waterfall"]}


def _scheduler(flight_mod, metrics=None):
    flight = flight_mod(8)
    flight.record(program="decode_n", steps=4, dispatch_ms=8.0,
                  occupancy=0.5, queue_depth=0, kv_utilization=0.1,
                  tokens=4)
    return SimpleNamespace(flight=flight,
                           metrics=lambda: metrics or {"num_slots": 2})


def _store(store_mod, trace_mod):
    store = store_mod(8)
    for tid, rid in (("trace-abc", "eng-0"), ("trace-zzz", "eng-1")):
        tr = trace_mod(tid, rid, model="m")
        tr.begin("decode")
        store.start(tr)
        store.finish(tr)
    return store


def _strip_times(payload):
    """A pane without its wall and monotonic stamps (the two packages'
    recorders run at different instants)."""
    out = json.loads(json.dumps(payload, default=str))
    for t in out.get("traces", []):
        for k in ("start_unix", "duration_ms"):
            t.pop(k, None)
        for c in t.get("children", []):
            c.pop("start_unix", None)
            c.pop("duration_ms", None)
    fl = out.get("flight") or {}
    for rec in fl.get("records", []):
        for k in ("ts", "ts_unix"):
            rec.pop(k, None)
    if fl.get("anatomy"):
        fl["anatomy"] = sorted(fl["anatomy"])
    out.pop("usage", None)
    return out


@pytest.mark.parametrize("kw", [{"trace_id": "trace-abc"}, {"recent": 1},
                                {"limit": 0}])
def test_telemetry_payload_as_the_jax_package(kw):
    mine = fleetview.telemetry_payload(
        _scheduler(FlightRecorder), store=_store(TraceStore, RequestTrace),
        **kw)
    theirs = jfleetview.telemetry_payload(
        _scheduler(JaxFlight), store=_store(JaxStore, JaxTrace), **kw)
    assert set(mine) == set(theirs)
    assert _strip_times(mine) == _strip_times(theirs)


def test_telemetry_payload_without_scheduler_or_metrics():
    def boom():
        raise RuntimeError("stats broke")

    for m in PKGS.values():
        assert m.telemetry_payload(None, store=TraceStore(4))["flight"] \
            is None
        sched = SimpleNamespace(flight=None, metrics=boom)
        assert m.telemetry_payload(sched, store=TraceStore(4))[
            "metrics"] == {"error": "stats broke"}


class _Rep:
    def __init__(self, rid, state="healthy", pane=None):
        self.id, self.state, self.pane = rid, state, pane

    def telemetry(self, trace_id="", since=0.0, limit=256, recent=20):
        return self.pane


def _panes():
    rec = {"ts": 1.0, "ts_unix": 100.0, "program": "decode_n",
           "dispatch_ms": 5.0, "gap_ms": 1.0, "sched_ms": 0.5,
           "launch_ms": 3.0, "sync_ms": 0.5}
    anat = {"host_overhead_fraction": 0.8, "device_bubble_fraction": 0.4}
    return [
        _Rep("m/r0", pane={"flight": {"records": [rec, {**rec, "ts_unix":
                                                        90.0}],
                                      "percentiles": {"step_ms_p50": 5.0},
                                      "anatomy": anat, "dispatches": 2,
                                      "tokens_total": 8},
                           "usage": {"tenants": 1}, "shared_store": True}),
        _Rep("m/r1", pane={"flight": {"records": [
            {"ts": 2.0, "ts_unix": 95.0, "program": "decode_n",
             "dispatch_ms": 4.0}], "percentiles": None, "dispatches": 1,
            "tokens_total": 4}, "usage": {"tenants": 2}}),
        _Rep("m/r2", state="dead"),
        _Rep("m/r3", pane={"error": "deadline", "unreachable": True}),
    ]


def test_fleet_flight_and_usage_as_the_jax_package():
    sm = SimpleNamespace(pool=SimpleNamespace(members=_panes))
    out = _both("fleet_flight", sm)
    assert [r["replica"] for r in out["records"]] == ["m/r0", "m/r1", "m/r0"]
    assert out["replicas"]["m/r2"] == {"state": "dead"}
    usage = _both("fleet_usage", sm)
    assert usage["m/r0"] == {"shared_ledger": True}
    assert _both("fleet_flight", SimpleNamespace()) == {"replicas": {},
                                                        "records": []}


def test_dead_in_process_replica_answers_an_unreachable_pane():
    dead = InProcessReplica("m/dead", "decode", lambda: None)
    dead._killed = True
    pane = dead.telemetry()
    assert pane["unreachable"] is True and "error" in pane


# -- a port fleet behind the HTTP server ------------------------------------------

TINY = {"name": "fvt", "model": "debug:tiny", "context_size": 256,
        "parameters": {"temperature": 0.0, "max_tokens": 8},
        "engine": {"max_slots": 2, "prefill_buckets": [16, 32, 64, 128],
                   "dtype": "float32", "kv_dtype": "float32",
                   "kv_block_tokens": 16}}


@pytest.fixture(scope="module")
def served(monkeypatch_module):
    monkeypatch_module.setenv("LOCALAI_KV_TIER_MB", "4")
    mcfg = ModelConfig.from_dict(TINY)
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    mgr = ModelManager(AppConfig(device="cpu", fleet_replicas=2,
                                 fleet_prefill_replicas=1,
                                 fleet_backend="inprocess",
                                 fleet_disagg_threshold=48), loader)
    srv = APIServer(mgr, "127.0.0.1", 0).start()
    yield srv, mgr.get("fvt")
    srv.shutdown()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _chat(url, text, tid):
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({"model": "fvt", "max_tokens": 6, "temperature": 0,
                         "messages": [{"role": "user",
                                       "content": text}]}).encode(),
        headers={"Content-Type": "application/json", "X-Trace-ID": tid})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("text,tid", [
    ("stitch this request", "trace-fv-short"),
    ("fleet disaggregated long prompt " * 3, "trace-fv-disagg")])
def test_stitched_trace_over_http(served, text, tid):
    srv, fm = served
    _chat(srv.url, text, tid)
    body = _get(srv.url + f"/v1/traces/{tid}")
    local = [t.to_dict() for t in STORE.find(tid)]
    harvested = fleetview.harvest_for_trace(fm, tid, local)
    assert body == jfleetview.stitch(tid, local, harvested)
    tagged = {e["replica"] for e in body["waterfall"] if e["replica"]}
    pairs = {(e["replica"], e["name"]) for e in body["waterfall"]}
    assert ("", "route") in pairs and ("", "rpc") in pairs
    assert any(r.startswith("fvt/r") for r in tagged), tagged
    if "disagg" in tid:
        assert any(r.startswith("fvt/p") for r in tagged), tagged
    timeline = _get(srv.url + f"/debug/timeline/{tid}")
    assert set(timeline["fleet"]) == {"replicas", "waterfall"}
    assert timeline["fleet"]["waterfall"] == body["waterfall"]


def test_debug_fleet_flight_kv_and_usage_over_http(served):
    srv, fm = served
    _chat(srv.url, "one more request for the rings", "trace-fv-flight")
    out = _get(srv.url + "/debug/fleet/flight?limit=64")
    pane = out["models"]["fvt"]
    assert pane["count"] == len(pane["records"]) > 0
    assert all(r["replica"].startswith("fvt/") for r in pane["records"])
    ts = [r["ts_unix"] for r in pane["records"]]
    assert ts == sorted(ts)
    mine = fleetview.fleet_flight(fm, limit=64)
    theirs = jfleetview.fleet_flight(fm, limit=64)
    assert set(mine) == set(theirs) == set(pane)
    kv = _get(srv.url + "/debug/kv")["models"]["fvt"]
    assert set(kv) >= {"directory", "sibling_transfers", "migrations",
                       "tier"}
    usage = _get(srv.url + "/v1/usage?replicas=1")
    assert set(usage["replicas"]["fvt"]) == {r.id for r in
                                             fm.pool.members()}
    assert usage["replicas"]["fvt"]["fvt/r0"] == {"shared_ledger": True}
