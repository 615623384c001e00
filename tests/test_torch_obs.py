"""The port's telemetry (its obs package and the scheduler's feeds) against
the JAX package's, on the CPU.

  * the two registries hold the same families (the fleet's, the KV
    tier's and the autoscaler's included) and, fed the same observations
    (labels that need escaping included), render the same OpenMetrics
    text for each; ``update_engine_gauges`` fed one metrics dict (a host
    KV tier's keys included) gives the
    same series, the paged-kernel one-hot aside (the port's labels are
    kernel/torch where the JAX package's are pallas/lax);
  * ``RequestTrace.to_dict()`` and the trace store behave alike (shapes,
    per-kind rings, ``LOCALAI_TRACE_CAPACITY``, lookups by trace or
    request id);
  * one request served by each package's scheduler records the same span
    names in the same order, the same trace attributes and one TTFT,
    TPOT and queue-wait observation each;
  * ``Scheduler.metrics()`` has the JAX package's keys and value types on
    paged, contiguous and speculating engines, less the keys of
    subsystems the port has not yet (``UNPORTED_KEYS``, none now) and
    plus the port's constrained-decoding counters (``PORT_KEYS``);
  * the JSON log lines of two concurrent requests carry their own trace
    ids, and ``--log-format json`` installs the JSON formatter.
"""

import io
import json
import logging
import threading
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models.manager import build_serving_model as jax_build  # noqa: E402
from localai_tpu.obs import metrics as jmetrics  # noqa: E402
from localai_tpu.obs import trace as jtrace  # noqa: E402
from localai_tpu_torch.api import server as tserver  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models.manager import (  # noqa: E402
    ModelManager,
    build_serving_model,
)
from localai_tpu_torch.obs import logging as obs_logging  # noqa: E402
from localai_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from localai_tpu_torch.obs import trace as ttrace  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32")
# Scheduler.metrics() keys of the JAX package's subsystems the port does
# not have yet: none since the batch lane (batch_queue_depth, batch_slots)
# and self-healing (engine_state, rebuilds, nan_rows, quarantined_slots,
# kv_invariant_violations) came
UNPORTED_KEYS: set = set()
# families whose help names the port's machinery where the JAX package's
# names its own (a first call for an XLA compile, torch.profiler for
# jax.profiler, the allocator census for live jax arrays); name, type and
# labels are the JAX package's
PORT_HELP = {"localai_paged_kernel_impl", "localai_xla_compile_total",
             "localai_xla_compile_seconds_total",
             "localai_profiles_captured_total", "localai_hbm_live_bytes"}
# the port's own: constrained decoding's host cost
PORT_KEYS = {"frozen_dispatches", "constrained_tokens", "constraint_host_s"}


def _feed(reg):
    """The same observations into either package's registry."""
    reg.api_call.observe(0.003, method="POST", path="/v1/chat/completions")
    reg.api_call.observe(70.0, method="GET", path="/metrics")
    reg.ttft.observe(0.2, model='we"ird\\na\nme')
    reg.ttft.observe(3.0, model="m")
    reg.tpot.observe(0.004, model="m")
    reg.tpot.observe(0.0001, model="m")
    reg.queue_wait.observe(0.0, model="m")
    reg.requests.inc(model="m", finish_reason="stop")
    reg.requests.inc(2, model="m", finish_reason="length")
    reg.preemptions.inc(model="m", reason="cancelled")
    reg.tokens_generated.set_total(40, model="m")
    reg.tokens_generated.set_total(30, model="m")   # monotone: stays 40
    reg.batch_occupancy.set(0.5, model="m")
    reg.trace_ring_size.set(256)
    # the fleet's families (fleet, fleet.kveconomy, fleet.autoscale)
    for state in ("starting", "healthy", "dead", "respawning", "evicted"):
        reg.fleet_replicas.set(1 if state == "healthy" else 0, model="m",
                               state=state)
    reg.fleet_routed.inc(model="m", reason="affinity")
    reg.fleet_routed.inc(2, model="m", reason="failover")
    reg.fleet_prefix_transfers.inc(model="m")
    reg.fleet_prefix_transfer_bytes.inc(1 << 20, model="m")
    reg.fleet_directory_entries.set(3, model="m")
    reg.fleet_directory_hits.set_total(5, model="m")
    reg.fleet_directory_misses.set_total(2, model="m")
    reg.fleet_directory_drops.set_total(1, model="m")
    reg.fleet_sibling_transfers.inc(model="m")
    reg.fleet_sibling_transfer_bytes.inc(4096, model="m")
    reg.fleet_sibling_fallbacks.inc(model="m")
    reg.fleet_migrations.inc(model="m")
    reg.fleet_migration_fallbacks.inc(model="m")
    reg.fleet_respawn_backoff.set(1.25, model="m", replica="m/r0")
    reg.fleet_rpc_retries.inc(rpc="transfer_prefix")
    reg.fleet_rpc_deadlines.inc(model="m")
    reg.autoscale_decisions.inc(model="m", action="scale_out")
    reg.fleet_target_replicas.set(2, model="m")
    reg.model_swaps.inc(model="m")


def test_registries_render_alike():
    port, ref = tmetrics.Registry(), jmetrics.Registry()
    _feed(port)
    _feed(ref)
    theirs = {m.name: m for m in ref._all()}
    shared = [m for m in port._all() if m.name in theirs]
    assert len(shared) == len(port._all())   # every port family is theirs
    assert len(shared) == len(theirs)        # and every one of theirs
    for m in shared:
        if m.name in PORT_HELP:
            # the port's help names its own machinery: the samples agree
            assert m.render().split("\n")[1:] == theirs[m.name].render(
                ).split("\n")[1:] or m.name == "localai_paged_kernel_impl"
            continue
        assert m.render() == theirs[m.name].render(), m.name
        assert type(m).__name__ == type(theirs[m.name]).__name__
    # the exposition ends with a newline and holds the escaped label
    text = port.render()
    assert text.endswith("\n")
    assert 'model="we\\"ird\\\\na\\nme"' in text
    assert tmetrics._BUCKETS == jmetrics._BUCKETS
    assert tmetrics._TPOT_BUCKETS == jmetrics._TPOT_BUCKETS


METRICS_DICT = {
    "active_slots": [{"slot": 0}], "num_slots": 4, "occupancy": 0.25,
    "kv_utilization": 0.125, "kv_blocks_total": 64, "kv_blocks_free": 60,
    "kv_blocks_used": 4, "kv_blocks_cached": 2, "kv_overcommit_ratio": 1.0,
    "prefill_chunk_queue_depth": 3, "prefill_chunks": 9,
    "queue_depth": 2, "total_prompt_tokens": 100,
    "total_generated_tokens": 50, "prefix_tokens_reused": 16,
    "dispatches": 12, "prompt_cache": {"hits": 1, "misses": 3},
    "spec_acceptance_rate": 0.5, "spec_windows": 7, "spec_accept_rate": 0.4,
    "spec_draft_tokens": 20, "spec_accepted_tokens": 8,
    "spec_tokens_per_dispatch": 1.5, "shed_total": 2,
    "batch_queue_depth": 5, "batch_slots": 1, "engine_state": "serving",
    "rebuilds": 1, "nan_rows": 2, "quarantined_slots": 1,
    "kv_invariant_violations": 0,
    "step_ms_p50": 3.5, "step_ms_p99": 9.25,
    "host_overhead_fraction": 0.8125, "device_bubble_fraction": 0.625,
    "dispatch_phase_ms": {"gap": {"p50": 0.5, "p90": 1.0, "p99": 2.0},
                          "launch": {"p50": 20.0, "p90": 25.0, "p99": 30.0},
                          "sync": {"p50": 1.0, "p99": 3.0}},
    # a host KV tier under the pool (LOCALAI_KV_TIER_MB)
    "kv_tier_blocks": 7, "kv_tier_bytes": 7 << 20,
    "kv_tier_budget_bytes": 1 << 30, "kv_tier_spills": 9,
    "kv_tier_reloads": 2,
}


@pytest.mark.parametrize("impl,label", [("torch", "lax"),
                                        ("kernel", "pallas")])
def test_update_engine_gauges_alike(impl, label):
    port, ref = tmetrics.Registry(), jmetrics.Registry()
    tmetrics.update_engine_gauges("m", {**METRICS_DICT,
                                        "paged_attn_impl": impl}, port)
    jmetrics.update_engine_gauges("m", {**METRICS_DICT,
                                        "paged_attn_impl": label}, ref)
    theirs = {m.name: m for m in ref._all()}
    for m in port._all():
        if m.name in PORT_HELP:
            continue
        assert m.render() == theirs[m.name].render(), m.name
    # the one-hot, under the port's labels
    lines = [x for x in port.paged_kernel_impl.render().splitlines()
             if not x.startswith("#")]
    assert sorted(lines) == sorted([
        f'localai_paged_kernel_impl{{impl="kernel",model="m"}} '
        f'{1.0 if impl == "kernel" else 0.0}',
        f'localai_paged_kernel_impl{{impl="torch",model="m"}} '
        f'{1.0 if impl == "torch" else 0.0}'])


def _trace(mod):
    tr = mod.RequestTrace("t-1", "m-0", model="m", prompt_tokens=3)
    tr.begin("queued")
    tr.end("queued", seconds=0.1)
    tr.event("admitted", slot=1)
    tr.begin("prefill")
    tr.annotate(finish_reason="stop")
    return tr


def _shape(d):
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_shape(v) for v in d]
    return type(d).__name__


def test_request_trace_to_dict_alike():
    a, b = _trace(ttrace), _trace(jtrace)
    assert _shape(a.to_dict()) == _shape(b.to_dict())
    da, db = a.to_dict(), b.to_dict()
    for key in ("trace_id", "request_id", "kind", "model", "name",
                "finished", "attrs"):
        assert da[key] == db[key]
    assert [c["name"] for c in da["children"]] == ["queued", "admitted",
                                                   "prefill"]
    assert da["children"][2]["duration_ms"] is None   # still open


def test_trace_store_rings_and_lookups(monkeypatch):
    monkeypatch.setenv("LOCALAI_TRACE_CAPACITY", "3")
    port, ref = ttrace.TraceStore(), jtrace.TraceStore()
    assert port.capacity == ref.capacity == 3
    for store, mod in ((port, ttrace), (ref, jtrace)):
        for i in range(5):
            tr = mod.RequestTrace(f"t{i}", f"r{i}", kind="http")
            store.record(tr)
        live = store.start(mod.RequestTrace("tx", "rx"))
        store.finish(store.start(mod.RequestTrace("ty", "ry")))
        assert [t.trace_id for t in store.recent(kind="http")] == [
            "t4", "t3", "t2"]   # one bounded ring per kind
        assert [t.request_id for t in store.find("rx")] == ["rx"]
        assert live.finished is False
    monkeypatch.setenv("LOCALAI_TRACE_CAPACITY", "x")
    assert ttrace.default_capacity() == jtrace.default_capacity() == 256


# -- one served request through each package's scheduler ----------------------


@pytest.fixture(scope="module")
def engines():
    """Port and JAX serving models from one YAML document per mode: paged,
    contiguous, and paged with speculation."""
    out = {}
    for mode, extra in (("paged", {"spec": False}),
                        ("contiguous", {"spec": False, "kv_paged": False}),
                        ("spec", {"spec": True})):
        doc = {"name": f"obs-{mode}", "model": "debug:tiny",
               "context_size": 128, "engine": {**ENGINE, **extra}}
        sm = build_serving_model(ModelConfig.from_dict(dict(doc)),
                                 AppConfig(device="cpu"))
        jsm = jax_build(JaxModelConfig(**doc), JaxAppConfig())
        out[mode] = (sm, jsm)
    yield out
    for sm, jsm in out.values():
        sm.close()
        jsm.close()


def _serve_one(sched, req_cls):
    h = sched.submit(req_cls(prompt=list(b"hello there"), max_new_tokens=6,
                             temperature=0.0, correlation_id="cid-1",
                             trace_id="trace-x"))
    h.result(120)
    # the trace is retired before the handle finishes
    return h


@pytest.mark.parametrize("mode", ["paged", "contiguous", "spec"])
def test_one_request_records_the_same_spans(engines, mode):
    sm, jsm = engines[mode]
    h, jh = _serve_one(sm.scheduler, GenRequest), _serve_one(
        jsm.scheduler, JaxGenRequest)
    a, b = h.trace.to_dict(), jh.trace.to_dict()
    names = [c["name"] for c in a["children"]]
    assert names == [c["name"] for c in b["children"]] == [
        "queued", "admitted", "prefill", "decode", "drained"]
    assert _shape(a) == _shape(b)
    assert a["trace_id"] == b["trace_id"] == "trace-x"
    assert a["finished"] and b["finished"]
    assert set(a["attrs"]) == set(b["attrs"])
    for key in ("finish_reason", "completion_tokens", "prompt_tokens"):
        assert a["attrs"][key] == b["attrs"][key]
    # each child's attributes carry the same keys (prefill: path and
    # reused prefix; decode: tokens; drained: finish reason)
    assert [sorted(c.get("attrs", {})) for c in a["children"]] == [
        sorted(c.get("attrs", {})) for c in b["children"]]
    assert a["children"][2]["attrs"]["path"] == b["children"][2][
        "attrs"]["path"]


def _count(reg, fam, model):
    text = getattr(reg, fam).render()
    return sum(float(x.rsplit(" ", 1)[1]) for x in text.splitlines()
               if x.startswith(getattr(reg, fam).name + "_count")
               and f'model="{model}"' in x)


def test_latency_histograms_are_observed_once_a_request(engines):
    sm, _ = engines["paged"]
    name = sm.name
    before = {f: _count(tmetrics.REGISTRY, f, name)
              for f in ("ttft", "tpot", "queue_wait")}
    _serve_one(sm.scheduler, GenRequest)
    after = {f: _count(tmetrics.REGISTRY, f, name)
             for f in ("ttft", "tpot", "queue_wait")}
    assert {f: after[f] - before[f] for f in after} == {
        "ttft": 1, "tpot": 1, "queue_wait": 1}


def _types(m):
    return {k: type(v).__name__ for k, v in m.items()}


@pytest.mark.parametrize("mode", ["paged", "contiguous", "spec"])
def test_scheduler_metrics_keys_and_types_alike(engines, mode):
    sm, jsm = engines[mode]
    _serve_one(sm.scheduler, GenRequest)
    _serve_one(jsm.scheduler, JaxGenRequest)
    m, jm = sm.scheduler.metrics(), jsm.scheduler.metrics()
    assert set(m) == (set(jm) - UNPORTED_KEYS) | PORT_KEYS
    for k in set(m) & set(jm):
        if k == "prompt_cache":
            continue
        assert type(m[k]) is type(jm[k]), (k, m[k], jm[k])
    # the totals agree on one greedy request of the same weights' shape
    assert m["total_prompt_tokens"] > 0
    assert m["total_generated_tokens"] > 0 and m["preemptions"] == 0
    if mode != "contiguous":
        assert m["paged_attn_impl"] == "torch" and jm[
            "paged_attn_impl"] == "lax"
        assert m["prefill_chunks"] >= 1


def test_active_slots_are_the_jax_package_dicts(engines):
    """A request still decoding is listed as the JAX package lists it."""
    sm, jsm = engines["paged"]
    got = {}
    for name, sched, cls in (("port", sm.scheduler, GenRequest),
                             ("ref", jsm.scheduler, JaxGenRequest)):
        h = sched.submit(cls(prompt=list(b"a long one"), max_new_tokens=100,
                             temperature=0.0, ignore_eos=True,
                             correlation_id="cid-2"))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            active = sched.metrics()["active_slots"]
            if active:
                got[name] = active
                break
            time.sleep(0.005)
        h.cancel()
        h.result(60)
    assert _shape(got["port"]) == _shape(got["ref"])
    assert got["port"][0]["correlation_id"] == "cid-2"


# -- JSON logs ---------------------------------------------------------------


@pytest.fixture
def json_log():
    """The server's logger at DEBUG into a buffer, one JSON object a line
    (the access log of every request is written from its handler
    thread)."""
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(obs_logging.JsonFormatter())
    lg = logging.getLogger(tserver.__name__)
    level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.DEBUG)
    yield buf
    lg.removeHandler(handler)
    lg.setLevel(level)


def test_concurrent_requests_log_their_own_trace_ids(tmp_path, json_log):
    models = tmp_path / "models"
    models.mkdir()
    (models / "t.yaml").write_text(json.dumps({
        "name": "t", "model": "debug:tiny", "context_size": 128,
        "engine": {**ENGINE, "spec": False}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    srv = APIServer(ModelManager(AppConfig(model_path=str(models),
                                           device="cpu"), loader),
                    "127.0.0.1", 0).start()
    try:
        bodies = {"/v1/chat/completions": {
            "model": "t", "max_tokens": 24, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]},
            "/v1/completions": {"model": "t", "max_tokens": 24,
                                "temperature": 0, "prompt": "hello"}}
        ids = {"/v1/chat/completions": "trace-aaa",
               "/v1/completions": "trace-bbb"}
        barrier = threading.Barrier(2)
        got = {}

        def call(path):
            req = urllib.request.Request(
                srv.url + path, data=json.dumps(bodies[path]).encode(),
                headers={"X-Trace-ID": ids[path]})
            barrier.wait()
            with urllib.request.urlopen(req, timeout=120) as r:
                got[path] = r.headers["X-Trace-ID"]

        threads = [threading.Thread(target=call, args=(p,)) for p in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == ids
    finally:
        srv.shutdown()
    lines = [json.loads(x) for x in json_log.getvalue().splitlines()]
    access = {}
    for rec in lines:
        for path in ids:
            if f'"POST {path} ' in rec["message"]:
                access[path] = rec.get("trace_id")
    assert access == ids


def test_log_format_json_installs_the_formatter(capsys):
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        assert cli.main(["--log-format", "json", "version"]) == 0
        assert isinstance(root.handlers[0].formatter,
                          obs_logging.JsonFormatter)
        token = obs_logging.bind_trace_id("trace-zzz")
        try:
            line = root.handlers[0].formatter.format(logging.LogRecord(
                "x", logging.INFO, __file__, 1, "hello %s", ("you",),
                None))
        finally:
            obs_logging.unbind_trace_id(token)
        rec = json.loads(line)
        assert rec["message"] == "hello you" and rec["level"] == "info"
        assert rec["trace_id"] == "trace-zzz"
        assert cli.main(["--log-format", "text", "version"]) == 0
        assert not isinstance(root.handlers[0].formatter,
                              obs_logging.JsonFormatter)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    assert capsys.readouterr().out.splitlines() == ["0.1.0", "0.1.0"]
