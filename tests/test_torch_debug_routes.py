"""The port's ``/debug/*`` routes, ``/backend/trace`` and the program cost
catalog against the JAX server's, on the CPU.

Both HTTP servers run over one models dir (a tiny random checkpoint),
after the same greedy chat on each:

  * ``/debug/devices``, ``/programs``, ``/stacks``, ``/flight``,
    ``/anatomy``, ``/profiles``, ``/history``, ``/history/{series}`` and
    ``/kv`` answer 200 with the JAX server's key sets and value types
    (``/debug/programs``' rows: the keys both catalogs have; the port has
    no ``memory_analysis`` sizes), and a bad query parameter is a 400 on
    both; ``/debug/faults`` answers as the JAX server's (its site table
    and the supervisor status), and so does ``/debug/fleet/flight`` (no
    fleet-served model here; the fleets' own view is held in
    ``tests/test_torch_fleetview.py``);
  * the flight ring's records hold ``gap + sched + launch + sync <=
    dispatch_ms`` and their tokens sum to the tokens served;
  * ``/debug/devices``' census counts the runner's KV pool and weights
    byte for byte, and the probe succeeds;
  * ``POST /backend/trace`` writes a Chrome-trace JSON with the CPU ops of
    the engine thread's decode, and a second capture while one runs is a
    409;
  * the port's cost reckoning of a fresh contiguous prefill is held
    against the JAX catalog's ``cost_analysis`` of the same program at
    the same preset by the stated bands below (an intended divergence,
    recorded in ROADMAP: XLA counts intermediates and, in a scanned
    program, one loop body), and against its own formula exactly.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.manager import build_serving_model as jax_build  # noqa: E402
from localai_tpu.obs import compile as jcompile  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models.manager import (  # noqa: E402
    ModelManager,
    build_serving_model,
)
from localai_tpu_torch.obs import compile as tcompile  # noqa: E402
from localai_tpu_torch.obs import device as tdevice  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)
MODEL = "debug-routes-tiny"
CHAT = {"model": MODEL, "max_tokens": 12, "temperature": 0,
        "messages": [{"role": "user", "content": "hello there"}]}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("debug")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(3), cfg))
    models = root / "models"
    models.mkdir()
    (models / f"{MODEL}.yaml").write_text(yaml.safe_dump({
        "name": MODEL, "model": str(ckpt), "context_size": 128,
        "engine": ENGINE}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(
        model_path=str(models), device="cpu",
        backend_assets_path=str(root / "assets")), loader),
        "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    served = {}
    for side, url in (("port", port.url), ("ref", ref.base)):
        s, body, _ = _call(url + "/v1/chat/completions", "POST", CHAT)
        assert s == 200
        served[side] = json.loads(body)["usage"]["completion_tokens"]
        _call(url + "/metrics")   # a history tick
    yield {"port": port.url, "ref": ref.base, "served": served,
           "manager": port.manager}
    ref.stop()
    port.shutdown()


def _call(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def _both(servers, path):
    out = []
    for side in ("port", "ref"):
        s, body, _ = _call(servers[side] + path)
        assert s == 200, (side, path, body[:300])
        out.append(json.loads(body))
    return out


def _keys(d, depth=3):
    """Key sets and leaf types, dicts merged across list items."""
    if isinstance(d, dict):
        return {k: _keys(v, depth) for k, v in d.items()} if depth else \
            set(d)
    if isinstance(d, list):
        merged: dict = {}
        for x in d:
            if isinstance(x, dict):
                for k, v in x.items():
                    merged.setdefault(k, _keys(v, depth - 1))
        return [merged] if merged else ([type(d[0]).__name__] if d else [])
    return type(d).__name__


@pytest.mark.parametrize("path", ["/debug/devices?probe_timeout=30",
                                  "/debug/devices?probe=0", "/debug/stacks",
                                  "/debug/flight", "/debug/flight?limit=3",
                                  "/debug/anatomy", "/debug/anatomy?window=0",
                                  "/debug/profiles", "/debug/history",
                                  "/debug/kv"])
def test_debug_route_shapes_as_the_jax_server(servers, path):
    port, ref = _both(servers, path)
    if path.startswith("/debug/devices"):
        # the watchdog's channels are each process's own
        port.pop("watchdog")
        ref.pop("watchdog")
        assert port["roofline"]["source"] == ref["roofline"]["source"] == \
            "assumed"
    if path == "/debug/history":
        assert set(port) == set(ref)
        assert port["resolutions_s"] == ref["resolutions_s"]
        assert port["capacity"] == ref["capacity"]
        assert set(port["series"]) >= {f"occupancy.{MODEL}",
                                       f"tokens_generated.{MODEL}"}
        return
    if path == "/debug/stacks":
        assert _keys(port) == _keys(ref)
        return
    # keyed by model: this module's model on both
    for body in (port, ref):
        if "models" in body:
            assert set(body["models"]) == {MODEL}
    assert _keys(port) == _keys(ref)


def test_programs_as_the_jax_server(servers):
    port, ref = _both(servers, "/debug/programs")
    assert set(port) == set(ref) == {"roofline", "programs"}
    assert set(port["roofline"]) == set(ref["roofline"])
    rows, jrows = port["programs"], ref["programs"]
    assert {r["program"] for r in rows} >= {"decode_n", "prefill_chunk"}
    jkeys = set().union(*(set(r) for r in jrows if "flops" in r))
    pkeys = set().union(*(set(r) for r in rows if "flops" in r))
    # the JAX package's memory_analysis sizes have no port counterpart
    assert jkeys - pkeys <= {"argument_bytes", "output_bytes", "temp_bytes",
                             "generated_code_bytes"}
    assert pkeys <= jkeys
    decode = [r for r in rows if r["program"] == "decode_n"]
    assert decode and decode[0]["dispatch_seconds_ema"] > 0
    assert decode[0]["achieved_gbps"] > 0 and decode[0]["flops"] > 0
    _, body, _ = _call(servers["port"] + "/debug/programs?harvest=0")
    assert all("flops" not in r for r in json.loads(body)["programs"])


@pytest.mark.parametrize("path", [
    "/debug/flight?since=abc", "/debug/flight?limit=x",
    "/debug/anatomy?window=x", "/debug/devices?probe_timeout=0",
    "/debug/devices?probe_timeout=nan", "/debug/history/x?res=y",
    "/debug/history/nope"])
def test_bad_parameters_alike(servers, path):
    s1 = _call(servers["port"] + path)[0]
    s2 = _call(servers["ref"] + path)[0]
    assert s1 == s2 and s1 in (400, 404), (s1, s2)


def test_history_series_as_the_jax_server(servers):
    name = f"occupancy.{MODEL}"
    for res in (1, 10, 300):
        port, ref = _both(servers, f"/debug/history/{name}?res={res}")
        assert _keys(port) == _keys(ref)
        assert port["series"] == name and port["resolution_s"] == res


@pytest.mark.parametrize("path", ["/debug/fleet/flight", "/debug/faults"])
def test_unported_debug_routes_are_404(servers, path):
    """Both routes are ported now (the name is kept from when the port
    answered ``/debug/fleet/flight`` with 404): they answer 200 on both
    servers with the same keys. ``/debug/fleet/flight`` lists no model,
    the served one being a single engine; ``/debug/faults`` has the same
    injection-site table and the supervisor status of the served
    model."""
    port, ref = _both(servers, path)
    assert _keys(port) == _keys(ref)
    if path == "/debug/fleet/flight":
        assert port["models"] == ref["models"] == {}
        return
    assert port["sites"] == ref["sites"]
    assert port["active"] is ref["active"] is False
    assert port["armed"] == ref["armed"] == []
    assert _keys(port["supervisors"][MODEL]) == \
        _keys(ref["supervisors"][MODEL])


def test_flight_tiles_and_counts(servers):
    body = json.loads(_call(servers["port"] + "/debug/flight?limit=4096")[1])
    m = body["models"][MODEL]
    assert m["tokens_total"] == sum(r["tokens"] for r in m["records"]) == \
        servers["served"]["port"]
    for r in m["records"]:
        assert (r["gap_ms"] + r["sched_ms"] + r["launch_ms"]
                + r["sync_ms"]) <= r["dispatch_ms"] + 4e-3
    anat = json.loads(_call(servers["port"] + "/debug/anatomy?window=0")[1])
    a = anat["models"][MODEL]
    assert anat["phases"] == ["gap", "sched", "launch", "sync"]
    assert 0.0 <= a["host_overhead_fraction"] <= 1.0
    assert 0.0 <= a["device_bubble_fraction"] <= 1.0


def test_census_counts_the_runner(servers):
    body = json.loads(_call(servers["port"] + "/debug/devices")[1])
    sm = servers["manager"].get(MODEL)
    kv = sum(t.numel() * t.element_size()
             for t in (sm.runner.kv.k, sm.runner.kv.v))
    weights = sum(t.numel() * t.element_size() for t in
                  tdevice.known_arrays([sm.runner])["weights"])
    cats = body["census"]["by_category"]
    assert cats == {"kv_cache": kv, "weights": weights, "other": 0}
    assert body["probe"]["ok"] is True and body["probe"]["device"] == "cpu"
    assert body["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu",
                                "memory": None}]
    assert "engine:" + MODEL in body["watchdog"]


def test_backend_trace_captures_the_engine_thread(servers):
    url = servers["port"]
    stop = threading.Event()

    def chats():
        while not stop.is_set():
            _call(url + "/v1/chat/completions", "POST",
                  {**CHAT, "max_tokens": 30})

    t = threading.Thread(target=chats)
    t.start()
    results = {}

    def capture(name, seconds):
        results[name] = _call(url + "/backend/trace", "POST",
                              {"seconds": seconds, "dir": "traces"})

    try:
        first = threading.Thread(target=capture, args=("first", 1.5))
        first.start()
        time.sleep(0.5)
        capture("second", 0.2)   # while the first holds the lock
        first.join()
    finally:
        stop.set()
        t.join()
    s, body, _ = results["first"]
    assert s == 200, body
    out = json.loads(body)
    assert set(out) == {"trace_dir", "seconds"} and out["seconds"] == 1.5
    assert results["second"][0] == 409
    with open(out["trace_dir"] + "/trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the engine thread's eager decode: its matmuls show as CPU ops
    assert any("aten::" in n for n in names), sorted(names)[:20]
    assert _call(url + "/backend/trace", "POST",
                 {"seconds": 99})[0] == 400
    assert _call(url + "/backend/trace", "POST",
                 {"dir": "../../escape"})[0] == 400


# -- the cost reckoning against the JAX catalog --------------------------------

# port FLOPs / JAX FLOPs and port bytes / JAX bytes of the fresh prefill
# at debug:tiny and debug:small (measured 2.5–4.1 and 0.07–0.29): the
# port counts 2 x params x tokens + attention and weights + KV rows; XLA
# counts every operation's operands and results (intermediates included)
FLOPS_BAND = (1.0, 8.0)
BYTES_BAND = (0.01, 1.0)


@pytest.mark.parametrize("preset", ["debug:tiny", "debug:small"])
def test_prefill_cost_against_the_jax_catalog(preset):
    doc = {"name": f"cost-{preset[6:]}", "model": preset,
           "context_size": 256,
           "engine": {**ENGINE, "kv_paged": False, "max_slots": 4}}
    sm = build_serving_model(ModelConfig.from_dict(dict(doc)),
                             AppConfig(device="cpu"))
    jsm = jax_build(JaxModelConfig(**doc), JaxAppConfig())
    try:
        req = dict(prompt=list(b"a prompt for the cost model"),
                   max_new_tokens=4, temperature=0.0)
        sm.scheduler.generate(GenRequest(**req), 120)
        jsm.scheduler.generate(JaxGenRequest(**req), 120)

        def fresh_prefill(rows):
            return [r for r in rows if r["program"] == "prefill"][-1]

        port = fresh_prefill(tcompile.CATALOG.report())
        ref = fresh_prefill(jcompile.CATALOG.report())
        assert ref["statics"] == {"bucket": 128}
        # the port's own formula, independently
        r = sm.runner
        T, cfg = 128, r.cfg
        n_params, w_bytes = tcompile.matmul_weights(r.params)
        attn = 4 * cfg.num_layers * cfg.num_heads * cfg.hd * T
        row = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd * 4
        assert port["flops"] == (2 * n_params + attn) * T
        assert port["bytes_accessed"] == w_bytes + T * row
        fr = port["flops"] / ref["flops"]
        br = port["bytes_accessed"] / ref["bytes_accessed"]
        assert FLOPS_BAND[0] <= fr <= FLOPS_BAND[1], fr
        assert BYTES_BAND[0] <= br <= BYTES_BAND[1], br
    finally:
        sm.close()
        jsm.close()
