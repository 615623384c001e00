"""The port's LocalAI routes and request wrapper against the JAX server's,
on the CPU.

Both HTTP servers run over one models dir (a tiny random checkpoint):

  * ``/healthz``, ``/version``, ``/`` (the JSON welcome), ``/v1/tokenize``
    and ``/tokenize`` and ``/system`` answer with the JAX server's status
    and body shape (the welcome lists the port's own routes; ``/system``
    lists the port's torch device where the JAX server lists its JAX
    devices);
  * ``/metrics`` is OpenMetrics text whose engine series are refreshed at
    scrape time: after the same chat on both servers, the request, TTFT
    and token series of that model agree;
  * every answer carries ``X-Trace-ID`` (the client's, else a new one);
    the engine's spans group under it at ``/v1/traces``,
    ``/v1/traces/{id}`` and ``/debug/timeline/{id}`` with the JAX server's
    body shapes; scrape and trace paths record no HTTP span; a streamed
    chat or completion marks ``first_sse_write`` on each choice's trace
    that streamed content, as the JAX server does;
  * ``localai_api_call_seconds`` is labelled with the route's pattern
    (never the raw URL), ``(unmatched)`` for an unknown path;
  * ``/backend/metrics``, ``/backend/monitor`` and ``/backend/shutdown``
    answer as the JAX server does.
"""

import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu_torch.api import server as tserver  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.obs import trace as ttrace  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)
MODEL = "routes-tiny"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("routes")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(5), cfg))
    models = root / "models"
    models.mkdir()
    (models / f"{MODEL}.yaml").write_text(yaml.safe_dump({
        "name": MODEL, "model": str(ckpt), "context_size": 128,
        "engine": ENGINE}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield {"port": port.url, "ref": ref.base}
    ref.stop()
    port.shutdown()


def _call(url, method="GET", body=None, headers=None):
    """(status, body text, headers)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def _both(servers, path, **kw):
    return [_call(servers[s] + path, **kw) for s in ("port", "ref")]


def _shape(d):
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_shape(v) for v in d[:1]]
    return type(d).__name__


@pytest.mark.parametrize("path", ["/healthz", "/version"])
def test_health_and_version_as_the_jax_server(servers, path):
    (s1, b1, _), (s2, b2, _) = _both(servers, path)
    assert s1 == s2 == 200 and json.loads(b1) == json.loads(b2)


def test_welcome_as_the_jax_server(servers):
    (s1, b1, _), (s2, b2, _) = _both(servers, "/",
                                     headers={"Accept": "application/json"})
    port, ref = json.loads(b1), json.loads(b2)
    assert s1 == s2 == 200
    assert set(port) == set(ref) == {"message", "models", "endpoints"}
    assert port["message"] == ref["message"] and port["models"] == ref[
        "models"] == [MODEL]
    # the port lists its own routes, each one the JAX server also serves
    assert port["endpoints"] == sorted(port["endpoints"])
    assert set(port["endpoints"]) <= set(ref["endpoints"])
    for path in ("/metrics", "/v1/traces/{trace_id}", "/v1/tokenize",
                 "/debug/timeline/{request_id}", "/system", "/v1/slo",
                 "/v1/usage", "/backend/trace", "/debug/devices",
                 "/debug/programs", "/debug/stacks", "/debug/flight",
                 "/debug/anatomy", "/debug/profiles", "/debug/history",
                 "/debug/history/{series}", "/debug/kv"):
        assert path in port["endpoints"]


@pytest.mark.parametrize("path", ["/v1/tokenize", "/tokenize"])
@pytest.mark.parametrize("body", [{"model": MODEL, "content": "hello"},
                                  {"prompt": "héllo wörld"}, {}])
def test_tokenize_as_the_jax_server(servers, path, body):
    (s1, b1, _), (s2, b2, _) = _both(servers, path, method="POST", body=body)
    assert s1 == s2 == 200
    assert json.loads(b1) == json.loads(b2)


def test_system_as_the_jax_server(servers):
    _call(servers["port"] + "/v1/tokenize", method="POST", body={})
    _call(servers["ref"] + "/v1/tokenize", method="POST", body={})
    (s1, b1, _), (s2, b2, _) = _both(servers, "/system")
    port, ref = json.loads(b1), json.loads(b2)
    assert s1 == s2 == 200
    assert _shape(port) == _shape(ref)
    for key in ("version", "loaded_models", "configured_models"):
        assert port[key] == ref[key]
    assert port["backends"] == ["torch"]
    assert port["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu",
                                "process_index": 0}]


CHAT = {"model": MODEL, "max_tokens": 6, "temperature": 0,
        "messages": [{"role": "user", "content": "hi"}]}


def _series(text, name):
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") and f'model="{MODEL}"' in line:
            labels, value = line.rsplit(" ", 1)
            out[labels] = float(value)
    return out


def test_metrics_scrape_as_the_jax_server(servers):
    """After the same greedy chat on both servers, the scrape's request,
    TTFT-count and token series of the model agree (counts from each
    server's own start; this module's chats are the only ones)."""
    before = [_call(servers[s] + "/metrics")[1] for s in ("port", "ref")]
    for s in ("port", "ref"):
        assert _call(servers[s] + "/v1/chat/completions", method="POST",
                     body=CHAT)[0] == 200
    (s1, t1, h1), (s2, t2, _) = _both(servers, "/metrics")
    assert s1 == s2 == 200 and h1["Content-Type"].startswith("text/plain")
    for name in ("localai_requests_total", "localai_ttft_seconds_count",
                 "localai_tokens_generated_total",
                 "localai_prompt_tokens_total",
                 "localai_decode_dispatches_total"):
        d = []
        for b, t in zip(before, (t1, t2)):
            old, new = _series(b, name), _series(t, name)
            d.append({k: v - old.get(k, 0.0) for k, v in new.items()})
        assert d[0] == d[1], name
        assert any(d[0].values()) or name == \
            "localai_decode_dispatches_total"
    assert "# TYPE localai_trace_ring_size gauge" in t1
    assert "localai_trace_ring_size 256" in t1


def test_trace_ids_and_trace_routes(servers):
    url = servers["port"]
    s, _, h = _call(url + "/v1/chat/completions", method="POST", body=CHAT,
                    headers={"X-Trace-ID": "trace-route-1"})
    assert s == 200 and h["X-Trace-ID"] == "trace-route-1"
    s, _, h = _call(url + "/v1/chat/completions", method="POST", body=CHAT,
                    headers={"X-Correlation-ID": "corr-7"})
    assert h["X-Trace-ID"] == "corr-7"
    _, _, h = _call(url + "/healthz")
    assert h["X-Trace-ID"].startswith("trace-")
    # the list: the engine's request trace and the HTTP span, one id
    body = json.loads(_call(url + f"/v1/traces?model={MODEL}&limit=500")[1])
    mine = [t for t in body["traces"] if t["trace_id"] == "trace-route-1"]
    assert [c["name"] for c in mine[0]["children"]] == [
        "queued", "admitted", "prefill", "decode", "drained"]
    http = json.loads(_call(url + "/v1/traces?kind=http&limit=500")[1])
    spans = [t for t in http["traces"] if t["trace_id"] == "trace-route-1"]
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"method": "POST",
                                 "path": "/v1/chat/completions",
                                 "status": 200}
    # scrape and trace paths record no HTTP span
    assert not [t for t in http["traces"] if t["attrs"]["path"] in (
        "/metrics", "/healthz", "/v1/traces", "/v1/traces/{trace_id}")]
    # one trace id: its traces and one waterfall of their spans
    s, b, _ = _call(url + "/v1/traces/trace-route-1")
    detail = json.loads(b)
    assert s == 200 and set(detail) == {"trace_id", "start_unix", "traces",
                                        "replicas", "waterfall"}
    assert {t["kind"] for t in detail["traces"]} == {"request", "http"}
    offsets = [e["offset_ms"] for e in detail["waterfall"]]
    assert offsets == sorted(offsets) and offsets[0] == 0.0
    s, b, _ = _call(url + "/debug/timeline/trace-route-1")
    tl = json.loads(b)
    assert s == 200 and set(tl) == {"request_id", "start_unix", "traces",
                                    "timeline"}
    assert [e["name"] for e in tl["timeline"]][0] == "http"
    assert _call(url + "/v1/traces/no-such-trace")[0] == 404
    assert _call(url + "/v1/traces?limit=x")[0] == 400


def test_trace_bodies_shaped_as_the_jax_server(servers):
    """The same chat with the same trace id on both servers: the list
    entry, the detail and the timeline have the JAX server's shapes."""
    for s in ("port", "ref"):
        _call(servers[s] + "/v1/chat/completions", method="POST", body=CHAT,
              headers={"X-Trace-ID": "trace-shape"})
    lists = [json.loads(b) for _, b, _ in _both(
        servers, "/v1/traces?kind=request&limit=500")]
    entries = [[t for t in x["traces"] if t["trace_id"] == "trace-shape"][0]
               for x in lists]
    assert _shape(entries[0]) == _shape(entries[1])
    for path in ("/v1/traces/trace-shape", "/debug/timeline/trace-shape"):
        (s1, b1, _), (s2, b2, _) = _both(servers, path)
        assert s1 == s2 == 200
        assert set(json.loads(b1)) == set(json.loads(b2))


STREAMED = {
    "chat": ("/v1/chat/completions", {**CHAT, "stream": True}),
    "chat-n2": ("/v1/chat/completions", {**CHAT, "stream": True, "n": 2,
                                         "temperature": 0.7, "seed": 3}),
    "completions-n2": ("/v1/completions", {
        "model": MODEL, "prompt": "count", "max_tokens": 6, "n": 2,
        "stream": True, "temperature": 0.7, "seed": 3}),
}


@pytest.mark.parametrize("kind", sorted(STREAMED))
def test_streamed_answer_marks_first_sse_write(servers, kind):
    """A streamed answer records ``first_sse_write`` on each choice's
    request trace once its first content frame was written, on both
    servers (the client's TTFT), after the engine's prefill."""
    path, body = STREAMED[kind]
    marks = []
    for s in ("port", "ref"):
        tid = f"sse-{kind}-{s}"
        status, text, _ = _call(servers[s] + path, method="POST", body=body,
                                headers={"X-Trace-ID": tid})
        assert status == 200 and "data: [DONE]" in text
        frames = [json.loads(line[6:]) for line in text.splitlines()
                  if line.startswith("data: {")]
        content = set()
        for f in frames:
            for c in f["choices"]:
                if (c.get("delta") or {}).get("content") or c.get("text"):
                    content.add(c["index"])
        detail = json.loads(_call(servers[s] + f"/v1/traces/{tid}")[1])
        reqs = [t for t in detail["traces"] if t["kind"] == "request"]
        assert len(reqs) == body.get("n", 1)
        names = [[c["name"] for c in t["children"]] for t in reqs]
        for n in names:
            if "first_sse_write" in n:
                assert n.count("first_sse_write") == 1
                assert n.index("first_sse_write") > n.index("prefill")
        marks.append((sorted(n.count("first_sse_write") for n in names),
                      len(content)))
    # every choice that streamed content is marked once, alike
    assert marks[0] == marks[1]
    assert sum(marks[0][0]) == marks[0][1] >= 1


def test_api_call_seconds_by_route_pattern(servers):
    url = servers["port"]
    _call(url + "/v1/traces/some-id-123")
    _call(url + "/no/such/route")
    text = _call(url + "/metrics")[1]
    paths = {line.split('path="')[1].split('"')[0]
             for line in text.splitlines()
             if line.startswith("localai_api_call_seconds_count")}
    assert "/v1/traces/{trace_id}" in paths and "(unmatched)" in paths
    assert not any("some-id-123" in p or "/no/such" in p for p in paths)


def test_trace_skip_lists_are_the_jax_servers():
    from localai_tpu.api import server as jserver

    assert tserver.TRACE_SKIP == jserver.TRACE_SKIP
    assert tserver.TRACE_SKIP_PREFIXES == jserver.TRACE_SKIP_PREFIXES
    assert tserver.AUTH_EXEMPT <= jserver.AUTH_EXEMPT


def test_backend_routes_as_the_jax_server(servers):
    for s in ("port", "ref"):
        _call(servers[s] + "/v1/chat/completions", method="POST", body=CHAT)
    (s1, b1, _), (s2, b2, _) = _both(servers, "/backend/metrics")
    assert s1 == s2 == 200 and set(json.loads(b1)) == set(json.loads(b2))
    (s1, b1, _), (s2, b2, _) = _both(servers, "/backend/monitor",
                                     method="POST", body={"model": MODEL})
    port, ref = json.loads(b1), json.loads(b2)
    assert s1 == s2 == 200 and port["loaded"] and ref["loaded"]
    for key in ("name", "busy", "age_seconds", "idle_seconds",
                "num_slots", "total_prompt_tokens"):
        assert type(port[key]) is type(ref[key])
    (s1, _, _), (s2, _, _) = _both(servers, "/backend/monitor",
                                   method="POST", body={})
    assert s1 == s2 == 400
    (s1, b1, _), (s2, b2, _) = _both(servers, "/backend/monitor",
                                     method="POST", body={"model": "nope"})
    assert json.loads(b1) == json.loads(b2) == {"loaded": False,
                                                "name": "nope"}
    (s1, b1, _), (s2, b2, _) = _both(servers, "/backend/shutdown",
                                     method="POST", body={"model": MODEL})
    assert s1 == s2 == 200 and json.loads(b1) == json.loads(b2) == {
        "shutdown": True, "model": MODEL}
    # the next request loads the model again
    assert _call(servers["port"] + "/v1/chat/completions", method="POST",
                 body=CHAT)[0] == 200


def test_store_is_the_process_store():
    """The routes read the same store the schedulers write."""
    from localai_tpu_torch.api import traces

    assert traces.STORE is ttrace.STORE
