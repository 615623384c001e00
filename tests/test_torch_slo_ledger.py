"""The port's SLO observatory and usage ledger against the JAX package's,
on the CPU.

  * both ``SLOTracker``s fed one seeded stream of finished requests under
    a fake clock give the same ``windows``, ``burn_rate``, shedding
    decisions (onset and hysteresis recovery), ``report`` and rendered
    burn-rate / shedding gauges; floats within 1e-9. The targets and
    knobs are read from the same ``LOCALAI_SLO_*`` variables;
  * both ledgers fed one seeded stream of finished requests and waste
    notes (an LRU small enough to evict) give the same ``snapshot``,
    ``goodput_totals``, ``usage_payload`` (lifetime and windowed rows) and
    rendered tenant / goodput / waste families; ``derive_tenant`` agrees
    and never leaks the key;
  * with an impossible TTFT target and ``LOCALAI_SLO_MIN_EVENTS`` small,
    both HTTP servers shed: the port answers 429 with the JAX server's
    ``Retry-After``, counts ``localai_requests_shed_total`` and the
    ``shed_total`` metrics key, and ``/v1/slo`` reports the shedding;
  * ``/v1/slo`` and ``/v1/usage`` answer with the JAX server's key sets
    and value types, and a keyed request lands in the hashed tenant's
    pane with the raw key in neither ``/v1/usage`` nor ``/metrics``.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")

from localai_tpu.api.server import AppState  # noqa: E402
from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.obs import ledger as jledger  # noqa: E402
from localai_tpu.obs import metrics as jmetrics  # noqa: E402
from localai_tpu.obs import slo as jslo  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.obs import ledger as tledger  # noqa: E402
from localai_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from localai_tpu_torch.obs import slo as tslo  # noqa: E402
from test_api import _ServerThread  # noqa: E402
from test_torch_flight import _close  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)


def _trackers(clock, **kw):
    return (tslo.SLOTracker(registry=tmetrics.Registry(),
                            clock=lambda: clock["now"], **kw),
            jslo.SLOTracker(registry=jmetrics.Registry(),
                            clock=lambda: clock["now"], **kw))


def _events(n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (str(rng.choice(["m1", "m2"])), float(rng.uniform(0.5, 9.0)),
               {"ttft_ms": float(rng.uniform(10, 400)),
                "tpot_ms": (None if rng.uniform() < 0.2
                            else float(rng.uniform(5, 60))),
                "e2e_ms": float(rng.uniform(100, 3000)),
                "queue_ms": float(rng.uniform(0, 80)),
                "error": bool(rng.uniform() < 0.05)})


def test_slo_windows_and_shedding_alike():
    clock = {"now": 5000.0}
    port, ref = _trackers(
        clock, targets={"ttft_ms": 200.0, "e2e_ms": 2500.0},
        burn_threshold=2.0, recover_burn=1.0, min_events=5,
        retry_after_s=17)
    decisions = []
    for model, dt, ev in _events(400, seed=3):
        clock["now"] += dt
        port.observe(model, **ev)
        ref.observe(model, **ev)
        d = (port.should_shed(model), ref.should_shed(model))
        assert d[0] == d[1], (clock["now"], model)
        decisions.append(d[0])
        for window in ("1m", "5m", "30m"):
            assert abs(port.burn_rate(model, window)
                       - ref.burn_rate(model, window)) <= 1e-9
    assert any(decisions) and not all(decisions)   # onset and recovery
    for model in ("m1", "m2"):
        _close(port.windows(model), ref.windows(model))
        if port.should_shed(model):
            assert port.shed(model) == ref.shed(model) == 17
    _close(port.report(), ref.report())
    port.export_gauges()
    ref.export_gauges()
    for fam in ("slo_burn_rate", "overload_shedding", "requests_shed"):
        assert getattr(port.registry, fam).render() == getattr(
            ref.registry, fam).render(), fam
    # silence: the windows slide past every event and shedding recovers
    clock["now"] += 4000.0
    assert port.shedding("m1") == ref.shedding("m1") is False
    _close(port.report(), ref.report())


def test_slo_no_targets_never_sheds():
    clock = {"now": 0.0}
    port, ref = _trackers(clock, targets={}, min_events=1)
    for model, dt, ev in _events(50, seed=1):
        clock["now"] += dt
        port.observe(model, **{**ev, "error": True})
        ref.observe(model, **{**ev, "error": True})
        assert port.should_shed(model) is ref.should_shed(model) is False
    _close(port.report(), ref.report())


@pytest.mark.parametrize("env", [
    {"LOCALAI_SLO_TTFT_P95_MS": "250", "LOCALAI_SLO_TPOT_P95_MS": "30",
     "LOCALAI_SLO_OBJECTIVE": "0.99", "LOCALAI_SLO_BURN_THRESHOLD": "3",
     "LOCALAI_SLO_RECOVER_BURN": "0.5", "LOCALAI_SLO_MIN_EVENTS": "2",
     "LOCALAI_SLO_RETRY_AFTER_S": "9"},
    {"LOCALAI_SLO_E2E_P95_MS": "x", "LOCALAI_SLO_QUEUE_P95_MS": "-1",
     "LOCALAI_SLO_MIN_EVENTS": "bad"},
], ids=["set", "garbage"])
def test_slo_knobs_from_the_environment(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = tslo.SLOTracker(), jslo.SLOTracker()
    for attr in ("targets", "objective", "burn_threshold", "recover_burn",
                 "min_events", "retry_after_s"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert tslo.env_targets() == jslo.env_targets()


def _ledger_feed(ledger, seed: int):
    rng = np.random.default_rng(seed)
    keys = [f"key-{i}" for i in range(7)]
    for i in range(120):
        tenant = tledger.derive_tenant(str(rng.choice(keys + [""])))
        reason = str(rng.choice(["stop", "length", "cancelled", "error",
                                 "weird"]))
        ledger.note_request(
            tenant=tenant, model=str(rng.choice(["a", "b", ""])),
            lane="interactive", reason=reason,
            tokens=int(rng.integers(-2, 200)),
            prompt_tokens=int(rng.integers(0, 500)),
            dispatch_ms=float(rng.uniform(-1, 900)),
            queue_wait_ms=float(rng.uniform(0, 50)),
            kv_block_s=tledger.kv_block_seconds(
                int(rng.integers(0, 500)), int(rng.integers(0, 200)),
                float(rng.uniform(0, 3)), 16))
        if i % 11 == 0:
            ledger.note_waste(
                str(rng.choice(["spec_rejected", "shed"])),
                model=str(rng.choice(["a", "b"])), tenant=tenant,
                tokens=int(rng.integers(0, 30)), requests=1)


def _usage_rows(payload: dict) -> dict:
    """A usage payload without its clock fields."""
    return {k: v for k, v in payload.items()
            if k not in ("start_time", "end_time", "coverage_start")}


def test_ledger_alike(monkeypatch):
    monkeypatch.setenv("LOCALAI_TENANT_MAX", "4")
    port, ref = tledger.TenantLedger(), jledger.TenantLedger()
    assert port.max_tenants == ref.max_tenants == 4
    for key in ("", "sk-secret", "another"):
        assert tledger.derive_tenant(key) == jledger.derive_tenant(key)
    assert tledger.derive_tenant("sk-secret").startswith("t-")
    _ledger_feed(port, 5)
    _ledger_feed(ref, 5)
    snap, jsnap = port.snapshot(), ref.snapshot()
    _close(snap, jsnap)
    assert snap["evictions_total"] > 0 and tledger.OVERFLOW in snap[
        "tenants"]
    for model in (None, "a", "b", "engine"):
        _close(port.goodput_totals(model), ref.goodput_totals(model))
    _close(_usage_rows(port.usage_payload()),
           _usage_rows(ref.usage_payload()))
    _close(_usage_rows(port.usage_payload(window=3600.0)),
           _usage_rows(ref.usage_payload(window=3600.0)))
    preg, jreg = tmetrics.Registry(), jmetrics.Registry()
    port.export(preg)
    ref.export(jreg)
    for fam in ("tenant_requests", "tenant_tokens", "tenant_prompt_tokens",
                "tenant_dispatch_ms", "tenant_queue_wait_ms",
                "tenant_kv_block_seconds", "tenant_lru_evictions",
                "goodput_tokens", "goodput_ratio", "waste_tokens",
                "waste_requests"):
        assert getattr(preg, fam).render() == getattr(jreg, fam).render(), \
            fam
    text = preg.render()
    assert "sk-secret" not in text and "key-1" not in text
    assert tledger.WASTE_REASONS == jledger.WASTE_REASONS
    assert tledger.FLIGHT_WASTE == jledger.FLIGHT_WASTE


# -- both HTTP servers ---------------------------------------------------------

MODEL = "slo-tiny"
KEY = "sk-slo-test-key"


def _models_dir(root):
    models = root / "models"
    models.mkdir()
    (models / f"{MODEL}.yaml").write_text(json.dumps({
        "name": MODEL, "model": "debug:tiny", "context_size": 128,
        "engine": ENGINE}))
    return models


def _call(url, method="GET", body=None, key=None):
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


CHAT = {"model": MODEL, "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "hi"}]}


@pytest.fixture
def shedding_servers(tmp_path, monkeypatch):
    """Both servers over one models dir with an impossible TTFT target,
    ``LOCALAI_SLO_MIN_EVENTS=2`` and a fresh process-wide tracker each
    (read from that environment), restored afterwards."""
    monkeypatch.setenv("LOCALAI_SLO_MIN_EVENTS", "2")
    monkeypatch.setattr(tslo, "SLO", tslo.SLOTracker())
    monkeypatch.setattr(jslo, "SLO", jslo.SLOTracker())
    models = _models_dir(tmp_path)
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu",
                                            slo_ttft_p95_ms=0.001),
                                  loader), "127.0.0.1", 0).start()
    jcfg = JaxAppConfig(model_path=str(models),
                        upload_path=str(tmp_path / "up"),
                        config_path=str(tmp_path / "conf"),
                        slo_ttft_p95_ms=0.001)
    jloader = JaxLoader(models)
    jloader.load_from_path(context_size=jcfg.context_size)
    ref = _ServerThread(AppState(jcfg, jloader))
    yield {"port": port.url, "ref": ref.base, "port_server": port}
    ref.stop()
    port.shutdown()


def test_both_servers_shed_alike(shedding_servers):
    got = {}
    for side in ("port", "ref"):
        url = shedding_servers[side]
        statuses = []
        for _ in range(3):
            s, body, h = _call(url + "/v1/chat/completions", "POST", CHAT)
            statuses.append(s)
            if s == 429:
                got[side] = (h.get("Retry-After"), json.loads(body))
        assert statuses == [200, 200, 429], (side, statuses)
    assert got["port"][0] == got["ref"][0] == "30"
    assert set(got["port"][1]) == set(got["ref"][1]) == {"error"}
    assert got["port"][1]["error"]["code"] == 429
    port = shedding_servers["port"]
    s, text, _ = _call(port + "/metrics")
    line = [x for x in text.splitlines() if x.startswith(
        "localai_requests_shed_total{") and f'model="{MODEL}"' in x]
    assert line and float(line[0].rsplit(" ", 1)[1]) == 1.0
    assert f'localai_overload_shedding{{model="{MODEL}"}} 1' in text
    m = json.loads(_call(port + "/backend/metrics")[1])[MODEL]
    assert m["shed_total"] == 1
    for side in ("port", "ref"):
        rep = json.loads(_call(shedding_servers[side] + "/v1/slo")[1])
        assert rep["models"][MODEL]["shedding"] is True
        assert rep["models"][MODEL]["shed_total"] == 1
        assert rep["targets"] == {"ttft_ms": 0.001}
        assert rep["min_events"] == 2
    # embeddings ride the same capacity: refused alike
    s, _, h = _call(port + "/v1/embeddings", "POST",
                    {"model": MODEL, "input": "x"})
    assert s == 429 and h["Retry-After"] == "30"


def _shape(d):
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_shape(v) for v in d[:1]]
    return type(d).__name__


@pytest.fixture(scope="module")
def keyed_servers(tmp_path_factory):
    """Both servers with one API key (no SLO target)."""
    root = tmp_path_factory.mktemp("usage")
    models = _models_dir(root)
    loader = ConfigLoader(models)
    loader.load_from_path()
    # the process-wide ledgers and trackers: this module's requests alone
    for obs in (tledger.LEDGER, jledger.LEDGER, tslo.SLO, jslo.SLO):
        obs.reset()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu", api_keys=[KEY]),
                                  loader), "127.0.0.1", 0).start()
    jcfg = JaxAppConfig(model_path=str(models), api_keys=[KEY],
                        upload_path=str(root / "up"),
                        config_path=str(root / "conf"))
    jloader = JaxLoader(models)
    jloader.load_from_path(context_size=jcfg.context_size)
    ref = _ServerThread(AppState(jcfg, jloader))
    for url in (port.url, ref.base):
        for _ in range(2):
            assert _call(url + "/v1/chat/completions", "POST", CHAT,
                         key=KEY)[0] == 200
    yield {"port": port.url, "ref": ref.base}
    ref.stop()
    port.shutdown()


@pytest.mark.parametrize("path", ["/v1/slo", "/v1/usage",
                                  "/v1/usage?window=600",
                                  "/v1/usage?since=0"])
def test_slo_and_usage_shapes_as_the_jax_server(keyed_servers, path):
    (s1, b1, _), (s2, b2, _) = [_call(keyed_servers[s] + path, key=KEY)
                                for s in ("port", "ref")]
    assert s1 == s2 == 200
    port, ref = json.loads(b1), json.loads(b2)
    if path == "/v1/slo":   # this module's model (the trackers are shared)
        assert _shape(port.pop("models")[MODEL]) == _shape(
            ref.pop("models")[MODEL])
    assert _shape(port) == _shape(ref)
    if path == "/v1/slo":
        counts = [json.loads(_call(keyed_servers[s] + path, key=KEY)[1])[
            "models"][MODEL]["windows"]["30m"]["count"]
            for s in ("port", "ref")]
        assert counts == [2, 2]


def test_usage_is_by_hashed_tenant(keyed_servers):
    tenant = tledger.derive_tenant(KEY)
    for side in ("port", "ref"):
        url = keyed_servers[side]
        s, body, _ = _call(url + "/v1/usage", key=KEY)
        assert s == 200 and KEY not in body
        rows = [r for r in json.loads(body)["data"] if r["model"] == MODEL]
        assert [r["tenant"] for r in rows] == [tenant], side
        assert rows[0]["requests"] == 2 and rows[0]["delivered_tokens"] > 0
        s, text, _ = _call(url + "/metrics", key=KEY)
        assert s == 200 and KEY not in text
        assert f'tenant="{tenant}"' in text
    assert _call(keyed_servers["port"] + "/v1/usage")[0] == 401
    assert _call(keyed_servers["port"] + "/v1/usage?window=x",
                 key=KEY)[0] == 400


def test_usage_flight_identity(keyed_servers):
    """goodput + cancelled + error tokens of the model equal the tokens
    its flight ring counted (the ledger's identity, on the port)."""
    body = json.loads(_call(keyed_servers["port"] + "/debug/flight",
                            key=KEY)[1])
    ring = body["models"][MODEL]["tokens_total"]
    g = tledger.LEDGER.goodput_totals(MODEL)
    assert g["flight_tokens"] == ring > 0
    assert math.isclose(g["goodput_ratio"], 1.0)
