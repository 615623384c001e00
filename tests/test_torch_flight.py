"""The port's flight recorder and dispatch anatomy against the JAX
package's, on the CPU.

  * both ``FlightRecorder``s fed one seeded stream of records (explicit
    timestamps, so the clock is fake) give the same ``snapshot`` (with
    ``since`` and ``limit``, across the ring's wraparound), the same
    ``percentiles`` and ``phases`` over the ring and over a window, and
    ``anatomy.summarize`` / ``phase_quantiles`` / ``breakdown`` give the
    same dicts; floats within 1e-9. ``ts_unix`` is left out of the
    comparison: each package anchors its own wall clock at import;
  * ``LOCALAI_FLIGHT_CAPACITY`` sizes both rings alike;
  * a greedy ``debug:tiny`` serve through both packages' schedulers
    (paged and contiguous, no speculation) writes records with the same
    program, ``steps`` and ``tokens`` columns, whose tokens sum to the
    tokens served; ``gap + sched + launch + sync <= dispatch_ms`` holds
    for every port record; the usage ledger classifies the requests alike
    (goodput and a cancelled request), and its flight identity holds on
    the port;
  * ``Scheduler.metrics()`` carries the flight and anatomy keys.
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models.manager import build_serving_model as jax_build  # noqa: E402
from localai_tpu.obs import anatomy as janatomy  # noqa: E402
from localai_tpu.obs import flight as jflight  # noqa: E402
from localai_tpu.obs import ledger as jledger  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models.manager import build_serving_model  # noqa: E402
from localai_tpu_torch.obs import anatomy as tanatomy  # noqa: E402
from localai_tpu_torch.obs import flight as tflight  # noqa: E402
from localai_tpu_torch.obs import ledger as tledger  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

PROGRAMS = ("decode", "decode_n", "spec", "prefill_chunk", "decode_frozen_n")


def _stream(n: int, seed: int) -> list[dict]:
    """``n`` seeded record kwargs with increasing timestamps."""
    rng = np.random.default_rng(seed)
    out, ts = [], 1000.0
    for i in range(n):
        ts += float(rng.uniform(0.001, 0.05))
        program = PROGRAMS[int(rng.integers(len(PROGRAMS)))]
        steps = 0 if program == "prefill_chunk" else int(
            rng.integers(1, 17))
        ms = float(rng.uniform(1.0, 40.0))
        ph = rng.dirichlet(np.ones(5)) * ms   # the fifth part is untiled
        rec = dict(program=program, steps=steps, dispatch_ms=ms,
                   occupancy=float(rng.uniform()),
                   queue_depth=int(rng.integers(0, 5)),
                   kv_utilization=float(rng.uniform()),
                   tokens=int(rng.integers(0, 20)),
                   preemptions=int(rng.integers(0, 3)),
                   spec_accept=(float(rng.uniform()) if program == "spec"
                                else None),
                   spec_proposed=int(rng.integers(0, 8)),
                   spec_accepted=int(rng.integers(0, 4)),
                   compile=bool(rng.uniform() < 0.1), ts=ts,
                   batch_slots=0, gap_ms=float(ph[0]),
                   sched_ms=float(ph[1]), launch_ms=float(ph[2]),
                   sync_ms=float(ph[3]))
        if i % 9 == 4:   # a record whose writer attributed no phase
            for k in ("gap_ms", "sched_ms", "launch_ms", "sync_ms"):
                rec[k] = 0.0
        out.append(rec)
    return out


def _close(a, b, path="") -> None:
    """Equal structures; floats within 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-9, (
            path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _fed(capacity: int, n: int, seed: int):
    port, ref = tflight.FlightRecorder(capacity), jflight.FlightRecorder(
        capacity)
    for rec in _stream(n, seed):
        port.record(**rec)
        ref.record(**rec)
    return port, ref


def _no_wall(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "ts_unix"} for r in rows]


@pytest.mark.parametrize("capacity,n", [(64, 40), (64, 200), (512, 513)],
                         ids=["partial", "wrapped", "one-past"])
def test_snapshot_and_percentiles_alike(capacity, n):
    port, ref = _fed(capacity, n, seed=capacity + n)
    assert port.count == ref.count == n
    assert port.total_tokens == ref.total_tokens
    _close(_no_wall(port.snapshot()), _no_wall(ref.snapshot()))
    mid = port.snapshot()[len(port.snapshot()) // 2]["ts"]
    for kw in ({"since": mid}, {"limit": 7}, {"since": mid, "limit": 3}):
        _close(_no_wall(port.snapshot(**kw)), _no_wall(ref.snapshot(**kw)))
    last = port.snapshot()[-1]["ts"]
    for window in (None, 0.5, 5.0):
        _close(port.percentiles(window_s=window, now=last),
               ref.percentiles(window_s=window, now=last))
        _close(port.phases(window_s=window, now=last),
               ref.phases(window_s=window, now=last))


@pytest.mark.parametrize("window", [None, 1.0, 60.0])
def test_anatomy_alike(window):
    port, ref = _fed(128, 300, seed=7)
    now = port.snapshot()[-1]["ts"]
    s1 = tanatomy.summarize(port, window_s=window, now=now)
    s2 = janatomy.summarize(ref, window_s=window, now=now)
    _close(s1, s2)
    _close(tanatomy.phase_quantiles(s1), janatomy.phase_quantiles(s2))
    b1 = tanatomy.breakdown(port, window_s=window, now=now)
    b2 = janatomy.breakdown(ref, window_s=window, now=now)
    # the phase definitions read the port's launch phase; the rest agrees
    d1, d2 = b1.pop("definitions"), b2.pop("definitions")
    assert set(d1) == set(d2) == set(tanatomy.PHASES)
    _close(b1, b2)
    assert tanatomy.PHASES == janatomy.PHASES
    assert tanatomy.QUANTILES == janatomy.QUANTILES
    assert tanatomy.DEFAULT_WINDOW_S == janatomy.DEFAULT_WINDOW_S


def test_empty_ring_alike():
    port, ref = tflight.FlightRecorder(8), jflight.FlightRecorder(8)
    _close(port.percentiles(), ref.percentiles())
    _close(port.phases(), ref.phases())
    _close(tanatomy.breakdown(port, window_s=None),
           {**janatomy.breakdown(ref, window_s=None),
            "definitions": tanatomy.PHASE_HELP})
    assert port.snapshot() == ref.snapshot() == []


@pytest.mark.parametrize("env,want", [("17", 17), ("x", 512), ("0", 1)])
def test_capacity_from_the_environment(monkeypatch, env, want):
    monkeypatch.setenv("LOCALAI_FLIGHT_CAPACITY", env)
    assert tflight.FlightRecorder().capacity == \
        jflight.FlightRecorder().capacity == want


# -- one served request through each package's scheduler ----------------------

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)


@pytest.fixture(scope="module")
def engines():
    out = {}
    for mode, extra in (("paged", {}), ("contiguous", {"kv_paged": False})):
        doc = {"name": f"flight-{mode}", "model": "debug:tiny",
               "context_size": 128, "engine": {**ENGINE, **extra}}
        sm = build_serving_model(ModelConfig.from_dict(dict(doc)),
                                 AppConfig(device="cpu"))
        jsm = jax_build(JaxModelConfig(**doc), JaxAppConfig())
        out[mode] = (sm, jsm)
    yield out
    for sm, jsm in out.values():
        sm.close()
        jsm.close()


def _serve(sched, cls, prompts, tenant) -> list:
    """Requests one after another (each alone in the engine, so the
    dispatch sequence is the scheduler's own, not a race)."""
    handles = []
    for i, prompt in enumerate(prompts):
        h = sched.submit(cls(prompt=prompt, max_new_tokens=20 + 7 * i,
                             temperature=0.0, ignore_eos=True,
                             tenant=tenant))
        h.result(120)
        handles.append(h)
        # the trailing in-flight dispatch drains after the release
        deadline = time.monotonic() + 30
        while sched.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
    return handles


PROMPTS = [list(b"hello flight recorder"), list(b"x" * 40), list(b"ab")]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_served_records_alike(engines, mode):
    sm, jsm = engines[mode]
    tenant = tledger.derive_tenant("flight-key")
    assert tenant == jledger.derive_tenant("flight-key")
    n0, jn0 = sm.scheduler.flight.count, jsm.scheduler.flight.count
    hs = _serve(sm.scheduler, GenRequest, PROMPTS, tenant)
    jhs = _serve(jsm.scheduler, JaxGenRequest, PROMPTS, tenant)
    # (each package draws the debug preset's weights its own way: the
    # columns depend on the request lengths, not on the tokens)
    assert [h.completion_tokens for h in hs] == [
        h.completion_tokens for h in jhs]
    rows = sm.scheduler.flight.snapshot()[n0:]
    jrows = jsm.scheduler.flight.snapshot()[jn0:]
    cols = ("program", "steps", "tokens", "compile")
    assert [tuple(r[c] for c in cols) for r in rows] == [
        tuple(r[c] for c in cols) for r in jrows]
    served = sum(h.completion_tokens for h in hs)
    assert sum(r["tokens"] for r in rows) == served
    for r in rows:   # the phases tile the record's wall (rounded to µs)
        assert (r["gap_ms"] + r["sched_ms"] + r["launch_ms"]
                + r["sync_ms"]) <= r["dispatch_ms"] + 4e-3, r
        assert min(r["gap_ms"], r["sched_ms"], r["launch_ms"],
                   r["sync_ms"]) >= 0.0
    assert any(r["launch_ms"] > 0 for r in rows if r["steps"])
    assert any(r["sync_ms"] > 0 for r in rows if r["steps"]) or \
        mode == "contiguous"


def test_ledger_classes_and_flight_identity(engines):
    sm, jsm = engines["paged"]
    tledger.LEDGER.reset()
    jledger.LEDGER.reset()
    tenant = tledger.derive_tenant("k")
    total0 = sm.scheduler.flight.total_tokens
    _serve(sm.scheduler, GenRequest, PROMPTS[:2], tenant)
    _serve(jsm.scheduler, JaxGenRequest, PROMPTS[:2], tenant)
    for sched, cls in ((sm.scheduler, GenRequest),
                       (jsm.scheduler, JaxGenRequest)):
        h = sched.submit(cls(prompt=list(b"cancel me"), max_new_tokens=100,
                             temperature=0.0, ignore_eos=True,
                             tenant=tenant))
        deadline = time.monotonic() + 60
        while h.completion_tokens < 3 and time.monotonic() < deadline:
            time.sleep(0.002)
        h.cancel()
        h.result(60)
        while sched.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
    snap, jsnap = tledger.LEDGER.snapshot(), jledger.LEDGER.snapshot()
    assert set(snap["tenants"]) == set(jsnap["tenants"]) == {tenant}
    assert set(snap["waste"]) == set(jsnap["waste"]) == {
        f"cancelled/{sm.name}"}
    assert snap["goodput_tokens"] == jsnap["goodput_tokens"]
    panes = snap["tenants"][tenant]
    assert set(panes) == set(jsnap["tenants"][tenant]) == {
        f"{sm.name}/interactive"}
    assert panes[f"{sm.name}/interactive"]["requests"] == 3
    # goodput + cancelled + error == the tokens the ring counted
    g = tledger.LEDGER.goodput_totals(sm.name)
    assert g["flight_tokens"] == sm.scheduler.flight.total_tokens - total0
    jg = jledger.LEDGER.goodput_totals(jsm.name)
    assert set(g) == set(jg)
    assert g["delivered_tokens"] == jg["delivered_tokens"]


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_metrics_carry_flight_and_anatomy(engines, mode):
    sm, jsm = engines[mode]
    _serve(sm.scheduler, GenRequest, PROMPTS[:1], "")
    _serve(jsm.scheduler, JaxGenRequest, PROMPTS[:1], "")
    m, jm = sm.scheduler.metrics(), jsm.scheduler.metrics()
    for k in ("step_ms_p50", "step_ms_p99", "host_overhead_fraction",
              "device_bubble_fraction"):
        assert type(m[k]) is type(jm[k]) is float, k
    assert set(m["dispatch_phase_ms"]) == set(jm["dispatch_phase_ms"])
    assert m["shed_total"] == 0
    assert 0.0 <= m["host_overhead_fraction"] <= 1.0
