"""Elastic capacity of the PyTorch port's fleets against the JAX package, on
the CPU.

  * ``AutoscalePolicy.decide`` equals the JAX package's on every drawn
    input (hypothesis over replica signals, configs, clocks and the
    cooldown clocks a run of applied decisions leaves), and
    ``AutoscaleConfig.from_app`` reads the same settings and variables;
  * the density reaper and the memory fraction's override, as the JAX
    package's tests pin them;
  * the controller on an in-process fleet of the port: a queue burst
    scales out, every request completes, the idle fleet drains back in
    by migration to one replica whose retired peers' engines are
    stopped; scale-to-zero, then the cold start that serves the held
    request; the hot swap keeps capacity and serving.
"""

import dataclasses
import gc
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.config.app_config import AppConfig as JaxApp  # noqa: E402
from localai_tpu.fleet.autoscale import policy as jpolicy  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.fleet.autoscale import (  # noqa: E402
    ACTIONS,
    AutoscaleConfig,
    AutoscaleController,
    evict_lru_model,
    hbm_fraction,
    policy,
)
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

# -- the pure policy ------------------------------------------------------------

_STATES = ["healthy", "healthy", "healthy", "starting", "respawning", "dead"]

_signals = st.lists(st.builds(
    dict,
    state=st.sampled_from(_STATES),
    inflight=st.integers(0, 3),
    idle_s=st.sampled_from([0.0, 5.0, 59.9, 60.0, 130.0, 400.0]),
    queue_depth=st.sampled_from([0.0, 0.5, 3.9, 4.0, 9.0]),
    kv_util=st.sampled_from([0.0, 0.5, 0.85, 0.99]),
    step_p99_ms=st.sampled_from([0.0, 40.0, 250.0]),
    burn_1m=st.sampled_from([0.0, 1.9, 2.0, 7.0]),
    burn_5m=st.sampled_from([0.0, 3.0])), max_size=6)

_configs = st.builds(
    dict,
    min_replicas=st.integers(0, 3), max_replicas=st.integers(1, 5),
    in_idle_s=st.sampled_from([0.0, 60.0, 120.0]),
    zero_idle_s=st.sampled_from([0.0, 300.0]),
    out_queue_depth=st.sampled_from([0.0, 4.0]),
    out_kv_util=st.sampled_from([0.0, 0.85]),
    out_step_p99_ms=st.sampled_from([0.0, 200.0]),
    out_burn=st.sampled_from([0.0, 2.0]),
    out_cooldown_s=st.sampled_from([0.0, 30.0]),
    in_cooldown_s=st.sampled_from([0.0, 60.0]))


def _decisions(mod, cfg: dict, rounds: list) -> list:
    """Each round's decision, noting the applied ones as the controller
    does (so the cooldown clocks move)."""
    pol = mod.AutoscalePolicy(mod.AutoscaleConfig(**cfg))
    out = []
    for now, sigs in rounds:
        d = pol.decide([mod.ReplicaSignals(rid=f"m/r{i}", **s)
                        for i, s in enumerate(sigs)], now)
        out.append((d.action, d.reason, d.target, d.rid))
        if d.action != "none":
            pol.note(d.action, now)
    return out


@settings(max_examples=200, deadline=None)
@given(cfg=_configs,
       rounds=st.lists(st.tuples(st.floats(0.0, 1000.0), _signals),
                       min_size=1, max_size=5))
def test_decide_equals_the_jax_package(cfg, rounds):
    rounds = sorted(rounds, key=lambda r: r[0])
    assert _decisions(policy, cfg, rounds) == _decisions(jpolicy, cfg,
                                                         rounds)


@pytest.mark.parametrize("env", [
    {}, {"LOCALAI_AUTOSCALE_OUT_QUEUE": "2.5",
         "LOCALAI_AUTOSCALE_OUT_BURN": "nonsense",
         "LOCALAI_AUTOSCALE_OUT_KV": "0.5",
         "LOCALAI_AUTOSCALE_OUT_STEP_P99_MS": "120",
         "LOCALAI_AUTOSCALE_OUT_COOLDOWN_S": "3",
         "LOCALAI_AUTOSCALE_IN_COOLDOWN_S": "4",
         "LOCALAI_AUTOSCALE_COLD_TIMEOUT_S": "5",
         "LOCALAI_AUTOSCALE_HBM_THRESHOLD": "0.5"}])
def test_config_from_app_equals_the_jax_package(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fields = dict(autoscale_min=2, autoscale_max=6, autoscale_interval_s=1.5,
                  autoscale_in_idle_s=30.0, autoscale_zero_idle_s=300.0)
    got = AutoscaleConfig.from_app(AppConfig(**fields))
    want = jpolicy.AutoscaleConfig.from_app(JaxApp(**fields))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ACTIONS == jpolicy.ACTIONS


def test_app_fields_and_defaults_equal_the_jax_package(monkeypatch):
    names = [f.name for f in dataclasses.fields(AppConfig)
             if f.name.startswith(("fleet_", "autoscale"))]
    assert names
    for k in names:
        monkeypatch.delenv(f"LOCALAI_{k.upper()}", raising=False)
    mine, theirs = AppConfig.from_env(), JaxApp.from_env()
    for k in names:
        assert getattr(mine, k) == getattr(theirs, k), k
    monkeypatch.setenv("LOCALAI_FLEET_REPLICAS", "3")
    monkeypatch.setenv("LOCALAI_FLEET_BACKEND", "inprocess")
    monkeypatch.setenv("LOCALAI_AUTOSCALE", "1")
    monkeypatch.setenv("LOCALAI_AUTOSCALE_ZERO_IDLE_S", "12.5")
    mine, theirs = AppConfig.from_env(), JaxApp.from_env()
    for k in names:
        assert getattr(mine, k) == getattr(theirs, k), k


# -- density -------------------------------------------------------------------

class _StubModel:
    def __init__(self, last_used, busy=False):
        self.last_used, self.busy = last_used, busy


class _StubManager:
    def __init__(self, models):
        self._models = dict(models)
        self._lock = threading.RLock()
        self.shut = []

    def shutdown_model(self, name, *, force=False, wait=5.0):
        self.shut.append(name)
        self._models.pop(name, None)
        return True


def test_evict_lru_model_spares_keep_and_busy():
    mgr = _StubManager({"old": _StubModel(10.0), "mid": _StubModel(20.0),
                        "hot": _StubModel(30.0)})
    assert evict_lru_model(mgr, threshold=0.9, fraction=0.5) is None
    assert evict_lru_model(mgr, keep=("old",), threshold=0.9,
                           fraction=0.95) == "mid"
    mgr._models["busy"] = _StubModel(1.0, busy=True)
    assert evict_lru_model(mgr, keep=("old",), threshold=0.9,
                           fraction=0.95) == "hot"
    assert evict_lru_model(mgr, keep=("old",), threshold=0.9,
                           fraction=0.95) is None
    assert mgr.shut == ["mid", "hot"]


def test_hbm_fraction_override_and_cpu(monkeypatch):
    monkeypatch.setenv("LOCALAI_AUTOSCALE_HBM_FRACTION", "0.77")
    assert hbm_fraction() == pytest.approx(0.77)
    monkeypatch.setenv("LOCALAI_AUTOSCALE_HBM_FRACTION", "x")
    assert hbm_fraction() is None
    monkeypatch.delenv("LOCALAI_AUTOSCALE_HBM_FRACTION")
    if not torch.cuda.is_available():
        assert hbm_fraction() is None


# -- the controller on an in-process fleet ---------------------------------------

TINY = {"name": "tiny", "model": "debug:tiny", "context_size": 256,
        "parameters": {"temperature": 0.0, "max_tokens": 8},
        "engine": {"max_slots": 2, "prefill_buckets": [16, 32, 64, 128],
                   "dtype": "float32", "kv_dtype": "float32",
                   "kv_block_tokens": 16}}


def _fleet(replicas: int):
    """A port fleet of ``replicas`` decode engines, built by the manager's
    ``_load_fleet``."""
    mcfg = ModelConfig.from_dict(TINY)
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    mgr = ModelManager(AppConfig(device="cpu", fleet_replicas=replicas,
                                 fleet_backend="inprocess"), loader)
    return mgr, mgr._load_fleet(mcfg)


def _submit(fm, text, max_new=8):
    return fm.scheduler.submit(GenRequest(
        prompt=fm.tokenizer.encode(text), max_new_tokens=max_new,
        temperature=0.0))


def _tick_until(auto, pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        auto.tick()
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_controller_scales_out_under_burst_then_back_in():
    """Manual ticks: a queue burst scales a 1-replica fleet out, every
    request completes, and the idle fleet scales back in to one replica
    (never zero: single scale-in keeps the last one); the retired
    replicas' engines are stopped."""
    _, fm = _fleet(1)
    auto = AutoscaleController(fm, config=AutoscaleConfig(
        min_replicas=0, max_replicas=3, interval_s=0.1,
        in_idle_s=0.4, zero_idle_s=0.0, out_queue_depth=0.5,
        out_cooldown_s=0.2, in_cooldown_s=0.2))
    fm.autoscaler = auto
    pool = fm.pool
    try:
        handles = [_submit(fm, f"elastic burst prompt {i}")
                   for i in range(8)]
        assert _tick_until(auto, lambda: len(pool.healthy("decode")) >= 2)
        assert auto.decisions["scale_out"] >= 1
        grown = list(pool.members())
        runners = {r.id: weakref.ref(r.sm.runner) for r in grown
                   if r.sm is not None}
        for h in handles:
            h.result(timeout=120)
            assert h.finish_reason in ("stop", "length")
        assert _tick_until(auto, lambda: len(pool.healthy("decode")) == 1,
                           timeout=60.0)
        assert auto.decisions["scale_in"] >= 1
        for _ in range(10):
            auto.tick()
            time.sleep(0.1)
        assert len(pool.healthy("decode")) == 1
        assert auto.decisions["scale_to_zero"] == 0
        retired = [r for r in grown if r not in pool.members()]
        assert retired and all(r.sm is None and r.retired for r in retired)
        # nothing holds a retired engine: its weights and pool are freed
        gc.collect()
        assert all(runners[r.id]() is None for r in retired
                   if r.id in runners)
        snap = auto.snapshot()
        assert snap["enabled"] and snap["max"] == 3
        assert fm.fleet_status()["autoscale"]["decisions"]["scale_out"] >= 1
    finally:
        auto.stop()
        fm.close()


def test_controller_scale_to_zero_then_cold_start_serves():
    _, fm = _fleet(1)
    auto = AutoscaleController(fm, config=AutoscaleConfig(
        min_replicas=0, max_replicas=3, interval_s=0.1,
        in_idle_s=0.0, zero_idle_s=0.5, out_queue_depth=50.0,
        in_cooldown_s=0.2, cold_timeout_s=120.0))
    fm.autoscaler = auto
    pool = fm.pool
    try:
        h = _submit(fm, "one request so idle_s measures from real work")
        h.result(timeout=120)
        assert h.finish_reason in ("stop", "length")
        assert _tick_until(auto, lambda: not pool.healthy("decode"),
                           timeout=60.0)
        assert auto.decisions["scale_to_zero"] >= 1
        assert auto.decisions["scale_in"] == 0
        assert auto.target == 0
        h = _submit(fm, "the request that wakes the fleet back up")
        h.result(timeout=120)
        assert h.finish_reason in ("stop", "length")
        assert auto.decisions["cold_start"] >= 1
        assert len(pool.healthy("decode")) == 1 and auto.target >= 1
    finally:
        auto.stop()
        fm.close()


def test_hot_swap_replaces_generation_and_keeps_capacity():
    _, fm = _fleet(2)
    try:
        for h in [_submit(fm, f"warm the pool {i}") for i in range(2)]:
            h.result(timeout=120)
        old = {r.id: r for r in fm.pool.healthy("decode")}
        res = fm.swap(timeout=30.0)
        assert res["ok"], res
        now = {r.id for r in fm.pool.healthy("decode")}
        assert now and not (now & set(old))
        assert len(now) == len(old)
        assert all(r.sm is None for r in old.values())
        h = _submit(fm, "post-swap traffic still serves")
        h.result(timeout=120)
        assert h.finish_reason in ("stop", "length")
        # a checkpoint that does not boot aborts cleanly
        bad = fm.swap(checkpoint="debug:no-such-preset", timeout=5.0)
        assert not bad["ok"] and fm.config.model == "debug:tiny"
        assert {r.id for r in fm.pool.healthy("decode")} == now
    finally:
        fm.close()


def test_manager_attaches_the_autoscaler(monkeypatch):
    mcfg = ModelConfig.from_dict(TINY)
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    mgr = ModelManager(AppConfig(device="cpu", fleet_replicas=2,
                                 fleet_backend="inprocess", autoscale=True,
                                 autoscale_interval_s=60.0), loader)
    try:
        fm = mgr.get("tiny")
        assert fm.autoscaler is not None
        assert fm.scheduler.on_cold == fm.autoscaler.request_capacity
        assert fm.fleet_status()["autoscale"]["enabled"] is True
    finally:
        mgr.shutdown()
