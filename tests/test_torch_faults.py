"""Fault injection and self-healing of the PyTorch port against the JAX
package, on the CPU.

Mirrors ``tests/test_faults.py`` case for case where a case applies to the
port, each held against the JAX package on the same inputs:

  * the registry: the same parse results and refusals, the same
    ``snapshot()`` hit and fire counts for a seeded schedule of fire calls,
    the same env install;
  * block-pool invariants and injected exhaustion on both allocators;
  * a NaN row (``decode.nan``): the poisoned request fails, the co-batched
    greedy stream is byte-equal across both packages and to the run
    without the fault, and the slot is released after the same number of
    dispatches;
  * a stall (``engine.drain`` hang past the watchdog's deadline): a
    rebuild, the queued requests resumed with equal tokens on both
    packages, the rebuilt pool on new storage; exhaustion → ``failed``
    with a fast-failing ``submit`` and the same backoff schedule under a
    fake sleep;
  * the abandoned engine thread exits without launching on the new state;
  * ``SpecEngine.supports_rebuild``, its ``reinit``, and a ``spec.draft``
    garble that leaves greedy output equal to speculation off;
  * the disarmed path reading one module boolean;
  * the ten metric families of faults and the batch lane against the JAX
    registry.

The debug preset's weights are drawn by ``jax.random.key(0)`` in float32
and carried across with ``models.llama.params_from_numpy``. Clocks are
bounded: watchdog deadlines of 0.4 s, hangs of 1.5–2 s, every wait at
most 60 s.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from localai_tpu import faults as jfaults  # noqa: E402
from localai_tpu.engine.paged import BlockAllocator as JaxAllocator  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.obs import metrics as jmetrics  # noqa: E402
from localai_tpu.obs.engine import EngineTelemetry as JaxTelemetry  # noqa: E402
from localai_tpu.obs.slo import SLOTracker as JaxSLO  # noqa: E402
from localai_tpu.obs.trace import TraceStore as JaxStore  # noqa: E402
from localai_tpu.obs.watchdog import Watchdog as JaxWatchdog  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch import faults  # noqa: E402
from localai_tpu_torch.engine.paged import BlockAllocator  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.faults import (  # noqa: E402
    EngineSupervisor,
    FaultInjected,
    FaultSpec,
)
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from localai_tpu_torch.obs.engine import EngineTelemetry  # noqa: E402
from localai_tpu_torch.obs.slo import SLOTracker  # noqa: E402
from localai_tpu_torch.obs.trace import TraceStore  # noqa: E402
from localai_tpu_torch.obs.watchdog import StallEvent, Watchdog  # noqa: E402
from localai_tpu_torch.spec import NGramDrafter, SpecEngine  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

RUNNER_KW = dict(num_slots=4, max_ctx=256, prefill_buckets=[16, 32],
                 kv_dtype="float32", paged=True, kv_block_tokens=16,
                 prefill_chunk=16)
WAIT = 60.0
_MODEL: dict = {}


@pytest.fixture(autouse=True)
def clean_registries():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    assert faults.active() is False and jfaults.active() is False


def _model():
    """(JAX cfg, JAX params, port cfg, port params) of debug:tiny in
    float32, made from jax.random.key(0)."""
    if not _MODEL:
        cfg_j = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
        params_j = jl.init_params(jax.random.key(0), cfg_j)
        cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
        params_t = tl.params_from_numpy(
            jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
        _MODEL.update(j=(cfg_j, params_j), t=(cfg_t, params_t))
    return _MODEL


# the two packages' pieces, keyed so a test body runs on either
PKG = {
    "port": dict(faults=faults, Runner=ModelRunner, Scheduler=Scheduler,
                 GenRequest=GenRequest, Tel=EngineTelemetry, SLO=SLOTracker,
                 Store=TraceStore, Watchdog=Watchdog, Reg=tmetrics.Registry,
                 Tok=ByteTokenizer, Alloc=BlockAllocator,
                 Supervisor=EngineSupervisor),
    "jax": dict(faults=jfaults, Runner=JaxRunner, Scheduler=JaxScheduler,
                GenRequest=JaxGenRequest, Tel=JaxTelemetry, SLO=JaxSLO,
                Store=JaxStore, Watchdog=JaxWatchdog, Reg=jmetrics.Registry,
                Tok=JaxByteTokenizer, Alloc=JaxAllocator,
                Supervisor=jfaults.EngineSupervisor),
}


def _runner(pkg: str, **kw):
    kw = {**RUNNER_KW, **kw}
    if pkg == "port":
        cfg, params = _model()["t"]
        return ModelRunner(cfg, params, device="cpu", **kw)
    cfg, params = _model()["j"]
    return JaxRunner(cfg, params, attn_impl="xla", **kw)


def _engine(pkg: str, name: str, *, watchdog=None, registry=None, **kw):
    P = PKG[pkg]
    registry = registry or P["Reg"]()
    runner = _runner(pkg, **kw)
    sched = P["Scheduler"](
        runner, P["Tok"](),
        telemetry=P["Tel"](model=name, registry=registry, store=P["Store"](),
                            slo=P["SLO"](registry=registry, targets={})),
        watchdog=watchdog)
    return runner, sched


def _req(pkg: str, text: str, **kw):
    kw.setdefault("temperature", 0.0)
    return PKG[pkg]["GenRequest"](prompt=list(text.encode()), **kw)


def _wait(pred, timeout: float = WAIT) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- registry -------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_registry_arm_sets_and_clear_resets_active(pkg):
    f = PKG[pkg]["faults"]
    assert f.active() is False
    f.arm(f.FaultSpec(site="engine.dispatch"))
    assert f.active() is True and f.registry.ACTIVE is True
    assert f.clear() == 1
    assert f.active() is False


def _refusals(f) -> list:
    out = []
    for spec in (dict(site="engine.dipsatch"),
                 dict(site="engine.dispatch", after=-1),
                 dict(site="engine.dispatch", times=-2),
                 dict(site="engine.drain", delay_s=-0.5)):
        try:
            f.arm(f.FaultSpec(**spec))
            out.append("armed")
        except ValueError as e:
            out.append(str(e))
    for text in ("bogus_field=1", "mode", "after=x", "mode=hang,,times=2"):
        try:
            out.append(f.parse_spec("engine.drain", text).to_dict())
        except ValueError as e:
            out.append(str(e))
    return out


def test_registry_refusals_and_parses_alike():
    """Unknown sites, negative counts and malformed spec strings are
    refused with the JAX package's messages; good strings parse alike."""
    assert _refusals(faults) == _refusals(jfaults)
    assert faults.active() is False
    assert faults.SITES == jfaults.SITES
    spec = faults.parse_spec(
        "engine.drain", "mode=hang,delay_s=1.5,after=2,times=3,match=x")
    assert (spec.mode, spec.delay_s, spec.after, spec.times, spec.match) \
        == ("hang", 1.5, 2, 3, "x")
    assert spec.to_dict() == jfaults.parse_spec(
        "engine.drain",
        "mode=hang,delay_s=1.5,after=2,times=3,match=x").to_dict()


def _schedule(f, seed: int) -> tuple:
    """A seeded schedule: three armed specs, 200 fire calls over random
    sites and keys; the fire results and the final snapshot."""
    rng = random.Random(seed)
    f.arm(f.FaultSpec(site="engine.dispatch", after=2, times=3,
                      match="decode"))
    f.arm(f.FaultSpec(site="decode.nan", mode="nan", times=0, match="b"))
    f.arm(f.FaultSpec(site="paged.allocate", mode="exhaust", after=5,
                      times=2))
    fired = []
    for _ in range(200):
        site = rng.choice(["engine.dispatch", "decode.nan",
                           "paged.allocate", "engine.drain"])
        key = rng.choice(["decode", "prefill", "a", "b", "ab", "7"])
        spec = f.fire(site, key)
        fired.append(None if spec is None else (spec.site, spec.fired))
    snap = f.snapshot()
    f.clear()
    return fired, snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_schedule_fires_alike(seed):
    assert _schedule(faults, seed) == _schedule(jfaults, seed)


def test_fire_predicate_after_times_match():
    faults.arm(FaultSpec(site="engine.dispatch", after=2, times=2,
                         match="decode"))
    assert faults.fire("engine.dispatch", key="prefill") is None  # no match
    assert faults.fire("engine.drain", key="decode") is None      # site
    assert faults.fire("engine.dispatch", key="decode") is None   # skip 1
    assert faults.fire("engine.dispatch", key="decode") is None   # skip 2
    assert faults.fire("engine.dispatch", key="decode") is not None
    assert faults.fire("engine.dispatch", key="decode") is not None
    assert faults.fire("engine.dispatch", key="decode") is None   # exhausted
    snap = faults.snapshot()[0]
    assert snap["fired"] == 2 and snap["hits"] == 5


def test_apply_raise_and_sleep_modes():
    faults.arm(FaultSpec(site="engine.dispatch", mode="raise", times=1))
    with pytest.raises(FaultInjected) as e:
        faults.apply("engine.dispatch", key="decode")
    assert str(e.value) == str(jfaults.FaultInjected("engine.dispatch",
                                                     "decode"))
    faults.clear()
    faults.arm(FaultSpec(site="engine.drain", mode="hang", delay_s=0.05,
                         times=1))
    t0 = time.monotonic()
    assert faults.apply("engine.drain").mode == "hang"
    assert time.monotonic() - t0 >= 0.05


def test_parse_spec_and_env_install_alike():
    env = {"LOCALAI_FAULT_ENGINE_DISPATCH": "mode=raise,times=1",
           "LOCALAI_FAULT_DECODE_NAN": "mode=nan,match=x,after=1",
           "LOCALAI_FAULT_PAGED_ALLOCATE": "bogus=1",      # ignored, logged
           "LOCALAI_FAULT_NO_SUCH_SITE": "mode=raise",    # ignored, logged
           "OTHER_VAR": "x"}
    assert faults.install_from_env(env) == jfaults.install_from_env(env) == 2
    assert faults.snapshot() == jfaults.snapshot()
    assert [s["site"] for s in faults.snapshot()] == ["engine.dispatch",
                                                      "decode.nan"]


# -- block-pool invariants ------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_check_invariants_clean_allocator(pkg):
    a = PKG[pkg]["Alloc"](num_blocks=10, block_tokens=16,
                          max_blocks_per_seq=8)
    assert a.check_invariants() == []
    a.allocate(0, 48, prompt=list(range(40)))
    a.allocate(1, 32)
    assert a.check_invariants() == []
    a.register_prefix(0, list(range(40)))
    assert a.check_invariants() == []
    a.release(0)
    a.release(1)
    assert a.check_invariants() == []
    st = a.stats()
    assert st.free + st.cached == st.total


def _corruptions(Alloc) -> list:
    out = []
    a = Alloc(num_blocks=10, block_tokens=16, max_blocks_per_seq=8)
    a.allocate(0, 48)
    a._ref[a.tables[0][0]] = 0            # leaked refcount
    out.append(a.check_invariants())
    a = Alloc(num_blocks=10, block_tokens=16, max_blocks_per_seq=8)
    a._free.append(a._free[-1])           # duplicate free entry
    out.append(a.check_invariants())
    a = Alloc(num_blocks=10, block_tokens=16, max_blocks_per_seq=8)
    a._free.pop()                         # vanished block (leak)
    out.append(a.check_invariants())
    a = Alloc(num_blocks=10, block_tokens=16, max_blocks_per_seq=8)
    bid = a._free.pop()
    a._ref[bid] = 1                       # refcounted but unreachable
    out.append(a.check_invariants())
    return out


def test_check_invariants_detects_corruption_alike():
    got = _corruptions(BlockAllocator)
    assert got == _corruptions(JaxAllocator)
    assert any("refcount" in p for p in got[0])
    assert any("duplicate" in p for p in got[1])
    assert any("leaked" in p for p in got[2])
    assert any("no table or pool entry" in p for p in got[3])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_injected_pool_exhaustion(pkg):
    f = PKG[pkg]["faults"]
    a = PKG[pkg]["Alloc"](num_blocks=10, block_tokens=16,
                          max_blocks_per_seq=8)
    f.arm(f.FaultSpec(site="paged.allocate", mode="exhaust", times=1))
    assert a.allocate(0, 32) is None      # injected: pool reports full
    assert a.allocate(0, 32) is not None  # schedule exhausted: real answer
    assert a.check_invariants() == []


# -- NaN/inf decode guard -------------------------------------------------


def _nan_run(pkg: str, monkeypatch) -> dict:
    monkeypatch.setenv("LOCALAI_NAN_QUARANTINE_DISPATCHES", "4")
    f, reg = PKG[pkg]["faults"], PKG[pkg]["Reg"]()
    runner, sched = _engine(pkg, f"nan-{pkg}", registry=reg)
    seen: dict = {}
    poison, unquarantine = sched._poisoned, sched._unquarantine

    def poisoned(slot, ctx):
        seen["poisoned_at"], seen["slot"] = sched._dispatch_seq, slot
        poison(slot, ctx)
        seen["release_at"] = sched._quarantined.get(slot)

    def unq():
        held = bool(sched._quarantined)
        unquarantine()
        if held and not sched._quarantined:
            seen["released_at"] = sched._dispatch_seq

    sched._poisoned, sched._unquarantine = poisoned, unq
    try:
        ref = sched.generate(_req(pkg, "co-batched survivor",
                                  max_new_tokens=16), timeout=WAIT)
        f.arm(f.FaultSpec(site="decode.nan", mode="nan", match="poison-me",
                          times=1))
        poisoned_h = sched.submit(_req(pkg, "poison target",
                                       max_new_tokens=200, ignore_eos=True,
                                       correlation_id="poison-me"))
        survivor = sched.submit(_req(pkg, "co-batched survivor",
                                     max_new_tokens=16))
        poisoned_h.result(WAIT)
        survivor.result(WAIT)
        m = sched.metrics()
        # the slot returns to service once its window of dispatches passes
        deadline = time.monotonic() + WAIT
        while sched._quarantined and time.monotonic() < deadline:
            sched.generate(_req(pkg, "quarantine drain", max_new_tokens=4),
                           timeout=WAIT)
        assert _wait(lambda: "released_at" in seen)
        return {"poisoned": poisoned_h.finish_reason,
                "survivor": (survivor.finish_reason, survivor.token_ids),
                "ref": ref.token_ids, "nan_rows": m["nan_rows"],
                "quarantined": m["quarantined_slots"],
                "window": seen["release_at"] - seen["poisoned_at"],
                "released_on_time": seen["released_at"]
                >= seen["release_at"],
                "left": dict(sched._quarantined), "render": reg.render(),
                "hold": (seen["slot"], seen["poisoned_at"],
                         seen["released_at"]),
                "log": list(getattr(sched, "quarantine_log", [])),
                "invariants": runner.allocator.check_invariants()}
    finally:
        sched.shutdown()


def test_nan_guard_fails_only_poisoned_slot_and_quarantines(monkeypatch):
    port, ref = _nan_run("port", monkeypatch), _nan_run("jax", monkeypatch)
    for got in (port, ref):
        assert got["poisoned"] == "error"
        assert got["survivor"][0] in ("stop", "length")
        # the co-batched stream is byte-identical to the unpoisoned run
        assert got["survivor"][1] == got["ref"]
        assert got["nan_rows"] == 1 and got["quarantined"] == 1
        assert got["window"] == 4 and got["released_on_time"]
        assert got["left"] == {}
        assert got["invariants"] == []
    # the port's log of holds records the poisoning and the release
    assert port["log"] == [port["hold"]]
    # and equal across both packages
    assert port["survivor"] == ref["survivor"]
    assert port["ref"] == ref["ref"]
    assert 'localai_nan_rows_total{model="nan-port"} 1' in port["render"]
    assert 'localai_nan_rows_total{model="nan-jax"} 1' in ref["render"]


def test_quarantine_gauge_exported():
    reg, jreg = tmetrics.Registry(), jmetrics.Registry()
    tmetrics.update_engine_gauges("m", {"quarantined_slots": 2}, registry=reg)
    jmetrics.update_engine_gauges("m", {"quarantined_slots": 2},
                                  registry=jreg)
    assert 'localai_quarantined_slots{model="m"} 2' in reg.render()
    assert reg.quarantined_slots.render() == jreg.quarantined_slots.render()


# -- self-healing supervisor ----------------------------------------------


def _supervised(pkg: str, name: str, **sup_kw):
    P = PKG[pkg]
    reg = P["Reg"]()
    store = P["Store"]()
    wd = P["Watchdog"](deadline=0.4, registry=reg, store=store,
                       poll_interval=0.1)
    runner, sched = _engine(pkg, name, watchdog=wd, registry=reg,
                            num_slots=sup_kw.pop("num_slots", 4))
    sup_kw.setdefault("max_rebuilds", 3)
    sup_kw.setdefault("backoff_s", 0.05)
    sup_kw.setdefault("probe_timeout_s", WAIT)
    sup = P["Supervisor"](sched, registry=reg, **sup_kw)
    return reg, wd, runner, sched, sup


def _wedge(pkg: str, sched, text: str, delay_s: float = 2.0):
    """A long request decoding, then an engine.drain hang past the
    watchdog's deadline."""
    f = PKG[pkg]["faults"]
    wedged = sched.submit(_req(pkg, text, max_new_tokens=400,
                               ignore_eos=True))
    assert _wait(lambda: wedged.t_first_token is not None)
    f.arm(f.FaultSpec(site="engine.drain", mode="hang", delay_s=delay_s,
                      times=1))
    return wedged


def _rebuild_run(pkg: str) -> dict:
    """One slot: a wedged request holds it while two requests queue; the
    stall rebuilds the engine and the queued requests run on the fresh
    one."""
    f = PKG[pkg]["faults"]
    reg, wd, runner, sched, sup = _supervised(pkg, f"rebuild-{pkg}",
                                              num_slots=1)
    try:
        kv_before = runner.kv
        wedged = _wedge(pkg, sched, "about to wedge")
        queued = [sched.submit(_req(pkg, t, max_new_tokens=12))
                  for t in ("queued one", "queued two")]
        wedged.result(WAIT)
        assert _wait(lambda: sched.rebuilds == 1)
        f.clear()
        for h in queued:
            h.result(WAIT)
        after = sched.generate(_req(pkg, "after rebuild", max_new_tokens=8),
                               timeout=WAIT)
        return {"wedged": wedged.finish_reason,
                "queued": [(h.finish_reason, h.token_ids) for h in queued],
                "after": (after.finish_reason, after.token_ids),
                "rebuilds": sched.rebuilds, "failed": sched.failed,
                "attempts": sup.attempts, "render": reg.render(),
                "new_pool": runner.kv is not kv_before,
                "invariants": runner.allocator.check_invariants(),
                "status": sup.status()}
    finally:
        sched.shutdown()
        wd.stop()


def test_stall_escalates_to_rebuild_and_recovers():
    port, ref = _rebuild_run("port"), _rebuild_run("jax")
    for name, got in (("port", port), ("jax", ref)):
        assert got["wedged"] == "error"          # drained with clean error
        assert got["rebuilds"] == 1 and not got["failed"]
        assert all(r in ("stop", "length") for r, _ in got["queued"])
        assert got["after"][0] in ("stop", "length")
        assert got["invariants"] == []
        assert (f'localai_engine_rebuilds_total{{model="rebuild-{name}"}} 1'
                in got["render"])
        # a healthy completion reset the incident budget
        assert got["attempts"] == 0
    # the queued requests resumed with equal tokens on both packages
    assert port["queued"] == ref["queued"]
    assert port["after"] == ref["after"]
    assert port["new_pool"]                        # rebound, not reused
    assert set(port["status"]) == set(ref["status"])


def _exhaustion_run(pkg: str) -> dict:
    """Every rebuild's probe fails (the allocator reports exhaustion
    forever), so the supervisor walks its whole bounded ladder — its
    backoff sleeps recorded by a fake clock — and latches failed."""
    f = PKG[pkg]["faults"]
    reg, wd, runner, sched, sup = _supervised(
        pkg, f"doomed-{pkg}", max_rebuilds=3, probe_timeout_s=10.0,
        backoff_s=0.5, backoff_cap_s=0.8)
    slept = []
    sup._sleep = slept.append
    try:
        random.seed(7)  # the backoff's jitter
        wedged = _wedge(pkg, sched, "wedge me")
        f.arm(f.FaultSpec(site="paged.allocate", mode="exhaust", times=0))
        wedged.result(WAIT)
        assert _wait(lambda: sched.failed)
        f.clear()
        # a failed engine refuses new work with a clean, instant error
        t0 = time.monotonic()
        h = sched.submit(_req(pkg, "too late", max_new_tokens=4))
        h.result(10)
        return {"wedged": wedged.finish_reason, "late": h.finish_reason,
                "late_s": time.monotonic() - t0, "rebuilds": sched.rebuilds,
                "state": sched.metrics()["engine_state"],
                "slept": [round(s, 9) for s in slept],
                "render": reg.render(), "alive": sched._thread.is_alive()}
    finally:
        sched.shutdown()
        wd.stop()


def test_rebuild_exhaustion_marks_model_failed():
    port, ref = _exhaustion_run("port"), _exhaustion_run("jax")
    for name, got in (("port", port), ("jax", ref)):
        assert got["wedged"] == "error" and got["late"] == "error"
        assert got["late_s"] < 1.0
        assert got["rebuilds"] == 0                # no attempt succeeded
        assert got["state"] == "failed"
        assert f'localai_engine_failed{{model="doomed-{name}"}} 1' \
            in got["render"]
        assert len(got["slept"]) == 2              # attempts 2 and 3
    # the same jittered, capped backoff schedule
    assert port["slept"] == ref["slept"]


def test_supervisor_rejects_spec_engines():
    class FakeSched:
        spec = object()

    with pytest.raises(ValueError):
        EngineSupervisor(FakeSched())


def test_abandoned_engine_thread_exits_without_touching_new_state():
    """The fenced-off thread exits once its blocked round-trip returns,
    and launches nothing on the rebuilt state meanwhile: no decode step,
    no prefill chunk, the fresh block tables and positions untouched; the
    rebuilt engine keeps serving afterwards."""
    reg, wd, runner, sched, sup = _supervised("port", "fence")
    try:
        old_thread = sched._thread
        old_kv = runner.kv.k
        _wedge("port", sched, "wedge for fence", delay_s=1.5).result(WAIT)
        assert _wait(lambda: sched.rebuilds == 1)
        assert sched._thread is not old_thread
        counts = (runner.decode_steps, runner.prefill_chunks,
                  runner.verify_windows)
        tables = runner.block_tables.clone()
        positions = runner.state.positions.clone()
        kv = runner.kv.k.clone()
        old_thread.join(timeout=30)       # wakes from the hang, sees the
        assert not old_thread.is_alive()  # fence, exits without damage
        assert (runner.decode_steps, runner.prefill_chunks,
                runner.verify_windows) == counts
        assert torch.equal(runner.block_tables, tables)
        assert torch.equal(runner.state.positions, positions)
        assert torch.equal(runner.kv.k, kv)
        assert runner.kv.k is not old_kv
        assert runner.kv.k.data_ptr() != old_kv.data_ptr()
        faults.clear()
        after = sched.generate(_req("port", "post fence", max_new_tokens=8),
                               timeout=WAIT)
        assert after.finish_reason in ("stop", "length")
    finally:
        sched.shutdown()
        wd.stop()


def test_supervisor_detach_stops_reacting():
    reg, wd, runner, sched, sup = _supervised("port", "detached")
    try:
        sup.detach()
        sup._on_event(StallEvent(sched._wd_channel, "stall", 1.0))
        time.sleep(0.2)
        assert sched.rebuilds == 0
    finally:
        sched.shutdown()
        wd.stop()


# -- speculation -----------------------------------------------------------


def test_spec_engine_rebuilds_and_garbled_drafts_keep_greedy_output():
    """A speculating engine is supervisable (``supports_rebuild``); a
    ``spec.draft`` garble on every window collapses acceptance but leaves
    the greedy stream equal to speculation off; ``reinit`` resets the
    drafter's history and the backoff."""
    tok = ByteTokenizer()
    prompt = list(b"abcabcabcabcabcabc")
    req = dict(prompt=prompt, max_new_tokens=24, temperature=0.0,
               logit_bias={97: 1e4})
    plain = Scheduler(_runner("port", num_slots=2), tok, multi_step=4)
    try:
        want = plain.generate(GenRequest(**req), timeout=WAIT).token_ids
    finally:
        plain.shutdown()
    target = _runner("port", num_slots=2)
    spec = SpecEngine(target, NGramDrafter(2, gamma=4), gamma=4,
                      min_accept=0.0)
    assert spec.supports_rebuild is True
    sched = Scheduler(target, tok, multi_step=4, spec=spec)
    sup = EngineSupervisor(sched, registry=tmetrics.Registry())
    try:
        faults.arm(FaultSpec(site="spec.draft", mode="garble", times=0))
        got = sched.generate(GenRequest(**req), timeout=WAIT)
        assert got.token_ids == want
        m = sched.metrics()
        assert m["spec_windows"] > 0 and m["spec_accepted_tokens"] == 0
        assert faults.snapshot()[0]["fired"] >= m["spec_windows"]
        faults.clear()
        spec._cooldown_left = 5
        spec.drafter.admit(0, prompt, 97, None)
        spec.reinit()
        assert spec._cooldown_left == 0 and not spec.drafter._history
        assert sup.status()["failed"] is False
    finally:
        sched.shutdown()


def test_spec_draft_raise_fails_only_the_window():
    """A drafter failure mid-window (``spec.draft`` raise) fails the
    active request as a verify window that raises does; the engine serves
    on."""
    tok = ByteTokenizer()
    target = _runner("port", num_slots=2)
    sched = Scheduler(target, tok, multi_step=4,
                      spec=SpecEngine(target, NGramDrafter(2, gamma=4)))
    try:
        faults.arm(FaultSpec(site="spec.draft", mode="raise", times=1))
        h = sched.generate(GenRequest(prompt=list(b"abcabcabcabcabcabc"),
                                      max_new_tokens=24, temperature=0.0,
                                      logit_bias={97: 1e4}), timeout=WAIT)
        assert h.finish_reason == "error"
        faults.clear()
        ok = sched.generate(GenRequest(prompt=list(b"xyz"),
                                       max_new_tokens=6, temperature=0.0),
                            timeout=WAIT)
        assert ok.finish_reason in ("stop", "length")
        assert not target.allocator.check_invariants()
    finally:
        sched.shutdown()


# -- zero overhead while disarmed -----------------------------------------


def test_disarmed_hot_path_is_one_boolean():
    """With nothing armed, every injection site of the port reduces to a
    module-attribute truthiness check on the one registry module."""
    import localai_tpu_torch.engine.paged as paged_mod
    import localai_tpu_torch.engine.scheduler as sched_mod
    import localai_tpu_torch.obs.compile as compile_mod
    import localai_tpu_torch.spec.engine as spec_mod

    assert faults.active() is False
    for mod in (sched_mod, paged_mod, compile_mod, spec_mod):
        assert mod._faults is faults.registry
    assert faults.registry.ACTIVE is False


def test_compile_site_raises_on_a_first_call_only():
    """``engine.compile`` fires at a program shape's first call (the
    port's "compile"), never on a repeat call."""
    from localai_tpu_torch.obs import compile as tcompile

    calls = []
    fn = tcompile.watch(lambda x: calls.append(x) or x, "decode",
                        registry=tmetrics.Registry())
    faults.arm(FaultSpec(site="engine.compile", mode="raise", times=0))
    with pytest.raises(FaultInjected):
        fn(torch.zeros(2))
    assert calls == []
    faults.clear()
    fn(torch.zeros(2))
    faults.arm(FaultSpec(site="engine.compile", mode="raise", times=0))
    fn(torch.zeros(2))                    # seen shape: no compile, no fire
    assert len(calls) == 2
    assert faults.snapshot()[0]["hits"] == 0


def test_watchdog_remove_callback():
    wd = Watchdog(deadline=60.0, registry=tmetrics.Registry(),
                  store=TraceStore())
    seen = []
    cb = seen.append
    wd.on_stall(cb)
    wd.remove_callback(cb)
    wd.remove_callback(cb)  # idempotent
    wd._fire(object())
    assert seen == []


def test_watchdog_reset_clears_leaked_armed_count():
    wd = Watchdog(deadline=0.01, registry=tmetrics.Registry(),
                  store=TraceStore())
    wd.arm("leaky")
    assert wd.check(now=time.monotonic() + 1.0)  # trips while armed
    wd.reset("leaky")
    assert not wd.stalled("leaky")
    assert wd.check(now=time.monotonic() + 100.0) == []  # nothing armed
    wd.disarm("leaky")  # the abandoned thread finally returns: no-op
    assert wd.status()["leaky"]["armed"] == 0


def test_anatomy_phases_attribute_injected_delays():
    """A host-side sleep at ``engine.dispatch`` lands in the record's
    gap/sched phases; a delay at ``engine.drain`` (inside the result-fetch
    guard) lands in sync_ms; every record keeps gap + sched + launch +
    sync <= dispatch_ms."""
    runner, sched = _engine("port", "anatomy")

    def run_one(text):
        h = sched.generate(GenRequest(prompt=list(text.encode()),
                                      max_new_tokens=16, temperature=0.0,
                                      ignore_eos=True), timeout=WAIT)
        assert h.finish_reason == "length"

    def rows_after(base_ts):
        return [r for r in sched.flight.snapshot()
                if not r["compile"] and r["ts"] > base_ts]

    keeper = None
    try:
        run_one("warm me up")
        keeper = sched.submit(GenRequest(
            prompt=list(b"keeper"), max_new_tokens=224, temperature=0.0,
            ignore_eos=True))
        assert _wait(lambda: keeper.t_first_token is not None)
        base = sched.flight.snapshot()[-1]["ts"]
        faults.arm(FaultSpec(site="engine.dispatch", mode="sleep",
                             delay_s=0.12, times=1, match="decode"))
        run_one("host-side delay")
        hit = max(rows_after(base),
                  key=lambda r: r["gap_ms"] + r["sched_ms"])
        assert hit["gap_ms"] + hit["sched_ms"] >= 100.0
        assert hit["sync_ms"] < 100.0
        faults.clear()
        base = sched.flight.snapshot()[-1]["ts"]
        faults.arm(FaultSpec(site="engine.drain", mode="sleep",
                             delay_s=0.12, times=1))
        run_one("device-side delay")
        hit = max(rows_after(base), key=lambda r: r["sync_ms"])
        assert hit["sync_ms"] >= 100.0
        keeper.cancel()
        keeper.result(timeout=30.0)
        keeper = None
        for r in sched.flight.snapshot():
            total = (r["gap_ms"] + r["sched_ms"] + r["launch_ms"]
                     + r["sync_ms"])
            assert total <= r["dispatch_ms"] + 5e-3, r
    finally:
        if keeper is not None:
            keeper.cancel()
        sched.shutdown()


def test_kv_check_sweeps_at_every_drain(monkeypatch):
    """``LOCALAI_KV_CHECK=1``: the drain-time sweep counts a corrupted
    pool's violations into the scheduler's count and
    ``localai_kv_invariant_violations_total``; a clean serve reads 0."""
    monkeypatch.setenv("LOCALAI_KV_CHECK", "1")
    reg = tmetrics.Registry()
    runner, sched = _engine("port", "kvcheck", registry=reg)
    try:
        sched.generate(_req("port", "clean run", max_new_tokens=8),
                       timeout=WAIT)
        assert sched.metrics()["kv_invariant_violations"] == 0
        runner.allocator._free.pop()      # a vanished block: a leak
        sched.generate(_req("port", "leaky run", max_new_tokens=4),
                       timeout=WAIT)
        n = sched.metrics()["kv_invariant_violations"]
        assert n > 0
        assert (f'localai_kv_invariant_violations_total{{model="kvcheck"}} '
                f'{float(n)}') in reg.render()
    finally:
        sched.shutdown()


# -- the metric families ---------------------------------------------------

FAMILIES = ("faults_injected", "nan_rows", "quarantined_slots",
            "engine_rebuilds", "engine_failed", "kv_invariant_violations",
            "batch_jobs", "batch_lines", "batch_lane_paused",
            "batch_queue_depth")


def _feed_families(reg) -> None:
    reg.faults_injected.inc(site="decode.nan")
    reg.faults_injected.inc(2, site="engine.drain")
    reg.nan_rows.inc(model="m")
    reg.quarantined_slots.set(1, model="m")
    reg.engine_rebuilds.inc(model="m")
    reg.engine_failed.set(0, model="m")
    reg.kv_invariant_violations.inc(3, model="m")
    for state, n in (("validating", 0), ("in_progress", 1),
                     ("completed", 2)):
        reg.batch_jobs.set(n, state=state)
    reg.batch_lines.inc(16, result="completed")
    reg.batch_lines.inc(result="failed")
    reg.batch_lane_paused.set(1)
    reg.batch_queue_depth.set(4, model="m")


@pytest.mark.parametrize("family", FAMILIES)
def test_fault_and_batch_families_as_the_jax_registry(family):
    """Name, type, help text, labels and samples of each family equal the
    JAX registry's, fed the same values; the order among the families is
    the JAX registry's too."""
    port, ref = tmetrics.Registry(), jmetrics.Registry()
    _feed_families(port)
    _feed_families(ref)
    a, b = getattr(port, family), getattr(ref, family)
    assert type(a).__name__ == type(b).__name__
    assert a.render() == b.render()
    names = [m.name for m in port._all()]
    theirs = [m.name for m in ref._all() if m.name in set(names)]
    assert names == theirs


def test_faults_fire_counter_by_site():
    """Each fire counts once into localai_faults_injected_total{site}."""
    before = tmetrics.REGISTRY.faults_injected.render()
    faults.arm(FaultSpec(site="engine.dispatch", mode="sleep", times=2))
    for _ in range(3):
        faults.apply("engine.dispatch", key="decode")
    line = [x for x in tmetrics.REGISTRY.faults_injected.render().splitlines()
            if 'site="engine.dispatch"' in x][0]
    old = [x for x in before.splitlines() if 'site="engine.dispatch"' in x]
    prev = float(old[0].rsplit(" ", 1)[1]) if old else 0.0
    assert float(line.rsplit(" ", 1)[1]) == prev + 2


def test_scheduler_threads_stop_with_the_failed_engine():
    """``mark_failed`` fences the engine thread off: it exits, so
    ``alive()`` reads False and the manager's dead-engine reload takes
    over; queued and held requests resolve with an error."""
    runner, sched = _engine("port", "failing", num_slots=1)
    try:
        long = sched.submit(_req("port", "long one", max_new_tokens=200,
                                 ignore_eos=True))
        assert _wait(lambda: long.t_first_token is not None)
        queued = sched.submit(_req("port", "queued", max_new_tokens=4))
        batch = sched.submit(_req("port", "batch line", max_new_tokens=4,
                                  priority=1))
        done = threading.Event()
        threading.Thread(target=lambda: (sched.mark_failed(),
                                         done.set())).start()
        assert done.wait(WAIT)
        for h in (long, queued, batch):
            h.result(WAIT)
            assert h.finish_reason == "error"
        assert _wait(lambda: not sched._thread.is_alive())
        assert sched.alive() is False
    finally:
        sched.shutdown()


def test_no_submit_is_left_unresolved_by_mark_failed():
    """Stress: with the engine thread parked in a wedged drain (the state
    the supervisor calls ``mark_failed`` in), eight threads submit on both
    lanes while ``mark_failed`` runs; the failed check and the enqueue
    share the lock its drain holds, so every handle resolves with an
    error and none is parked on the dead engine; the fenced engine thread
    exits when its drain returns."""
    import sys

    runner, sched = _engine("port", "stress", num_slots=2)
    handles: list = []
    lock = threading.Lock()
    engine = sched._thread
    wedged = sched.submit(_req("port", "wedge", max_new_tokens=200,
                               ignore_eos=True))
    assert _wait(lambda: wedged.t_first_token is not None)
    faults.arm(FaultSpec(site="engine.drain", mode="hang", delay_s=1.0,
                         times=1))
    assert _wait(lambda: faults.snapshot()[0]["fired"] == 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submitter(i):
            for j in range(20):
                h = sched.submit(_req("port", f"s{i}-{j}", max_new_tokens=2,
                                      priority=j % 2))
                with lock:
                    handles.append(h)

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.005)
        sched.mark_failed()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    try:
        assert len(handles) == 160
        for h in handles + [wedged]:
            h.result(WAIT)
            assert h.finish_reason == "error"
        engine.join(WAIT)
        assert not engine.is_alive()
        assert sched.metrics()["engine_state"] == "failed"
    finally:
        sched.shutdown()
