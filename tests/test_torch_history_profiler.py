"""The port's metrics history, anomaly profiler and stall watchdog against
the JAX package's, on the CPU.

  * both ``History`` stores fed one seeded stream of gauge and counter
    points (explicit timestamps) answer every ``query`` alike at each
    resolution, with ``since``; ``snapshot_dict`` series agree; a snapshot
    written by the port survives a restart of the port's store
    (``LOCALAI_HISTORY_DIR``, ``install_from_env``), and one written by
    the JAX package is read by the port; ``observe_engine`` /
    ``observe_ledger`` record the same series;
  * both ``ProfileManager``s with an injected ``capture_fn`` and a fake
    clock make the same capture / cooldown / hourly-cap / single-flight
    decisions over one trigger stream, with the same ``report`` and
    manifest, and the same step-p99 regression decisions over one flight
    ring; the ``LOCALAI_PROFILE_*`` knobs are read alike;
  * both ``Watchdog``s run through one arm / check / pulse sequence trip
    and recover alike; a port scheduler whose drain is held past the
    deadline (a monkeypatched blocking read) trips
    ``localai_engine_stalled`` on its ``engine:<model>`` channel and
    leaves a ``kind="stall"`` trace with every thread's stack and the
    flight ring; the drain's completion clears it.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu.obs import flight as jflight  # noqa: E402
from localai_tpu.obs import history as jhistory  # noqa: E402
from localai_tpu.obs import ledger as jledger  # noqa: E402
from localai_tpu.obs import metrics as jmetrics  # noqa: E402
from localai_tpu.obs import profiler as jprofiler  # noqa: E402
from localai_tpu.obs import trace as jtrace  # noqa: E402
from localai_tpu.obs import watchdog as jwatchdog  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine import runner as trunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models.manager import build_serving_model  # noqa: E402
from localai_tpu_torch.obs import flight as tflight  # noqa: E402
from localai_tpu_torch.obs import history as thistory  # noqa: E402
from localai_tpu_torch.obs import ledger as tledger  # noqa: E402
from localai_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from localai_tpu_torch.obs import profiler as tprofiler  # noqa: E402
from localai_tpu_torch.obs import trace as ttrace  # noqa: E402
from localai_tpu_torch.obs import watchdog as twatchdog  # noqa: E402
from test_torch_flight import _close  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

# -- history -----------------------------------------------------------------


def _points(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ts, total = 1_700_000_000.0, 0.0
    for _ in range(n):
        ts += float(rng.uniform(0.05, 40.0))
        if rng.uniform() < 0.05:
            ts -= float(rng.uniform(0, 90))   # an out-of-order point
        name = str(rng.choice(["occupancy.m", "tokens_generated.m",
                               "queue_depth.m"]))
        if name.startswith("tokens"):
            total += float(rng.integers(0, 50))
            yield name, total, "counter", ts
        else:
            yield name, float(rng.uniform()), "gauge", ts


def _fed_history(n=3000, seed=11):
    port, ref = thistory.History(), jhistory.History()
    for name, value, kind, ts in _points(n, seed):
        port.record(name, value, kind=kind, ts=ts)
        ref.record(name, value, kind=kind, ts=ts)
    return port, ref


@pytest.mark.parametrize("res", [1, 10, 300, 7])
def test_history_queries_alike(res):
    port, ref = _fed_history()
    assert port.series_names() == ref.series_names()
    for name in port.series_names():
        for since in (0.0, 1_700_020_000.0):
            _close(port.query(name, res=res, since=since),
                   ref.query(name, res=res, since=since))
    assert port.query("nope") is ref.query("nope") is None
    assert thistory.RESOLUTIONS == jhistory.RESOLUTIONS
    assert thistory.CAPACITY == jhistory.CAPACITY
    _close(port.snapshot_dict()["series"], ref.snapshot_dict()["series"])


def test_history_survives_a_restart(tmp_path, monkeypatch):
    port, _ = _fed_history(800, seed=2)
    monkeypatch.setenv("LOCALAI_HISTORY_DIR", str(tmp_path))
    monkeypatch.setenv("LOCALAI_HISTORY_SNAPSHOT_S", "0.5")
    assert port.save(str(tmp_path)).endswith(thistory.SNAPSHOT_FILE)
    restarted = thistory.History()
    try:
        assert thistory.install_from_env(restarted)
        assert restarted.snapshot_s == 1.0     # clamped to 1 s, as JAX's
        for name in port.series_names():
            for res in thistory.RESOLUTIONS:
                assert restarted.query(name, res=res) == port.query(
                    name, res=res)
        # the writer thread flushes what a scrape records
        restarted.record("occupancy.new", 0.5)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            doc = json.loads((tmp_path / "history.json").read_text())
            if "occupancy.new" in doc["series"]:
                break
            time.sleep(0.2)
        assert "occupancy.new" in doc["series"]
    finally:
        restarted.stop()


def test_history_snapshot_read_across_packages(tmp_path):
    _, ref = _fed_history(500, seed=4)
    ref.save(str(tmp_path))
    port = thistory.History()
    assert port.load(str(tmp_path))
    for name in ref.series_names():
        assert port.query(name, res=10) == ref.query(name, res=10)


def test_history_feeds_alike():
    port, ref = thistory.History(), jhistory.History()
    m = {"occupancy": 0.5, "queue_depth": 2, "kv_utilization": 0.25,
         "host_overhead_fraction": 0.75, "device_bubble_fraction": None,
         "total_generated_tokens": 40, "total_prompt_tokens": 90,
         "preemptions": 1, "shed_total": 3}
    port.observe_engine("m", m)
    ref.observe_engine("m", m)
    pl, jl = tledger.TenantLedger(), jledger.TenantLedger()
    for led in (pl, jl):
        led.note_request(tenant="t-abc", model="m", lane="interactive",
                         reason="stop", tokens=7, prompt_tokens=3,
                         dispatch_ms=5.0, queue_wait_ms=1.0, kv_block_s=0.1)
        led.note_waste("spec_rejected", model="m", tokens=4)
    port.observe_ledger(pl)
    ref.observe_ledger(jl)
    assert port.series_names() == ref.series_names()
    for name in port.series_names():
        got = port.query(name, res=300)
        want = ref.query(name, res=300)
        for p in got["points"] + want["points"]:
            p.pop("ts")   # each recorded at its own wall clock
        assert got == want


# -- profiler ----------------------------------------------------------------


def _managers(tmp_path, clock, **kw):
    caps = {"port": [], "ref": []}
    out = {}
    for side, mod, reg in (("port", tprofiler, tmetrics.Registry()),
                           ("ref", jprofiler, jmetrics.Registry())):
        d = tmp_path / side
        out[side] = mod.ProfileManager(
            out_dir=str(d), registry=reg, clock=lambda: clock["now"],
            capture_fn=lambda path, s, c=caps[side]: c.append(path), **kw)
    return out, caps


def _entries(pm) -> list:
    return [{k: v for k, v in e.items() if k not in ("started_unix",
                                                     "path")}
            for e in pm.entries()]


def test_profiler_decisions_alike(tmp_path):
    clock = {"now": 100.0}
    pms, caps = _managers(tmp_path, clock, enabled=True, seconds=0.01,
                          max_per_hour=3, cooldown_s=60.0)
    rng = np.random.default_rng(9)
    for i in range(60):
        clock["now"] += float(rng.uniform(0, 200))
        trig = str(rng.choice(tprofiler.TRIGGERS))
        got = {side: pm.maybe_capture(trig, trace_id=f"tr-{i}",
                                      reason="why", model="m", sync=True)
               for side, pm in pms.items()}
        assert got["port"] == got["ref"], i
    assert _entries(pms["port"]) == _entries(pms["ref"])
    r1, r2 = pms["port"].report(), pms["ref"].report()
    for r in (r1, r2):
        r.pop("dir")
        for e in r["profiles"]:
            e.pop("started_unix")
            e.pop("path")
    assert r1 == r2
    assert len(caps["port"]) == len(caps["ref"]) > 0
    man = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert len(man["profiles"]) == len(caps["port"])
    # the single-flight lock: a capture in flight refuses the next
    pm = pms["port"]
    clock["now"] += 10_000
    assert pm.acquire_capture()
    try:
        assert not pm.maybe_capture("manual", sync=True)
        assert pm.report()["skipped"]["in_flight"] >= 1
    finally:
        pm.release_capture()


def test_profiler_regressions_alike(tmp_path):
    clock = {"now": 0.0}
    pms, _ = _managers(tmp_path, clock, enabled=True, seconds=0.01,
                       max_per_hour=100, cooldown_s=0.0,
                       regression_ratio=2.0)
    rings = {"port": tflight.FlightRecorder(256),
             "ref": jflight.FlightRecorder(256)}
    for side in pms:
        pms[side].watch_flight("m", rings[side])
    fired = {"port": [], "ref": []}
    rng = np.random.default_rng(2)
    for block in range(8):
        ms = 16.0 * (4 if block in (3, 6) else 1)
        for _ in range(32):
            rec = dict(program="decode_n", steps=8,
                       dispatch_ms=ms * float(rng.uniform(0.9, 1.1)),
                       occupancy=0.5, queue_depth=0, kv_utilization=0.1,
                       tokens=8)
            for r in rings.values():
                r.record(**rec)
        for side, pm in pms.items():
            fired[side].append(pm.check_regressions())
            pm.wait_idle(5.0)
    assert fired["port"] == fired["ref"]
    assert any(fired["port"])


@pytest.mark.parametrize("env", [
    {"LOCALAI_PROFILE_ON_ANOMALY": "1", "LOCALAI_PROFILE_SECONDS": "2.5",
     "LOCALAI_PROFILE_MAX_PER_HOUR": "7", "LOCALAI_PROFILE_COOLDOWN_S": "9",
     "LOCALAI_PROFILE_REGRESSION_RATIO": "3", "LOCALAI_PROFILE_POLL_S": "1",
     "LOCALAI_PROFILE_DIR": "/x/profiles"},
    {"LOCALAI_PROFILE_ON_ANOMALY": "yes", "LOCALAI_PROFILE_SECONDS": "x"},
], ids=["set", "garbage"])
def test_profiler_knobs_from_the_environment(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = tprofiler.ProfileManager(), jprofiler.ProfileManager()
    for attr in ("enabled", "seconds", "out_dir", "max_per_hour",
                 "cooldown_s", "regression_ratio", "poll_s"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def test_profiler_stall_and_shed_triggers(tmp_path):
    """install() hooks the watchdog's stalls and the SLO's shed onsets;
    stop() detaches both."""
    from localai_tpu_torch.obs import slo as tslo

    caps = []
    pm = tprofiler.ProfileManager(
        enabled=True, seconds=0.01, out_dir=str(tmp_path), cooldown_s=0.0,
        registry=tmetrics.Registry(), poll_s=60.0,
        capture_fn=lambda p, s: caps.append(p))
    wd = twatchdog.Watchdog(deadline=0.05, registry=tmetrics.Registry(),
                            store=ttrace.TraceStore())
    slo = tslo.SLOTracker(registry=tmetrics.Registry(),
                          targets={"ttft_ms": 1.0}, min_events=1)
    pm.install(watchdog=wd, slo=slo)
    try:
        wd.arm("device")
        time.sleep(0.1)
        assert [e.kind for e in wd.check()] == ["stall"]
        pm.wait_idle(5.0)
        slo.observe("m", ttft_ms=50.0)
        assert slo.should_shed("m")
        pm.wait_idle(5.0)
        assert [e["trigger"] for e in pm.entries()] == ["stall",
                                                        "slo_shed"]
        assert pm.entries()[0]["trace_id"].startswith("stall-")
    finally:
        pm.stop()
        wd.disarm("device")


# -- watchdog ----------------------------------------------------------------


def test_watchdog_sequence_alike(monkeypatch):
    monkeypatch.setenv("LOCALAI_STALL_DEADLINE_S", "5")
    wds = {"port": twatchdog.Watchdog(registry=tmetrics.Registry(),
                                      store=ttrace.TraceStore()),
           "ref": jwatchdog.Watchdog(registry=jmetrics.Registry(),
                                     store=jtrace.TraceStore())}
    assert wds["port"].deadline == wds["ref"].deadline == 5.0
    assert wds["port"].poll_interval == wds["ref"].poll_interval
    events = {side: [] for side in wds}
    for side, wd in wds.items():
        wd.on_stall(events[side].append)
        base = time.monotonic()
        wd.arm("device")
        wd.pulse("idle")
        trips = [e.kind for e in wd.check(now=base + 1.0)]
        trips += [(e.channel, e.kind) for e in wd.check(now=base + 9.0)]
        trips += [e.kind for e in wd.check(now=base + 20.0)]
        events[side].append(("trips", trips, wd.stalled("device"),
                             wd.stalled("idle")))
        wd.disarm("device")
        events[side].append(("after", wd.stalled()))
        status = wd.status()
        events[side].append(sorted((k, v["armed"], v["stalled"])
                                   for k, v in status.items()))
        text = wd.registry.render()
        events[side].append([x for x in text.splitlines()
                             if x.startswith(("localai_engine_stalled{",
                                              "localai_stalls_total{"))])
    norm = {side: [(e.channel, e.kind) if hasattr(e, "kind") else e
                   for e in evs] for side, evs in events.items()}
    assert norm["port"] == norm["ref"]


ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)


def test_held_drain_trips_and_the_next_pulse_clears(monkeypatch):
    reg, store = tmetrics.Registry(), ttrace.TraceStore()
    wd = twatchdog.Watchdog(deadline=0.3, registry=reg, store=store,
                            poll_interval=0.05)
    release = threading.Event()
    entered = threading.Event()
    real = trunner.AsyncTokens.__array__

    def held(self, dtype=None, copy=None):
        # the drain's blocking read, held until the test lets it go
        entered.set()
        release.wait(30)
        return real(self, dtype, copy)

    doc = {"name": "stall-tiny", "model": "debug:tiny",
           "context_size": 128, "engine": ENGINE}
    sm = build_serving_model(ModelConfig.from_dict(dict(doc)),
                             AppConfig(device="cpu"))
    try:
        # the scheduler built by the manager: rebind its watchdog (and its
        # runner's) to the test's own
        sched = sm.scheduler
        sched.watchdog.remove_context(f"flight:{sched._wd_channel}")
        sched.watchdog = sm.runner.watchdog = wd
        wd.add_context(f"flight:{sched._wd_channel}",
                       sched._flight_forensics)
        wd.start()
        monkeypatch.setattr(trunner.AsyncTokens, "__array__", held)
        h = sched.submit(GenRequest(prompt=list(b"hold the drain"),
                                    max_new_tokens=40, temperature=0.0,
                                    ignore_eos=True))
        assert entered.wait(30)
        channel = "engine:stall-tiny"
        deadline = time.monotonic() + 10
        while not wd.stalled(channel) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert wd.stalled(channel)
        assert f'localai_engine_stalled{{channel="{channel}"}} 1' in \
            reg.render()
        stall = [t for t in store.recent(kind="stall")]
        assert stall and stall[0].attrs["channel"] == channel
        d = stall[0].to_dict()
        names = [c["name"] for c in d["children"]]
        assert names.count("thread") == stall[0].attrs["threads"] > 1
        ctx = [c for c in d["children"] if c["name"] == "context"]
        assert ctx and ctx[0]["attrs"]["source"] == f"flight:{channel}"
        assert any("held" in c["attrs"].get("stack", "")
                   for c in d["children"] if c["name"] == "thread")
        release.set()
        h.result(60)
        assert not wd.stalled(channel)
        assert f'localai_engine_stalled{{channel="{channel}"}} 0' in \
            reg.render()
        assert f'localai_stalls_total{{channel="{channel}"}} 1' in \
            reg.render()
    finally:
        release.set()
        monkeypatch.undo()
        sm.close()
        wd.stop()
