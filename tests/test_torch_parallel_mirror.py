"""The command mirror and the reductions of the tensor-parallel port, on
the CPU.

* The channel's frame for a call equals the JAX package's ``_pack`` of
  the same call, byte for byte (ints, lists, floats, None, numpy arrays
  of every dtype the engine sends); the port's leader admits a JAX
  follower with the right peer token and refuses a wrong one, and the
  reverse.
* ``MIRRORED`` holds every runner method through which the port's
  scheduler and spec engine change state or dispatch a program (read off
  their sources), and a leader's admission mirrors its chunk dispatches.
* In one two-rank gloo group (two processes, 120 s): the reduction is
  one ``all_reduce`` whose bytes are the two ranks' partials added; the
  greedy rows, first tokens and prefill logits of a ``model=2`` runner
  are the same bytes whatever ``LOCALAI_MESH_OVERLAP`` asks (the port
  reduces with ``psum`` and reports the JAX package's decision), as
  ``tests/test_overlap.py`` holds the JAX package's modes equal.
* After each call the leader sends its outcome; a follower whose replay
  ended otherwise raises (the ranks diverged), and one whose replay
  raised waits for that outcome only a while.
* A follower with no card and no ``--device cpu`` raises (its refusal of
  an unserved mesh is in ``tests/test_torch_cli.py``).
"""

import inspect
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu.parallel import multihost as jmh  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.engine import scheduler as tsched  # noqa: E402
from localai_tpu_torch.parallel import multihost as tmh  # noqa: E402
from localai_tpu_torch.spec import drafter as tdrafter  # noqa: E402
from localai_tpu_torch.spec import engine as tspec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

CALLS = [
    ("m", "admit", (3, [1, 2, 3]), {"temperature": 0.0, "top_k": 40,
                                    "seed": None}),
    ("m", "set_bias", (1, np.linspace(-1, 1, 7, dtype=np.float32)), {}),
    ("m", "step_frozen_n", (np.array([True, False, True]), 4), {}),
    ("m", "verify_async", (np.arange(12, dtype=np.int32).reshape(3, 4),),
     {}),
    ("m", "load_prefix", (0, {"k": 1}, 5), {}),
    ("other", "embed", ([5, 6, 7],), {}),
]


@pytest.mark.parametrize("call", CALLS, ids=[c[1] for c in CALLS])
def test_frames_equal_the_jax_package(call):
    model, method, args, kwargs = call
    want = jmh._pack({"model": model, "m": method,
                      "a": [jmh._encode_arg(a) for a in args],
                      "k": {k: jmh._encode_arg(v) for k, v in kwargs.items()}})
    assert tmh._frame(model, method, args, kwargs) == want
    assert tmh._pack({"ok": True}) == jmh._pack({"ok": True})


def test_a_tensor_argument_goes_across_as_its_array():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert tmh._encode_arg(t) == jmh._encode_arg(t.numpy())
    np.testing.assert_array_equal(tmh._decode_arg(tmh._encode_arg(t)),
                                  t.numpy())


def _replay_one(leader_cls, follower_cls, token_l, token_f):
    leader = leader_cls(0, expected=1, token=token_l)
    seen = []

    class Target:
        def admit(self, slot, prompt, **kw):
            seen.append((slot, list(prompt), kw))

    try:
        follower = follower_cls(f"127.0.0.1:{leader.port}",
                                {"m": Target()}, token=token_f)
    except PermissionError:
        leader.close()
        return None
    leader.wait_for(1, timeout=10)
    leader.broadcast("m", "admit", 2, [9, 8], temperature=0.5)
    follower.step()
    follower.close()
    leader.close()
    return seen


@pytest.mark.parametrize("leader,follower", [
    (tmh.CommandLeader, tmh.CommandFollower),
    (tmh.CommandLeader, jmh.CommandFollower),
    (jmh.CommandLeader, tmh.CommandFollower),
], ids=["port-port", "port-jax", "jax-port"])
def test_peer_token_handshake_across_packages(leader, follower):
    assert _replay_one(leader, follower, "s3cret", "s3cret") == [
        (2, [9, 8], {"temperature": 0.5})]
    assert _replay_one(leader, follower, "s3cret", "wrong") is None


def _runner_calls(src: str, obj: str) -> set:
    return set(re.findall(rf"(?<![\w.]){obj}\.([a-z_]+)\(", src))


def test_mirrored_covers_the_scheduler_and_spec_engine():
    """Every runner method the scheduler and the spec engine call that
    changes state or dispatches a program is mirrored; the rest are reads
    (the leader's own, never replayed)."""
    reads = {"free_slots", "slot_positions", "slot_position",
             "reusable_prefix", "resident_rows", "pack_prefix",
             "snapshot_prefix"}
    sched = inspect.getsource(tsched)
    called = (_runner_calls(sched, r"self\.runner")
              | _runner_calls(sched, "runner")
              | _runner_calls(sched, r"self\._engine")
              | _runner_calls(inspect.getsource(tspec), r"self\.target")
              | _runner_calls(inspect.getsource(tspec), "t"))
    called -= {"submit", "generate", "step_spec_async", "observe_window",
               "resync_draft", "suppressed_tick", "stats", "metrics"}
    assert called, "no runner calls found"
    for name in called:
        assert name in tmh.MIRRORED or name in reads, name
    # the admission's chunk dispatches and abort ride the channel
    assert set(tmh.ADMISSION) == {"step_chunk", "abort"}
    drafter_calls = _runner_calls(inspect.getsource(tspec),
                                  r"self\.drafter")
    for name in drafter_calls & set(dir(tdrafter.ModelDrafter)):
        if name not in ("observe", "stats"):
            assert name in tmh.DRAFT_MIRRORED, name


def test_a_leader_admission_mirrors_its_chunks():
    sent = []

    class Leader:
        call_lock = threading.RLock()
        connected = 1

        def broadcast(self, model, method, *args, **kwargs):
            sent.append((method, args))

    class Adm:
        slot, done = 3, False

        def step_chunk(self):
            return 7

        def abort(self):
            self.done = True

    class Runner:
        def begin_admit(self, slot, prompt, **kw):
            return Adm()

    m = tmh.MirroredRunner(Runner(), Leader(), "m")
    adm = m.begin_admit(3, [1, 2])
    assert adm.step_chunk() == 7 and adm.slot == 3
    adm.abort()
    calls = [s for s in sent if s[0] != tmh.OUTCOME]
    assert [s[0] for s in calls] == ["begin_admit", "step_chunk", "abort"]
    assert calls[1][1] == (3,)
    # each call followed by the leader's outcome of it
    assert [s for s in sent if s[0] == tmh.OUTCOME] == [
        (tmh.OUTCOME, ("",))] * 3


class _Admits:
    """A replay target whose ``admit`` raises ``fail`` (when set)."""

    def __init__(self, fail=None):
        self.fail = fail

    def admit(self, slot, prompt, **kw):
        if self.fail is not None:
            raise self.fail("no room")
        return slot


def _mirror_pair(leader_fail, follower_fail):
    leader = tmh.CommandLeader(0, expected=1, token="t", host="127.0.0.1")
    follower = tmh.CommandFollower(f"127.0.0.1:{leader.port}",
                                   {"m": _Admits(follower_fail)}, token="t")
    leader.wait_for(1, timeout=10)
    return leader, follower, tmh.MirroredRunner(_Admits(leader_fail),
                                                leader, "m")


@pytest.mark.parametrize("leader_fail,follower_fail", [
    (None, None), (ValueError, ValueError), (None, MemoryError),
    (ValueError, None), (ValueError, KeyError)],
    ids=["neither", "both-alike", "follower-alone", "leader-alone",
         "different"])
def test_a_replay_is_held_to_the_leaders_outcome(leader_fail,
                                                 follower_fail):
    """The leader sends its call's outcome after it; a follower whose
    replay ended otherwise raises (and its process exits, so the leader
    loses a rank and fails the engine) instead of replaying on from a
    state the leader does not have. The same error on both keeps the
    group in step."""
    leader, follower, mirrored = _mirror_pair(leader_fail, follower_fail)
    try:
        if leader_fail is None:
            assert mirrored.admit(2, [1, 2]) == 2
        else:
            with pytest.raises(leader_fail):
                mirrored.admit(2, [1, 2])
        if leader_fail is follower_fail:
            follower.step()
            if follower_fail is None:
                follower.step()        # the outcome: none raised
            assert follower.errors == (leader_fail is not None)
            return
        with pytest.raises(RuntimeError, match="the ranks diverged"):
            follower.step()
            follower.step()
    finally:
        follower.close()
        leader.close()


def test_a_follower_that_raised_waits_for_the_leader_at_most_a_while(
        monkeypatch):
    """A leader whose call did not raise waits in a collective for the
    follower and sends no outcome: the follower does not wait forever."""
    import time

    monkeypatch.setenv("LOCALAI_MESH_TIMEOUT_S", "1")
    leader, follower, _ = _mirror_pair(None, ValueError)
    try:
        leader.broadcast("m", "admit", 2, [1, 2])
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="did not report"):
            follower.step()
        assert time.monotonic() - t0 < 10
    finally:
        follower.close()
        leader.close()


# the port's package by its module name (metric-name lint: no package
# literal in test strings)
GROUP_SCRIPT = r"""
import dataclasses, importlib, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
PKG = os.environ["PKG"]
pm = importlib.import_module(PKG + ".parallel.mesh")
ovl = importlib.import_module(PKG + ".parallel.overlap")
DEBUG_PRESETS = importlib.import_module(PKG + ".models.registry").DEBUG_PRESETS
tl = importlib.import_module(PKG + ".models.llama")
ModelRunner = importlib.import_module(PKG + ".engine.runner").ModelRunner
rank = int(os.environ["RANK"])
pm.initialize(os.environ["STORE"], 2, rank, "cpu",
              on_bound=lambda port: print(f"PORT {port}", flush=True))
mesh = pm.build_mesh(pm.MeshPlan(model=2), "cpu")
out = {}
same, red = True, ovl.make_reduce(mesh)
for shape in [(4, 1, 64), (3, 5, 96), (2, 1, 6), (1, 2, 10)]:
    xs = [torch.randn(shape, generator=torch.Generator().manual_seed(r))
          * (1 + r) for r in range(2)]
    got = red(xs[rank].clone())
    same &= bool(torch.equal(got, xs[0] + xs[1]))
out["reduce_equal"] = same
out["reduce"] = (red.mode, red.calls, red.seconds > 0)
cfg = dataclasses.replace(DEBUG_PRESETS["small"], dtype="float32")
params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
runs = {}
for mode in ("overlap", "psum", "0"):
    os.environ["LOCALAI_MESH_OVERLAP"] = mode
    r = ModelRunner(cfg, params, mesh=mesh, num_slots=4, max_ctx=128,
                    prefill_buckets=[32], kv_dtype="float32",
                    kv_block_tokens=16, device="cpu")
    firsts = [r.admit(r.acquire_slot(), list(p), temperature=0.0)
              for p in (b"overlap or psum", b"the same bytes", b"abc")]
    rows = r.step_n(10)
    lg = r.prompt_logits(list(b"bytes of logits"))
    runs[mode] = (firsts, rows.tolist(), lg.tobytes().hex(),
                  r.reduce.mode, r.reduce.calls, r.overlap_mode)
out["runs"] = runs
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
pm.destroy()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(script: str, n: int, env: dict) -> tuple[list, list]:
    """Start ``script`` as ``n`` ranks of one group: rank 0 first, with
    ``STORE`` at port 0 (its store binds a free port itself and prints
    ``PORT <n>``), then the others at that port. Returns the processes
    and the output rank 0 printed until then."""
    first = subprocess.Popen(
        [sys.executable, "-c", script],
        env={**env, "RANK": "0", "STORE": "127.0.0.1:0"}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    head = []
    for line in first.stdout:
        head.append(line)
        if line.startswith("PORT "):
            break
    else:
        first.wait(30)
        raise AssertionError("rank 0 bound no store: " + "".join(head))
    store = f"127.0.0.1:{int(head[-1].split()[1])}"
    procs = [first] + [subprocess.Popen(
        [sys.executable, "-c", script],
        env={**env, "RANK": str(r), "STORE": store}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(1, n)]
    return procs, head


@pytest.fixture(scope="module")
def two_rank_group():
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "PKG": tmh.__name__.split(".")[0],
           "OMP_NUM_THREADS": "1", "LOCALAI_MESH_TIMEOUT_S": "120"}
    procs, head = start_ranks(GROUP_SCRIPT, 2, env)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs[0] = "".join(head) + outs[0]
    assert all(p.returncode == 0 for p in procs), outs
    line = next(ln for ln in outs[0].splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_psum_reduce_is_the_ranks_sum_bytewise(two_rank_group):
    assert two_rank_group["reduce_equal"]
    assert two_rank_group["reduce"] == ["psum", 4, True]


def test_overlap_setting_keeps_the_psum_bytes(two_rank_group):
    runs = two_rank_group["runs"]
    # the JAX package's decision, reported; the port's reduction, run
    assert [runs[m][5] for m in ("overlap", "psum", "0")] == [
        "overlap", "psum", ""]
    assert all(runs[m][3] == "psum" for m in runs)
    # two reductions a layer a forward, the same count every way
    assert runs["overlap"][4] == runs["psum"][4] == runs["0"][4] > 0
    assert runs["overlap"][:3] == runs["psum"][:3] == runs["0"][:3]


def _models_dir(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    (models / "m.yaml").write_text(json.dumps({
        "name": "m", "model": "debug:tiny",
        "engine": {"dtype": "float32", "kv_dtype": "float32"}}))
    return models


def test_follower_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the follower would run on it")
    models = _models_dir(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "LOCALAI_DEVICE"}
    res = subprocess.run(
        [sys.executable, "-m", cli.__name__, "follower", "--leader",
         "127.0.0.1:1", "--model", "m", "--models-path", str(models),
         "--coordinator", "127.0.0.1:1", "--num-processes", "2",
         "--process-id", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**env, "PYTHONPATH": str(REPO)})
    assert res.returncode != 0
    assert "no CUDA device is visible" in res.stderr


def test_multi_host_form_serves_with_a_follower_started_by_hand(
        tmp_path, monkeypatch):
    """The multi-host form on one machine: ``cli.main follower`` started
    by hand (``--coordinator``, ``--num-processes 2``, ``--process-id
    1``), and the server built from ``LOCALAI_COORDINATOR_ADDRESS``,
    ``LOCALAI_NUM_PROCESSES`` and ``LOCALAI_MIRROR_PORT``, which joins the
    group and opens the channel before any model loads. A greedy
    completion equals one device's; the follower exits 0 at shutdown with
    the leader's digest."""
    import urllib.request

    from localai_tpu_torch.parallel import multihost as mh

    from localai_tpu_torch.parallel import mesh as tmesh

    models = _models_dir(tmp_path)
    mirror = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "LOCALAI_MESH_TIMEOUT_S": "120"}
    # the leader's store binds a free port itself (coordinator port 0);
    # the follower is started at the port it bound
    for k, v in {"LOCALAI_COORDINATOR_ADDRESS": "127.0.0.1:0",
                 "LOCALAI_NUM_PROCESSES": "2", "LOCALAI_PROCESS_ID": "0",
                 "LOCALAI_MIRROR_PORT": str(mirror),
                 "LOCALAI_MIRROR_FOLLOWERS": "1", "LOCALAI_PEER_TOKEN": "tok",
                 "LOCALAI_MESH_TIMEOUT_S": "120"}.items():
        monkeypatch.setenv(k, v)
    body = json.dumps({"model": "m", "prompt": "multi host",
                       "max_tokens": 12, "temperature": 0}).encode()
    built: list = []

    def build():
        try:
            built.append(cli.build_server([
                "run", "--device", "cpu", "--address", "127.0.0.1",
                "--port", "0", "--models-path", str(models)]))
        except BaseException as e:  # noqa: BLE001 — raised below
            built.append(e)

    booting = threading.Thread(target=build, daemon=True)
    booting.start()
    deadline = time.monotonic() + 60
    while not tmesh.bound_port() and booting.is_alive():
        assert time.monotonic() < deadline, "the leader bound no store"
        time.sleep(0.05)
    follower = subprocess.Popen(
        [sys.executable, "-m", cli.__name__, "follower", "--leader",
         f"127.0.0.1:{mirror}", "--model", "m", "--models-path",
         str(models), "--coordinator",
         f"127.0.0.1:{tmesh.bound_port()}", "--num-processes", "2",
         "--process-id", "1", "--peer-token", "tok", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        booting.join(180)
        if isinstance(built[0], BaseException):
            raise built[0]
        server = built[0].start()
        try:
            req = urllib.request.Request(
                server.url + "/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            got = json.loads(urllib.request.urlopen(req, timeout=120).read())
            sm = server.manager.get("m")
            assert sm.runner.mesh.tp == 2 and not mh.current_group().spawned
            digest = sm.runner.digest.hexdigest()
        finally:
            server.shutdown()
        out, _ = follower.communicate(timeout=120)
    finally:
        if follower.poll() is None:
            follower.kill()
    assert follower.returncode == 0, out
    report = json.loads(next(
        ln for ln in out.splitlines()
        if ln.startswith(tmh.REPORT_PREFIX))[len(tmh.REPORT_PREFIX):])
    assert report["models"]["m"]["digest"] == digest
    for k in ("LOCALAI_COORDINATOR_ADDRESS", "LOCALAI_NUM_PROCESSES",
              "LOCALAI_MIRROR_PORT"):
        monkeypatch.delenv(k)
    solo = cli.build_server(["run", "--device", "cpu", "--address",
                             "127.0.0.1", "--port", "0", "--models-path",
                             str(models)]).start()
    try:
        req = urllib.request.Request(
            solo.url + "/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        want = json.loads(urllib.request.urlopen(req, timeout=120).read())
    finally:
        solo.shutdown()
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]


def _tp_manager(models, config_dir=None):
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager

    loader = ConfigLoader(config_dir or models)
    loader.load_from_path()
    return ModelManager(AppConfig(model_path=str(models), device="cpu",
                                  mesh_shape={"model": 2}), loader)


def test_a_follower_that_fails_to_start_fails_the_load(tmp_path,
                                                       monkeypatch):
    """The spawned follower reads the models dir the server was given;
    where it cannot find the model it exits before joining, and the
    leader's load fails at once naming the follower's exit, with no
    group left behind."""
    from localai_tpu_torch.parallel import multihost as mh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("LOCALAI_MESH_TIMEOUT_S", "120")
    empty = tmp_path / "empty"
    empty.mkdir()
    mgr = _tp_manager(empty, config_dir=_models_dir(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="follower rank 1 exited"):
            mgr.get("m")
        assert mh.current_group() is None
    finally:
        mgr.shutdown()


def test_a_leader_that_loses_its_follower_fails_its_engine(tmp_path,
                                                          monkeypatch):
    """SIGKILL of the follower: the leader's next engine call raises
    instead of serving half a model (or hanging in a collective)."""
    import time

    from localai_tpu_torch.engine.scheduler import GenRequest
    from localai_tpu_torch.parallel import multihost as mh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("LOCALAI_MESH_TIMEOUT_S", "120")
    mgr = _tp_manager(_models_dir(tmp_path))
    try:
        sm = mgr.get("m")
        first = sm.scheduler.generate(GenRequest(
            prompt=list(b"alive"), max_new_tokens=4, temperature=0.0),
            timeout=120)
        assert len(first.token_ids) == 4
        group = mh.current_group()
        group.followers[0].proc.kill()
        deadline = time.monotonic() + 30
        while not group.leader.dead and time.monotonic() < deadline:
            time.sleep(0.1)
        assert "exited" in group.leader.dead
        with pytest.raises(RuntimeError, match="lost a rank"):
            sm.runner.step()
    finally:
        mgr.shutdown()


def test_a_reload_after_a_lost_rank_spawns_a_new_group(tmp_path,
                                                       monkeypatch):
    """After SIGKILL of the follower, reloading the model (the manager's
    answer to a failed engine) spawns a new group and serves the same
    greedy tokens."""
    from localai_tpu_torch.engine.scheduler import GenRequest
    from localai_tpu_torch.parallel import multihost as mh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("LOCALAI_MESH_TIMEOUT_S", "120")
    req = dict(prompt=list(b"again"), max_new_tokens=6, temperature=0.0)
    mgr = _tp_manager(_models_dir(tmp_path))
    try:
        first = mgr.get("m").scheduler.generate(GenRequest(**req),
                                                timeout=120).token_ids
        old = mh.current_group()
        old.followers[0].proc.kill()
        old.followers[0].proc.wait(30)
        old._watch_once()
        mgr.shutdown_model("m", force=True)
        again = mgr.get("m").scheduler.generate(GenRequest(**req),
                                                timeout=120).token_ids
        assert mh.current_group() is not old
        assert again == first
    finally:
        mgr.shutdown()
