"""The worker tier's fleet half on the port, against the JAX package's.

  * ``pinning_env`` on one table of (index, replicas, devices): the port's
    ``CUDA_VISIBLE_DEVICES`` slice is the JAX package's
    ``TPU_VISIBLE_DEVICES`` slice, {} where it gives {};
  * ``backend: worker`` spawns a worker process and ``external_backends``
    routes a model to a worker's address in both managers, with equal
    greedy texts; a worker that cannot load is an error in both;
  * a worker-backed fleet (2 decode + 1 prefill worker processes) serves
    the JAX fleet's texts for affinity, the disaggregated handoff and a
    failover after SIGKILL, and respawns the killed worker;
  * remote replicas: a stopped remote is evicted, redialed and rejoins
    when it comes back on its port, with the JAX fleet's counters;
  * ``POST /federated/register`` on both HTTP servers: equal statuses and
    bodies for a good token, a wrong one, an unroutable address, a
    duplicate, a missing address, an unknown role and a model that is not
    fleet-served; the swap route takes the same peer-token guard;
  * the CLI's ``worker`` subcommand serves a worker.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

from localai_tpu.config.app_config import AppConfig as JaxApp  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.fleet import FleetServingModel as JaxFleet  # noqa: E402
from localai_tpu.fleet import pinning as jpinning  # noqa: E402
from localai_tpu.models.manager import ModelManager as JaxManager  # noqa: E402
from localai_tpu.worker import server as jserver  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.fleet import FleetServingModel  # noqa: E402
from localai_tpu_torch.fleet import pinning  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402
from localai_tpu_torch.worker import server  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WAIT = 120.0
ENGINE = {"dtype": "float32", "kv_dtype": "float32", "kv_block_tokens": 16,
          "max_slots": 4}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("wfleet")
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    return write_llama_checkpoint(root / "tiny", tiny.cfg, tiny.params)


def _models(root: Path, ckpt, **extra) -> Path:
    models = root / "models"
    models.mkdir(exist_ok=True)
    (models / "tiny.yaml").write_text(yaml.safe_dump({
        "name": "tiny", "model": str(ckpt), "context_size": 256,
        "engine": ENGINE, **extra}))
    return models


def _managers(models: Path, **app):
    loader = ConfigLoader(str(models))
    loader.load_from_path(context_size=256)
    jloader = JaxLoader(str(models))
    jloader.load_from_path(context_size=256)
    return (ModelManager(AppConfig(model_path=str(models), device="cpu",
                                   **app), loader),
            JaxManager(JaxApp(model_path=str(models), **app), jloader))


def _gen(sm, Req, text, max_new=6, **kw):
    h = sm.scheduler.submit(Req(prompt=list(text.encode()),
                                max_new_tokens=max_new, temperature=0.0,
                                **kw))
    h.result(timeout=WAIT)
    return h


def _pid_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    # a zombie of this process's child counts as gone once reaped
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        return False


# -- device pinning -----------------------------------------------------------

PIN_TABLE = [(i, n, d) for n, d in ((1, 1), (2, 8), (4, 8), (3, 8), (2, 1),
                                    (3, 1), (4, 2), (8, 8), (2, 3))
             for i in range(n)]


@pytest.mark.parametrize("index,replicas,devices", PIN_TABLE,
                         ids=[f"{i}of{n}-{d}dev" for i, n, d in PIN_TABLE])
def test_pinning_env_equals_the_jax_package(index, replicas, devices):
    got = pinning.pinning_env(index, replicas, platform="cuda",
                              n_devices=devices)
    want = jpinning.pinning_env(index, replicas, platform="tpu",
                                n_devices=devices)
    if not want:
        assert got == {}
    else:
        assert got == {"CUDA_VISIBLE_DEVICES": want["TPU_VISIBLE_DEVICES"]}
    cpu = pinning.pinning_env(index, replicas, platform="cpu",
                              n_devices=devices)
    jcpu = jpinning.pinning_env(index, replicas, platform="cpu",
                                n_devices=devices)
    assert cpu == ({"LOCALAI_DEVICE": "cpu"} if jcpu else {})


def test_pinning_env_refusals_and_unknown_platforms():
    assert pinning.pinning_env(0, 2, platform="rocm", n_devices=8) == {}
    assert jpinning.pinning_env(0, 2, platform="rocm", n_devices=8) == {}
    for mod, plat in ((pinning, "cuda"), (jpinning, "tpu")):
        with pytest.raises(ValueError):
            mod.pinning_env(5, 4, platform=plat, n_devices=8)


def test_pinned_worker_env_and_declared_topology(monkeypatch):
    monkeypatch.setenv("LOCALAI_FLEET_PIN_PLATFORM", "cuda")
    monkeypatch.setenv("LOCALAI_FLEET_PIN_DEVICES", "8")
    assert pinning.derive_pinning_env(1, 4) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    merged = pinning.pinned_worker_env(
        {"CUDA_VISIBLE_DEVICES": "6,7", "MY_FLAG": "1"}, 0, 2)
    assert merged == {"CUDA_VISIBLE_DEVICES": "6,7", "MY_FLAG": "1"}
    assert pinning.pinned_worker_env({}, 1, 2) == {
        "CUDA_VISIBLE_DEVICES": "4,5,6,7"}
    # no declared topology and no card: one CPU device, two replicas
    # cannot split it and spawn unpinned
    monkeypatch.delenv("LOCALAI_FLEET_PIN_PLATFORM")
    if not torch.cuda.is_available():
        assert pinning.derive_pinning_env(0, 1) == {"LOCALAI_DEVICE": "cpu"}
        assert pinning.derive_pinning_env(0, 2) == {}


# -- backend: worker and external_backends ------------------------------------

def test_external_backends_route_to_the_worker_in_both_managers(
        tmp_path, ckpt, monkeypatch):
    monkeypatch.setenv("LOCALAI_DEVICE", "cpu")
    models = _models(tmp_path, ckpt)
    servers = []
    try:
        for mod in (server, jserver):
            sv = mod.BackendServicer()
            srv, port = mod.serve_worker("127.0.0.1:0", servicer=sv,
                                         block=False)
            servers.append((srv, sv, f"127.0.0.1:{port}"))
        mgr, jmgr = _managers(models)
        mgr.app.external_backends = {"tiny": servers[0][2]}
        jmgr.app.external_backends = {"tiny": servers[1][2]}
        try:
            sm, jsm = mgr.get("tiny"), jmgr.get("tiny")
            assert type(sm).__name__ == type(jsm).__name__ == \
                "WorkerServingModel"
            assert sm.external_address == servers[0][2]
            assert sm.alive() and jsm.alive()
            texts = [(_gen(sm, GenRequest, t).text,
                      _gen(jsm, JaxGenRequest, t).text)
                     for t in ("over the wire", "again, streamed")]
            assert all(a == b for a, b in texts), texts
            m = sm.engine_metrics()
            assert "shed_total" in m and "active_slots" in m
        finally:
            mgr.shutdown()
            jmgr.shutdown_all()
    finally:
        for srv, sv, _ in servers:
            sv.shutdown()
            srv.stop(grace=None)


def test_backend_worker_spawns_a_process_in_both_managers(tmp_path, ckpt):
    models = _models(tmp_path, ckpt, backend="worker")
    mgr, jmgr = _managers(models)
    pids = []
    try:
        sm, jsm = mgr.get("tiny"), jmgr.get("tiny")
        assert type(sm).__name__ == type(jsm).__name__ == \
            "WorkerServingModel"
        wp = sm.pool.process("tiny")
        pids = [wp.pid, jsm.pool._workers["tiny"].proc.pid]
        assert wp.pid != os.getpid() and sm.alive() and jsm.alive()
        for text in ("a worker process", "serves this"):
            assert _gen(sm, GenRequest, text).text == \
                _gen(jsm, JaxGenRequest, text).text
        # the engine is in the worker: the serving instance holds none
        assert not hasattr(sm, "runner")
    finally:
        mgr.shutdown()
        jmgr.shutdown_all()
    deadline = time.monotonic() + 15
    while pids and not all(_pid_gone(p) for p in pids) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(_pid_gone(p) for p in pids)


def test_backend_worker_that_cannot_load_is_an_error(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    # a directory the tokenizer resolves (bytes) and no weights load from
    (tmp_path / "empty-checkpoint").mkdir()
    (models / "gone.yaml").write_text(yaml.safe_dump({
        "name": "gone", "backend": "worker",
        "model": str(tmp_path / "empty-checkpoint"), "engine": ENGINE}))
    mgr, jmgr = _managers(models)
    try:
        for m in (mgr, jmgr):
            with pytest.raises(Exception, match="LoadModel failed"):
                m.get("gone")
        assert mgr.loaded_names() == []
    finally:
        mgr.shutdown()
        jmgr.shutdown_all()


# -- a worker-backed fleet -------------------------------------------------------

FLEET_APP = dict(fleet_replicas=2, fleet_prefill_replicas=1,
                 fleet_disagg_threshold=64)


def _gate_sweeps(pool):
    """The pool's health sweeps behind ``pool.sweep_gate`` (a drill that
    holds it runs with no sweep in between)."""
    pool.sweep_gate = threading.Lock()
    sweep = pool.poll_once

    def gated():
        with pool.sweep_gate:
            sweep()

    pool.poll_once = gated


def test_worker_fleet_serves_as_the_jax_fleet(tmp_path, ckpt):
    models = _models(tmp_path, ckpt)
    mgr, jmgr = _managers(models, **FLEET_APP)
    jmgr.app.fleet_backend = "inprocess"     # the JAX texts, one process
    fm = None
    try:
        fm, jfm = mgr.get("tiny"), jmgr.get("tiny")
        for f in (fm, jfm):
            _gate_sweeps(f.pool)
        kinds = {type(r).__name__ for r in fm.pool.members()}
        assert kinds == {"WorkerReplica"}
        pids = {r.id: r.pid for r in fm.pool.members()}
        assert len(set(pids.values())) == 3 and os.getpid() not in pids
        # affinity: one decode replica serves a shared prompt
        text = "the same shared prompt prefix, ask"
        for _ in range(2):
            assert _gen(fm, GenRequest, text).text == \
                _gen(jfm, JaxGenRequest, text).text
        served = [r.id for r in fm.pool.members()
                  if r.role == "decode" and r.dispatched]
        assert len(served) == 1
        # disaggregated: the prefix crosses the wire to a decode worker
        long = "a long prompt that prefills on the prefill replica " * 2
        h, jh = _gen(fm, GenRequest, long), _gen(jfm, JaxGenRequest, long)
        assert h.text == jh.text
        assert fm.scheduler.prefix_transfers == \
            jfm.scheduler.prefix_transfers == 1
        assert fm.scheduler.prefix_transfer_bytes > 0
        # failover: SIGKILL the worker the next prompt routes to
        prompt = "fail me over, please"
        with fm.pool.sweep_gate:
            target, _ = fm.router.route(list(prompt.encode()))
            old_pid = target.pid
            target.kill()
            h = _gen(fm, GenRequest, prompt)
        assert h.text == _gen(jfm, JaxGenRequest, prompt).text
        assert fm.scheduler.failovers == 1
        deadline = time.monotonic() + WAIT
        while target.state != "healthy" and time.monotonic() < deadline:
            time.sleep(0.1)
        assert target.state == "healthy" and target.pid != old_pid
        assert fm.pool.respawns == 1 and fm.pool.evictions == 0
    finally:
        mgr.shutdown()
        jmgr.shutdown_all()
    # every worker stopped in order reported its (CPU: zero) launches
    reports = [rep for r in fm.pool.members() for rep in r.launch_reports]
    assert len(reports) >= 3
    assert all(rep["launches"]["paged_decode_attention"] == 0
               for rep in reports)
    assert sum(rep["decode_steps"] for rep in reports) > 0
    assert all(_pid_gone(p) for p in pids.values())


# -- remote replicas -------------------------------------------------------------

def _worker(mod, port=0):
    sv = mod.BackendServicer()
    srv, port = mod.serve_worker(f"127.0.0.1:{port}", servicer=sv,
                                 block=False)
    return srv, sv, port


def _remote_fleet(jax: bool, ckpt, addrs):
    """A fleet of remote replicas alone (no local replica)."""
    doc = {"name": "tiny", "model": str(ckpt), "context_size": 256,
           "engine": ENGINE}
    if jax:
        mcfg, app, Fleet = JaxModelConfig.model_validate(doc), JaxApp(), \
            JaxFleet
    else:
        mcfg, app, Fleet = ModelConfig.from_dict(doc), \
            AppConfig(device="cpu"), FleetServingModel
    return Fleet(mcfg, app, lambda rid, role: None, replicas=0,
                 remote_hosts=list(addrs), disagg_threshold=1 << 30)


def test_remote_eviction_redial_and_rejoin_as_the_jax_fleet(ckpt,
                                                           monkeypatch):
    """Two remote workers a package; one stops: requests route around it,
    it is evicted (never respawned), and when a worker comes back on its
    port it is redialed, reloaded and rejoins, with the JAX fleet's
    counters."""
    monkeypatch.setenv("LOCALAI_DEVICE", "cpu")
    counters = []
    for mod, jax, Req in ((server, False, GenRequest),
                          (jserver, True, JaxGenRequest)):
        workers = [_worker(mod) for _ in range(2)]
        fm = None
        try:
            fm = _remote_fleet(jax, ckpt,
                               [f"127.0.0.1:{w[2]}" for w in workers])
            pool = fm.pool
            pool.redial_backoff_base = pool.redial_backoff_cap = 0.1
            assert [r.state for r in pool.members()] == ["healthy"] * 2
            assert not any(r.respawnable for r in pool.members())
            victim = pool.members()[0]
            srv, sv, port = workers[0]
            sv.shutdown()
            srv.stop(grace=None)
            time.sleep(0.2)
            handles = [_gen(fm, Req, f"routed around the dead peer {i}")
                       for i in range(3)]
            assert all(h.finish_reason in ("stop", "length")
                       for h in handles)
            deadline = time.monotonic() + 30
            while victim.state != "evicted" and \
                    time.monotonic() < deadline:
                pool.poll_once()
                time.sleep(0.05)
            assert victim.state == "evicted"
            workers[0] = _worker(mod, port)     # back on its port, empty
            deadline = time.monotonic() + 60
            while victim.state != "healthy" and \
                    time.monotonic() < deadline:
                pool.poll_once()
                time.sleep(0.05)
            assert victim.state == "healthy"
            snap = pool.snapshot()
            counters.append({k: snap[k] for k in (
                "evictions", "redials", "respawns", "adoptions")}
                | {"remote": [r["remote"] for r in snap["replicas"]],
                   "backoff": victim.id in pool.redial_backoff_s})
        finally:
            if fm is not None:
                fm.close()
            for srv, sv, _ in workers:
                sv.shutdown()
                srv.stop(grace=None)
    assert counters[0] == counters[1]
    assert counters[0]["evictions"] == counters[0]["redials"] == 1
    assert counters[0]["respawns"] == 0


# -- POST /federated/register ------------------------------------------------------

def _call(url, body=None, token=None, raw=None):
    data = raw if raw is not None else json.dumps(body or {}).encode()
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def register_servers(tmp_path_factory, ckpt):
    """Both HTTP servers, each with ``tiny`` served by a fleet of one
    remote worker of its own package (``fleet_hosts``), a second worker of
    its package to register, and the peer token ``tok``."""
    os.environ["LOCALAI_DEVICE"] = "cpu"
    root = tmp_path_factory.mktemp("register")
    models = _models(root, ckpt)
    made = {}
    try:
        for name, mod in (("port", server), ("jax", jserver)):
            made[name] = [_worker(mod) for _ in range(2)]
        hosts = {k: f"127.0.0.1:{v[0][2]}" for k, v in made.items()}
        loader = ConfigLoader(str(models))
        loader.load_from_path(context_size=256)
        port = APIServer(ModelManager(AppConfig(
            model_path=str(models), device="cpu", peer_token="tok",
            fleet_hosts=[hosts["port"]]), loader), "127.0.0.1", 0).start()
        state = make_state(models)
        state.config.peer_token = "tok"
        state.config.fleet_hosts = [hosts["jax"]]
        ref = _ServerThread(state)
        port.manager.get("tiny")
        state.manager.get("tiny")
        yield {"port": (port.url, made["port"][1][2]),
               "jax": (ref.base, made["jax"][1][2])}
        ref.stop()
        state.manager.shutdown_all()
        port.shutdown()
    finally:
        os.environ.pop("LOCALAI_DEVICE", None)
        for workers in made.values():
            for srv, sv, _ in workers:
                sv.shutdown()
                srv.stop(grace=None)


REGISTER_CASES = [
    ("wrong-token", {"address": "{addr}"}, "nope"),
    ("no-token", {"address": "{addr}"}, None),
    ("no-address", {"role": "decode"}, "tok"),
    ("unroutable", {"address": "0.0.0.0:50051"}, "tok"),
    ("no-port", {"address": "127.0.0.1"}, "tok"),
    ("bad-role", {"address": "{addr}", "role": "both"}, "tok"),
    ("not-fleet-served", {"address": "{addr}", "model": "other"}, "tok"),
    ("good", {"address": "{addr}"}, "tok"),
    ("duplicate", {"address": "{addr}"}, "tok"),
]


@pytest.mark.parametrize("case,body,token", REGISTER_CASES,
                         ids=[c[0] for c in REGISTER_CASES])
def test_federated_register_as_the_jax_server(register_servers, case, body,
                                              token):
    """Equal statuses and bodies (the worker's address, which differs
    between the two, replaced by a placeholder). The cases run in order:
    ``good`` adopts the second worker, ``duplicate`` is refused."""
    out = []
    for name in ("port", "jax"):
        url, wport = register_servers[name]
        addr = f"127.0.0.1:{wport}"
        b = {k: v.replace("{addr}", addr) for k, v in body.items()}
        status, payload = _call(url + "/federated/register", b, token)
        out.append((status, json.loads(json.dumps(payload)
                                       .replace(addr, "{addr}"))))
    assert out[0] == out[1]
    want = {"wrong-token": 401, "no-token": 401, "no-address": 400,
            "unroutable": 400, "no-port": 400, "bad-role": 400,
            "not-fleet-served": 409, "good": 200, "duplicate": 200}[case]
    assert out[0][0] == want
    if case == "good":
        assert out[0][1]["adopted"]["tiny"] == {
            "id": "tiny/{addr}", "adopted": True, "state": "healthy"}
    if case == "duplicate":
        assert out[0][1]["adopted"]["tiny"]["adopted"] is False


def test_swap_takes_the_peer_token_as_the_jax_server(register_servers):
    for name in ("port", "jax"):
        url, _ = register_servers[name]
        status, payload = _call(url + "/v1/fleet/tiny/swap", {}, "nope")
        assert (status, payload) == (401, {"error": "invalid peer token"})


def test_cli_worker_subcommand_serves_a_worker(tmp_path):
    from localai_tpu_torch.cli import main as cli
    from localai_tpu_torch.worker.client import WorkerClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", cli.__name__, "worker", "--addr",
         f"127.0.0.1:{port}"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO), "LOCALAI_DEVICE": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = WorkerClient(f"127.0.0.1:{port}")
    try:
        deadline = time.monotonic() + 60
        while not client.health(timeout=1.0) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert client.health()
        assert client.status().state == 0          # UNINITIALIZED
    finally:
        client.close()
        proc.terminate()
        assert proc.wait(30) == 0
