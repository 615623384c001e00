"""Pipeline parallelism on the CPU: the port's ``pipe=2`` stages against
one device and the JAX package's stage chain (the port's counterparts of
``tests/test_pipeline.py``).

* One gloo group of 2 ranks (two processes, the race-free store of
  ``parallel.mesh``): each stage of debug:small (4 layers) keeps layers
  [2s, 2s + 2) and a cache of those layers only, embed and lm_head whole;
  greedy tokens of the stage chain equal one device's and the JAX
  package's runner on ``MeshPlan(pipe=2)`` (``pp_forward``); the resume
  path (a suffix prefill over a kept prefix) after a release, and an int8
  cache, give one device's tokens.
* The gates, as the JAX runner's: ``pipe`` with ``data``, ``model`` or
  ``seq``; ``pipe=3`` on a 4-layer model; self-extend; the paged layout.
  ``attn_impl`` reports the JAX package's ``xla``, and a stage keeps one
  card's load-time gate on the shapes K2/K3 take.
* ``sharding: {pipeline_parallel_size: 2}`` through the port's server
  (the manager spawns the second stage; contiguous, as the JAX package
  chooses): greedy completions equal the JAX server's byte for byte, in
  float32 and with int8 weights and cache (the plain K4 twin on the CPU);
  each stage's report holds half the layers' bytes and the leader's
  digest.

Each group gets 120 s (``LOCALAI_MESH_TIMEOUT_S``).
"""

import dataclasses
import json
import os
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu.api.server import AppState as JaxAppState  # noqa: E402
from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.parallel import mesh as jmesh  # noqa: E402
from localai_tpu.parallel.pipeline import shard_params_pp  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner, attention_path  # noqa: E402,E501
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from localai_tpu_torch.parallel import multihost as tmh  # noqa: E402
from test_api import _ServerThread  # noqa: E402
from test_torch_llama import write_hf_checkpoint  # noqa: E402
from test_torch_parallel_mirror import start_ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PROMPT = list(range(1, 40))
RUNNER = dict(num_slots=2, max_ctx=256, prefill_buckets=[64])

GROUP_SCRIPT = r"""
import dataclasses, importlib, json, os
import numpy as np, torch
torch.set_num_threads(1)
PKG = os.environ["PKG"]
pm = importlib.import_module(PKG + ".parallel.mesh")
tl = importlib.import_module(PKG + ".models.llama")
ModelRunner = importlib.import_module(PKG + ".engine.runner").ModelRunner
mh = importlib.import_module(PKG + ".parallel.multihost")
rank = int(os.environ["RANK"])
pm.initialize(os.environ["STORE"], 2, rank, "cpu",
              on_bound=lambda port: print(f"PORT {port}", flush=True))
mesh = pm.build_mesh(pm.MeshPlan(pipe=2), "cpu")
data = np.load(os.environ["INPUTS"])
cfg = tl.LlamaConfig(**json.loads(os.environ["CFG"]))
tree = {"layers": {}}
for k in data.files:
    path = k.split("/")
    (tree["layers"] if path[0] == "layers" else tree)[path[-1]] = data[k]
full = tl.params_from_numpy(tree, cfg, "cpu")
stage = tl.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
KW = dict(num_slots=2, max_ctx=256, prefill_buckets=[64], device="cpu",
          paged=False)
PROMPT = list(range(1, 40))

def greedy(r, n=7):
    s = r.acquire_slot()
    out = [r.admit(s, PROMPT, temperature=0.0)]
    while len(out) < n:
        out.append(int(r.step()[s]))
    return out

def resume(r):
    s = r.acquire_slot()
    first = r.admit(s, PROMPT, temperature=0.0)
    toks = [int(t[s]) for t in r.step_n(2)]
    r.release(s)
    s2 = r.acquire_slot(s)
    r.admit(s2, PROMPT + [77, 78], resident=PROMPT + [first] + toks,
            temperature=0.0)
    return r.last_prefill_path, r.last_prefix_reused, int(r.step()[s2])

out = {}
r = ModelRunner(cfg, stage, mesh=mesh, kv_dtype="float32", **KW)
out["layers"] = int(r.params["layers"]["wq"].shape[0])
out["cache_layers"] = int(r.kv.k.shape[0])
out["weight_bytes"] = mh._tree_bytes(r.params)
out["attn_impl"] = r.attn_impl
out["greedy"] = greedy(r)
out["greedy_one"] = greedy(ModelRunner(cfg, full, kv_dtype="float32", **KW))
out["handoffs"] = [r.transfers[k].calls
                   for k in ("handoff_sent", "handoff_waited")]
out["resume"] = resume(ModelRunner(cfg, stage, mesh=mesh,
                                   kv_dtype="float32", **KW))
out["resume_one"] = resume(ModelRunner(cfg, full, kv_dtype="float32", **KW))
out["int8"] = greedy(ModelRunner(cfg, stage, mesh=mesh, kv_dtype="int8",
                                 **KW), 5)
out["int8_one"] = greedy(ModelRunner(cfg, full, kv_dtype="int8", **KW), 5)
lg = ModelRunner(cfg, stage, mesh=mesh, kv_dtype="float32",
                 **KW).prompt_logits(PROMPT)
out["logits"] = lg.tobytes().hex()
out["logits_one"] = ModelRunner(cfg, full, kv_dtype="float32",
                                **KW).prompt_logits(PROMPT).tobytes().hex()
print("RESULT " + json.dumps(out), flush=True)
pm.destroy()
"""


def _cfg():
    return dataclasses.replace(J_PRESETS["small"], dtype="float32")


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Both stages' results, and the JAX tree they were built from."""
    root = tmp_path_factory.mktemp("pipe")
    cfg = _cfg()
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0),
                                                     cfg))
    np.savez(root / "inputs.npz",
             **{k: v for k, v in params.items() if k != "layers"},
             **{f"layers/{k}": v for k, v in params["layers"].items()})
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "PKG": tmh.__name__.split(".")[0], "OMP_NUM_THREADS": "1",
           "LOCALAI_MESH_TIMEOUT_S": "120",
           "INPUTS": str(root / "inputs.npz"),
           "CFG": json.dumps(dataclasses.asdict(cfg))}
    procs, head = start_ranks(GROUP_SCRIPT, 2, env)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs[0] = "".join(head) + outs[0]
    assert all(p.returncode == 0 for p in procs), outs
    got = [json.loads(next(ln for ln in o.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])
           for o in outs]
    return got, params


def _jax_pipe_runner(params, **kw):
    mesh = jmesh.build_mesh(jmesh.MeshPlan(pipe=2),
                            devices=jax.devices()[:2])
    sp = shard_params_pp(jax.tree.map(jax.numpy.asarray, params), _cfg(),
                         mesh)
    return JaxRunner(_cfg(), sp, mesh=mesh, **RUNNER, **kw)


def _jax_greedy(r, n=7):
    s = r.acquire_slot()
    out = [r.admit(s, PROMPT, temperature=0.0)]
    while len(out) < n:
        out.append(int(r.step()[s]))
    return out


def test_weights_and_cache_are_layer_sharded(stages):
    got, params = stages
    L = _cfg().num_layers
    layer_bytes = sum(v.nbytes for v in params["layers"].values())
    rest = sum(v.nbytes for k, v in params.items() if k != "layers")
    for g in got:
        assert g["layers"] == g["cache_layers"] == L // 2
        # each stage: half the layers' bytes, embed / norm / lm_head whole
        assert g["weight_bytes"] == layer_bytes // 2 + rest
        assert g["attn_impl"] == "xla"


def test_greedy_equals_one_device_and_the_jax_stage_chain(stages):
    got, params = stages
    want = _jax_greedy(_jax_pipe_runner(params, kv_dtype="float32"))
    for g in got:
        assert g["greedy"] == g["greedy_one"] == want
        # each forward: a receive (waited) or a send (sent), and the
        # final broadcast (sent by the last stage, waited for by the other)
        assert g["handoffs"] == [7, 7]
    assert got[0]["logits"] == got[1]["logits"]
    np.testing.assert_allclose(
        np.frombuffer(bytes.fromhex(got[0]["logits"]), np.float32),
        np.frombuffer(bytes.fromhex(got[0]["logits_one"]), np.float32),
        rtol=0, atol=1e-5)


def test_prefix_resume_and_release_through_the_stages(stages):
    got, _ = stages
    for g in got:
        path, reused, tok = g["resume"]
        assert path == "resume" and reused >= 16
        assert g["resume"] == g["resume_one"]


def test_int8_cache_through_the_stages(stages):
    got, params = stages
    want = _jax_greedy(_jax_pipe_runner(params, kv_dtype="int8"), 5)
    for g in got:
        assert g["int8"] == g["int8_one"] == want


def _port_cfg():
    return tl.LlamaConfig(**dataclasses.asdict(_cfg()))


@pytest.mark.parametrize("plan,match", [
    (dict(data=2, pipe=2), "ROADMAP item 19 part 2"),
    (dict(model=2, pipe=2), "composes with no other axis"),
    (dict(seq=2, pipe=2), "composes with no other axis"),
    (dict(pipe=3), "not divisible by pipe=3"),
])
def test_pipe_gates_as_the_jax_runner(plan, match):
    mesh = tmesh.Mesh.abstract(tmesh.MeshPlan(**plan))
    with pytest.raises(ValueError, match=match):
        ModelRunner(_port_cfg(), {}, mesh=mesh, paged=False, device="cpu",
                    **RUNNER)


def test_pipe_refuses_self_extend_and_the_paged_layout():
    mesh = tmesh.Mesh.abstract(tmesh.MeshPlan(pipe=2))
    with pytest.raises(ValueError, match="self-extend"):
        ModelRunner(_port_cfg(), {}, mesh=mesh, paged=False, ga_n=2,
                    ga_w=64, device="cpu", **RUNNER)
    with pytest.raises(ValueError, match="pipeline parallelism"):
        ModelRunner(_port_cfg(), {}, mesh=mesh, paged=True, device="cpu",
                    **RUNNER)
    jmesh2 = jmesh.build_mesh(jmesh.MeshPlan(pipe=2),
                              devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="pipeline parallelism"):
        JaxRunner(_cfg(), {}, mesh=jmesh2, paged=True, **RUNNER)


CARD = dict(device=torch.device("cuda"), ga_n=1, num_heads=32,
            num_kv_heads=8, head_dim=128, dtype=torch.bfloat16,
            kv_dtype=torch.bfloat16, max_ctx=4096)


@pytest.mark.parametrize("bad", [
    dict(head_dim=96), dict(num_heads=136), dict(kv_dtype="int4"),
    dict(kv_dtype=torch.float32), dict(kv_dtype="int8", max_ctx=4098)])
def test_pipe_stage_keeps_the_load_time_kernel_gate(bad):
    """A stage runs K2/K3 on its own layers: a shape they cannot take is
    refused at load on the card path, with one card's message, and the
    stage reports the JAX package's "xla" for a shape they take."""
    with pytest.raises(ValueError) as one:
        attention_path(**{**CARD, **bad}, pp=False)
    with pytest.raises(ValueError) as stage:
        attention_path(**{**CARD, **bad}, pp=True)
    assert str(stage.value) == str(one.value)
    assert attention_path(**CARD, pp=False) == ("kernel", "")
    assert attention_path(**CARD, pp=True)[0] == "xla"
    assert attention_path(**{**CARD, "device": torch.device("cpu")},
                          pp=True)[0] == "xla"


# ---------------------------------------------------------------------------
# pipeline_parallel_size: 2 through both servers

BASE = {"dtype": "float32", "max_slots": 4, "prefill_buckets": [32, 64]}
MODELS = {"dense": {"engine": {**BASE, "kv_dtype": "float32"}},
          "q8": {"engine": {**BASE, "kv_dtype": "int8",
                            "quantization": "int8"}}}
PROMPTS = ["the stages hand the hidden on", "abcabcabcabc", "hello"]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe2")
    cfg = dataclasses.replace(J_PRESETS["small"], dtype="float32",
                              max_position_embeddings=256)
    params = jl.init_params(jax.random.key(0), cfg)
    ckpt = write_hf_checkpoint(root / "ckpt", cfg, params)
    models = root / "models"
    models.mkdir()
    for name, doc in MODELS.items():
        (models / f"{name}.yaml").write_text(json.dumps(
            {"name": name, "model": str(ckpt), "context_size": 256,
             "sharding": {"pipeline_parallel_size": 2}, **doc}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("LOCALAI_MESH_TIMEOUT_S", "120")
        loader = ConfigLoader(models)
        loader.load_from_path(context_size=256)
        port = APIServer(ModelManager(AppConfig(
            model_path=str(models), device="cpu",
            upload_path=str(root / "up"), config_path=str(root / "cf")),
            loader), "127.0.0.1", 0).start()
        jcfg = JaxAppConfig(model_path=str(models),
                            upload_path=str(root / "jup"),
                            config_path=str(root / "jcf"))
        jloader = JaxLoader(models)
        jloader.load_from_path(context_size=256)
        ref = _ServerThread(JaxAppState(jcfg, jloader))
        try:
            yield port.url, ref.base, port, ref
        finally:
            ref.stop()
            port.shutdown()


@pytest.mark.parametrize("model", list(MODELS))
def test_pipe2_server_completions_equal_the_jax_server(servers, model):
    port, ref = servers[0], servers[1]
    for prompt in PROMPTS:
        body = {"model": model, "prompt": prompt, "max_tokens": 16,
                "temperature": 0}
        got = _post(port + "/v1/completions", body)
        want = _post(ref + "/v1/completions", body)
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        assert got["usage"] == want["usage"]
    runner = servers[2].manager.get(model).runner
    jrunner = servers[3].state.manager.get(model).runner
    assert runner.pp_enabled and jrunner.pp_enabled
    assert not runner.paged and not jrunner.paged
    assert runner.mesh.shape["pipe"] == 2
    assert runner.local_cfg.num_layers == 2
    assert type(runner).__name__ == "MirroredRunner"


def test_pipe2_stage_reports_hold_half_the_layers(servers):
    """Last: stop the port's server; the second stage's report carries
    the leader's digest and weight bytes (both stages hold the same
    count: half the layers, the rest whole)."""
    server = servers[2]
    want = {name: (sm.runner.digest.hexdigest(),
                   tmh._tree_bytes(sm.runner.params))
            for name, sm in server.manager._models.items()}
    assert set(want) == set(MODELS)
    before = len(tmh.REPORTS)
    server.shutdown()
    reports = tmh.REPORTS[before:]
    assert [r["rank"] for r in reports] == [1]
    assert reports[0]["errors"] == 0
    for name, (digest, nbytes) in want.items():
        rm = reports[0]["models"][name]
        assert (rm["digest"], rm["weight_bytes"]) == (digest, nbytes), name
        assert rm["fresh_prefills"] == len(PROMPTS)
