"""Sequence parallelism on the CPU: the port's ring attention and ring
prefill against the JAX package's, and a ``--mesh seq=2`` server against
the JAX server on ``MeshPlan(seq=2)``.

* One gloo group of 2 ranks and one of 4 (two processes a group, started
  together, each with the race-free store of ``parallel.mesh``): each
  rank runs ``parallel.ring.ring_attention`` on its chunk of seeded
  inputs at ``seq=2`` and ``seq=4``, with and without a sliding window,
  and ``sp_prefill_forward`` over debug:tiny at ``seq=2``, ``seq=4`` and
  ``seq=2 x model=2`` (weights sliced over ``model``). Each rank's chunk
  equals the JAX package's ``ring_attention`` / ``sp_prefill_forward``
  on the virtual CPU mesh of ``tests/conftest.py``: f32 within 2e-5 for
  the attention and 2e-4 for the prefill's hidden rows and K/V (the JAX
  package's own bounds, ``tests/test_ring.py``), on the real rows.
* The refusals: a length the ``seq`` axis does not divide, heads the
  ``model`` axis does not divide, an expert-parallel MoE.
* The port's server at ``seq=2`` (the settings of ``run --mesh seq=2``;
  it spawns its follower rank) on a written f32 debug:small checkpoint
  with ``engine.sp_prefill_threshold: 32``: greedy completions of prompts
  past the threshold equal the JAX server's byte for byte, paged (the
  ring prefill into the block pool, ``paged_sp`` on both) and contiguous
  (``sp``); the follower's stop report carries the leader's digest and
  its ring prefills.

Each group gets 120 s (``LOCALAI_MESH_TIMEOUT_S``).
"""

import concurrent.futures as cf
import dataclasses
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from localai_tpu.api.server import AppState as JaxAppState  # noqa: E402
from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.parallel import mesh as jmesh  # noqa: E402
from localai_tpu.parallel import ring as jring  # noqa: E402
from localai_tpu.parallel import sharding as jshd  # noqa: E402
from localai_tpu.utils.jaxcompat import shard_map  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from localai_tpu_torch.parallel import multihost as tmh  # noqa: E402
from localai_tpu_torch.parallel import ring as tring  # noqa: E402
from test_api import _ServerThread  # noqa: E402
from test_torch_llama import write_hf_checkpoint  # noqa: E402
from test_torch_parallel_mirror import start_ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ATTN_T, ATTN_LEN = 32, 29
PREFILL_T = 64
# (plan, prefill lengths) a group runs, by group width
PLANS = {2: [({"seq": 2}, (64, 37))],
         4: [({"seq": 4}, (64, 57)), ({"seq": 2, "model": 2}, (57,))]}
WINDOWS = (None, 12)

GROUP_SCRIPT = r"""
import dataclasses, importlib, json, os
import numpy as np, torch
torch.set_num_threads(1)
PKG = os.environ["PKG"]
pm = importlib.import_module(PKG + ".parallel.mesh")
ring = importlib.import_module(PKG + ".parallel.ring")
ovl = importlib.import_module(PKG + ".parallel.overlap")
tl = importlib.import_module(PKG + ".models.llama")
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
pm.initialize(os.environ["STORE"], world, rank, "cpu",
              on_bound=lambda port: print(f"PORT {port}", flush=True))
data = np.load(os.environ["INPUTS"])
cfg = tl.LlamaConfig(**json.loads(os.environ["CFG"]))
tree = {"layers": {}}
for k in data.files:
    if k.startswith("p/"):
        path = k[2:].split("/")
        (tree["layers"] if path[0] == "layers" else tree)[path[-1]] = data[k]
out = {}
for plan_kw, lengths in json.loads(os.environ["PLANS"]):
    plan = pm.MeshPlan(**plan_kw)
    mesh = pm.build_mesh(plan, "cpu")
    name = ",".join(f"{k}={v}" for k, v in plan_kw.items())
    n, i = mesh.axis_size("seq"), mesh.axis_rank("seq")
    if mesh.axis_size("model") == 1:
        Tc = data["q"].shape[0] // n
        for w in json.loads(os.environ["WINDOWS"]):
            got = ring.ring_attention(
                *(torch.from_numpy(data[x][i * Tc:(i + 1) * Tc])
                  for x in ("q", "k", "v")),
                int(os.environ["ATTN_LEN"]), n, mesh.groups["seq"], w)
            out[f"attn/{name}/{w}"] = got.numpy()
    params = tl.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    red = ovl.make_reduce(mesh)
    rope = tl.rope_table(cfg, data["tokens"].shape[0], device="cpu")
    for length in lengths:
        hops = ovl.Timed()
        h, (k, v) = ring.sp_prefill_forward(
            cfg, params, torch.from_numpy(data["tokens"]), length, mesh,
            rope, red, hops=hops)
        for key, t in (("h", h), ("k", k), ("v", v)):
            out[f"sp/{name}/{length}/{key}"] = t.numpy()
        out[f"hops/{name}/{length}"] = np.array(hops.calls)
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
print("DONE", flush=True)
pm.destroy()
"""


def _run_group(width: int, env: dict) -> None:
    env = {**env, "WORLD": str(width), "PLANS": json.dumps(PLANS[width]),
           "OUT": str(Path(env["ROOT"]) / f"w{width}")}
    os.makedirs(env["OUT"])
    procs, head = start_ranks(GROUP_SCRIPT, width, env)
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


def _cfg():
    return dataclasses.replace(J_PRESETS["tiny"], dtype="float32")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both groups' chunks: {width: [rank r's outputs]}, and the inputs."""
    root = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    cfg = _cfg()
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0),
                                                     cfg))
    inputs = {
        "q": rng.normal(size=(ATTN_T, 4, 8)).astype(np.float32),
        "k": rng.normal(size=(ATTN_T, 2, 8)).astype(np.float32),
        "v": rng.normal(size=(ATTN_T, 2, 8)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, PREFILL_T).astype(
            np.int32),
        **{f"p/{k}": v for k, v in params.items() if k != "layers"},
        **{f"p/layers/{k}": v for k, v in params["layers"].items()},
    }
    np.savez(root / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "PKG": tmh.__name__.split(".")[0], "OMP_NUM_THREADS": "1",
           "LOCALAI_MESH_TIMEOUT_S": "120", "ROOT": str(root),
           "INPUTS": str(root / "inputs.npz"),
           "CFG": json.dumps(dataclasses.asdict(cfg)),
           "ATTN_LEN": str(ATTN_LEN), "WINDOWS": json.dumps(WINDOWS)}
    with cf.ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda w: _run_group(w, env), PLANS))
    got = {w: [dict(np.load(root / f"w{w}" / f"rank{r}.npz"))
               for r in range(w)] for w in PLANS}
    return got, inputs, params


def _jax_mesh(**plan):
    p = jmesh.MeshPlan(**plan)
    return jmesh.build_mesh(p, devices=jax.devices()[:p.size()])


def _chunks(outs: list, key: str, plan: dict) -> np.ndarray:
    """The ranks' chunks of one output in sequence order (one rank of
    each ``seq`` index: model rank 0's; K/V heads stacked over the
    ``model`` ranks), concatenated along the token axis."""
    tp = plan.get("model", 1)
    axis = 1 if key.endswith(("/k", "/v")) else (
        1 if key.endswith("/h") else 0)
    parts = []
    for s in range(plan["seq"]):
        row = [outs[s * tp + m][key] for m in range(tp)]
        if key.endswith(("/k", "/v")) and tp > 1:
            parts.append(np.concatenate(row, axis=2))
        else:
            parts.append(row[0])
    return np.concatenate(parts, axis=axis)


@pytest.mark.parametrize("window", WINDOWS, ids=["full", "window"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_equals_the_jax_ring(ranks, n, window):
    got, inputs, _ = ranks
    mesh = _jax_mesh(seq=n)

    def local(q_c, k_c, v_c):
        return jring.ring_attention(q_c, k_c, v_c, jnp.int32(ATTN_LEN),
                                    n_chunks=n, sliding_window=window)

    want = np.asarray(shard_map(
        local, mesh=mesh, in_specs=(P("seq"), P("seq"), P("seq")),
        out_specs=P("seq"), check_vma=False)(
            *(jnp.asarray(inputs[x]) for x in ("q", "k", "v"))))
    port = _chunks(got[n], f"attn/seq={n}/{window}", {"seq": n})
    np.testing.assert_allclose(port[:ATTN_LEN], want[:ATTN_LEN], rtol=2e-5,
                               atol=2e-5)


SP_CASES = [(2, {"seq": 2}, 64), (2, {"seq": 2}, 37), (4, {"seq": 4}, 64),
            (4, {"seq": 4}, 57), (4, {"seq": 2, "model": 2}, 57)]


@pytest.mark.parametrize("width,plan,length", SP_CASES,
                         ids=["seq2-full", "seq2-37", "seq4-full", "seq4-57",
                              "seq2-model2-57"])
def test_sp_prefill_equals_the_jax_ring_prefill(ranks, width, plan, length):
    got, inputs, params = ranks
    cfg = _cfg()
    mesh = _jax_mesh(**plan)
    jparams = jax.tree.map(jnp.asarray, params)
    if plan.get("model", 1) > 1:
        jparams = jshd.shard_params(jparams, cfg, mesh)
    hidden, (k, v) = jring.sp_prefill_forward(
        cfg, jparams, jnp.asarray(inputs["tokens"]), jnp.int32(length),
        mesh, jl.rope_table(cfg, PREFILL_T))
    name = ",".join(f"{a}={b}" for a, b in plan.items())
    for key, want in (("h", np.asarray(hidden)), ("k", np.asarray(k)),
                      ("v", np.asarray(v))):
        port = _chunks(got[width], f"sp/{name}/{length}/{key}", plan)
        assert port.shape == want.shape, key
        np.testing.assert_allclose(
            port[:, :length] if key != "h" else port[0, :length],
            want[:, :length] if key != "h" else want[0, :length],
            rtol=2e-4, atol=2e-4, err_msg=key)
    # one hop a layer and a step of the ring, K and V in one exchange
    for outs in got[width]:
        assert int(outs[f"hops/{name}/{length}"]) == (
            cfg.num_layers * (plan["seq"] - 1))


def test_sp_prefill_refusals_are_the_jax_packages():
    cfg = tl.LlamaConfig(**dataclasses.asdict(_cfg()))
    rope = tl.rope_table(cfg, 64, device="cpu")

    def run(cfg, plan, T):
        return tring.sp_prefill_forward(
            cfg, {}, torch.zeros(T, dtype=torch.int32), T,
            tmesh.Mesh.abstract(tmesh.MeshPlan(**plan)), rope)

    with pytest.raises(ValueError, match="not divisible by seq=4"):
        run(cfg, {"seq": 4}, 18)
    with pytest.raises(ValueError, match="not divisible by seq=4"):
        jring.sp_prefill_forward(_cfg(), {}, jnp.zeros(18, jnp.int32),
                                 jnp.int32(18), _jax_mesh(seq=4),
                                 jl.rope_table(_cfg(), 18))
    odd = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3,
                              head_dim=8, hidden_size=24)
    with pytest.raises(ValueError, match="divisible"):
        run(odd, {"seq": 2, "model": 2}, 16)
    moe = tl.LlamaConfig(**dataclasses.asdict(J_PRESETS["tiny-moe"]))
    with pytest.raises(ValueError, match="expert-parallel"):
        run(moe, {"seq": 2, "expert": 2}, 16)


# ---------------------------------------------------------------------------
# the seq=2 server against the JAX server on MeshPlan(seq=2)

BASE = {"dtype": "float32", "max_slots": 4, "kv_block_tokens": 16,
        "prefill_buckets": [32, 64], "sp_prefill_threshold": 32}
PROMPTS = ["a prompt that is long enough for the ring prefill path",
           "short one", "abcabcabcabcabcabcabcabcabcabcabcabcabcabc"]
MODELS = {"paged": {"engine": {**BASE, "kv_dtype": "float32"}},
          "dense": {"engine": {**BASE, "kv_dtype": "float32",
                               "kv_paged": False}}}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq2")
    cfg = dataclasses.replace(J_PRESETS["small"], dtype="float32",
                              max_position_embeddings=256)
    params = jl.init_params(jax.random.key(0), cfg)
    ckpt = write_hf_checkpoint(root / "ckpt", cfg, params)
    models = root / "models"
    models.mkdir()
    for name, doc in MODELS.items():
        (models / f"{name}.yaml").write_text(json.dumps(
            {"name": name, "model": str(ckpt), "context_size": 256, **doc}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("LOCALAI_MESH_TIMEOUT_S", "120")
        build = jmesh.build_mesh
        mp.setattr(jmesh, "build_mesh", lambda plan=None, devices=None:
                   build(plan, devices if devices is not None
                         else jax.devices()[:plan.size()]))
        loader = ConfigLoader(models)
        loader.load_from_path(context_size=256)
        port = APIServer(ModelManager(AppConfig(
            model_path=str(models), device="cpu",
            upload_path=str(root / "up"), config_path=str(root / "cf"),
            mesh_shape={"seq": 2}), loader), "127.0.0.1", 0).start()
        jcfg = JaxAppConfig(model_path=str(models),
                            upload_path=str(root / "jup"),
                            config_path=str(root / "jcf"),
                            mesh_shape={"seq": 2})
        jloader = JaxLoader(models)
        jloader.load_from_path(context_size=256)
        ref = _ServerThread(JaxAppState(jcfg, jloader))
        try:
            yield port.url, ref.base, port, ref
        finally:
            ref.stop()
            port.shutdown()


def _complete(url, model, prompt):
    out = _post(url + "/v1/completions", {"model": model, "prompt": prompt,
                                          "max_tokens": 16,
                                          "temperature": 0})
    return out["choices"][0]["text"], out["usage"]


@pytest.mark.parametrize("model,path", [("paged", "paged_sp"),
                                        ("dense", "sp")])
def test_seq2_greedy_completions_equal_the_jax_mesh(servers, model, path):
    port, ref = servers[0], servers[1]
    for prompt in PROMPTS:
        got = _complete(port, model, prompt)
        want = _complete(ref, model, prompt)
        assert got == want, prompt
        if len(prompt) >= 40:   # past the threshold (with its BOS)
            runner = servers[2].manager.get(model).runner
            jrunner = servers[3].state.manager.get(model).runner
            assert runner.last_prefill_path == path
            assert jrunner.last_prefill_path == path
    runner = servers[2].manager.get(model).runner
    assert runner.sp_enabled and runner.mesh.shape["seq"] == 2
    assert runner.sp_prefills == 2
    assert type(runner).__name__ == "MirroredRunner"


def test_followers_report_the_leaders_digest_and_ring_prefills(servers):
    """Last: stop the port's server; the follower's report per model
    carries the leader's digest and as many ring prefills."""
    server = servers[2]
    want = {name: (sm.runner.digest.hexdigest(), sm.runner.sp_prefills)
            for name, sm in server.manager._models.items()}
    assert set(want) == set(MODELS)
    before = len(tmh.REPORTS)
    server.shutdown()
    reports = tmh.REPORTS[before:]
    assert [r["rank"] for r in reports] == [1]
    assert reports[0]["errors"] == 0
    for name, (digest, sp) in want.items():
        rm = reports[0]["models"][name]
        assert (rm["digest"], rm["sp_prefills"]) == (digest, sp), name
    assert tmh.current_group() is None
