"""Tensor parallelism end to end on the CPU: the port at ``model=2``
against the JAX package's runner on ``MeshPlan(model=2)``.

The port's HTTP server runs in this process as the leader (rank 0) with
``mesh_shape={"model": 2}`` — the settings of ``run --mesh model=2`` —
and spawns its follower rank (``cli.main follower``) at the first load;
the two ranks' collectives go over gloo. The JAX package's server runs
on the virtual CPU devices of ``tests/conftest.py`` with the same mesh
(its ``build_mesh`` limited to the mesh's devices). Both serve one
float32 debug:small checkpoint written here:

* ``q8``: paged, int8 pool and int8 weights, speculation on by default
  (the n-gram drafter), ``embeddings: true``;
* ``q4``: paged, int4 pool and int4 weights (int4 pool and float32
  weights at ``model=4``, where debug:small's int4 ``wo`` cannot be cut);
* ``dense``: the contiguous layout, float32.

Greedy completions of three concurrent prompts, a tools chat and
``/v1/embeddings`` answer the same on both servers: texts and token
counts byte for byte, embeddings within 1e-4 of the vector's largest
magnitude. A prefill's logits on the port's ``model=2`` engine
(``prompt_logits``, mirrored) are the JAX package's unsharded forward's
within 1e-4 of their largest magnitude (float32 sums in another order).
After the server stops, each follower's stop report carries the
leader's token digest for every model it served.

A spawned group gets 120 s to join and load, and collectives time out
after 120 s (``LOCALAI_MESH_TIMEOUT_S``): a hang fails this module, not
the whole run.
"""

import concurrent.futures as cf
import dataclasses
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.api.server import AppState as JaxAppState  # noqa: E402
from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.engine import kvcache as jkvc  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.parallel import mesh as jmesh  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.parallel import multihost as mh  # noqa: E402
from test_api import _ServerThread  # noqa: E402
from test_torch_llama import write_hf_checkpoint  # noqa: E402

WIDTH = 2
LOAD_ERRORS = 0        # loads the followers refuse (test_torch_parallel_tp4)
BASE = {"dtype": "float32", "max_slots": 4, "kv_block_tokens": 16,
        "prefill_buckets": [32, 64]}
PROMPTS = ["the quick brown fox", "hello tensor parallel", "abcabcabcabc"]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather of a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string", "maxLength": 8},
        "unit": {"enum": ["celsius", "fahrenheit"]}},
        "required": ["city", "unit"]}}}]


def _models(width: int) -> dict:
    q4 = ({"kv_dtype": "int4", "quantization": "int4"} if width == 2
          else {"kv_dtype": "int4"})
    models = {
        "q8": {"embeddings": True,
               "engine": {**BASE, "kv_dtype": "int8",
                          "quantization": "int8"}},
        "q4": {"engine": {**BASE, **q4}},
        "dense": {"engine": {**BASE, "kv_dtype": "float32",
                             "kv_paged": False}},
    }
    if width == 2:
        # a draft model, sharded over the target's mesh (its drafter's
        # calls mirrored as "draft#draft")
        models["draft"] = {"engine": {**BASE, "kv_dtype": "float32",
                                      "draft_model": "debug:small"}}
    return models


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _strip(out):
    out = json.loads(json.dumps(out))
    out.pop("id", None)
    out.pop("created", None)
    for c in out.get("choices", []):
        for tc in (c.get("message") or {}).get("tool_calls") or []:
            tc.pop("id", None)
    return out


def make_servers(width: int):
    """A module fixture: (port URL, JAX URL, port server, JAX params)."""

    @pytest.fixture(scope="module")
    def servers(tmp_path_factory):
        root = tmp_path_factory.mktemp(f"tp{width}")
        cfg = dataclasses.replace(J_PRESETS["small"], dtype="float32",
                                  max_position_embeddings=256)
        params = jl.init_params(jax.random.key(0), cfg)
        ckpt = write_hf_checkpoint(root / "ckpt", cfg, params)
        models = root / "models"
        models.mkdir()
        for name, doc in _models(width).items():
            (models / f"{name}.yaml").write_text(json.dumps(
                {"name": name, "model": str(ckpt), "context_size": 256,
                 **doc}))
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
                mesh_shape={"model": width}), loader), "127.0.0.1",
                0).start()
            jcfg = JaxAppConfig(model_path=str(models),
                                upload_path=str(root / "jup"),
                                config_path=str(root / "jcf"),
                                mesh_shape={"model": width})
            jloader = JaxLoader(models)
            jloader.load_from_path(context_size=256)
            ref = _ServerThread(JaxAppState(jcfg, jloader))
            try:
                yield port.url, ref.base, port, (cfg, params)
            finally:
                ref.stop()
                port.shutdown()

    return servers


servers = make_servers(WIDTH)


def _completions(url, model):
    with cf.ThreadPoolExecutor(len(PROMPTS)) as ex:
        outs = list(ex.map(lambda p: _post(url + "/v1/completions", {
            "model": model, "prompt": p, "max_tokens": 20,
            "temperature": 0}), PROMPTS))
    return [(o["choices"][0]["text"], o["usage"]) for o in outs]


@pytest.mark.parametrize("model", ["q8", "q4", "dense"])
def test_greedy_completions_equal_the_jax_mesh(servers, model):
    port, ref = servers[0], servers[1]
    got = _completions(port, model)
    assert got == _completions(ref, model)
    assert sum(u["completion_tokens"] for _t, u in got) > 20
    sm = servers[2].manager.get(model)
    assert sm.runner.mesh.tp == WIDTH
    assert type(sm.runner).__name__ == "MirroredRunner"


def test_speculation_runs_windows_on_the_mesh(servers):
    """A stream that cycles (a logit bias on one byte): the n-gram drafter
    proposes, verify windows run on the mesh and accept draft tokens,
    and the text is the JAX mesh's."""
    body = {"model": "q8", "prompt": "aaaaaaaa", "max_tokens": 24,
            "temperature": 0, "logit_bias": {"97": 30}}
    sched = servers[2].manager.get("q8").scheduler
    before = sched.metrics()
    got = _post(servers[0] + "/v1/completions", body)
    want = _post(servers[1] + "/v1/completions", body)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    m = sched.metrics()
    assert m["spec_windows"] > before["spec_windows"]
    assert m["spec_accepted_tokens"] > before["spec_accepted_tokens"]


def test_tools_chat_equals_the_jax_mesh(servers):
    body = {"model": "q8", "max_tokens": 40, "temperature": 0,
            "tools": TOOLS, "tool_choice": "required",
            "messages": [{"role": "user", "content": "weather in Nice?"}]}
    got = _strip(_post(servers[0] + "/v1/chat/completions", body))
    want = _strip(_post(servers[1] + "/v1/chat/completions", body))
    assert got["choices"] == want["choices"]
    assert got["usage"] == want["usage"]
    assert "get_weather" in json.dumps(got["choices"])


def test_embeddings_equal_the_jax_mesh(servers):
    body = {"model": "q8", "input": ["hello world", "tensor parallel!"]}
    got = _post(servers[0] + "/v1/embeddings", body)["data"]
    want = _post(servers[1] + "/v1/embeddings", body)["data"]
    for g, w in zip(got, want):
        g, w = np.asarray(g["embedding"]), np.asarray(w["embedding"])
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_prefill_logits_equal_the_jax_forward(servers):
    cfg, params = servers[3]
    ids = list(b"logits of a tensor-parallel prefill")
    got = servers[2].manager.get("dense").runner.prompt_logits(ids)
    T = len(ids)
    mask = jnp.broadcast_to(jkvc.resume_mask(cfg, T, 0, T), (1, T, T))

    def write(kv, k, v):
        return kv, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)

    h, _ = jl.forward(cfg, params, jnp.asarray([ids], jnp.int32),
                      jnp.arange(T, dtype=jnp.int32)[None], write, None,
                      mask, jl.rope_table(cfg, 256))
    want = np.asarray(jl.logits_from_hidden(cfg, params, h))[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_draft_model_speculates_on_the_mesh(servers):
    """A draft model on the mesh: its windows run on both ranks (greedy
    speculation emits the target's own greedy stream, so the text is the
    JAX mesh's whatever each package's draft weights)."""
    body = {"model": "draft", "prompt": "draft on the mesh",
            "max_tokens": 16, "temperature": 0}
    got = _post(servers[0] + "/v1/completions", body)
    want = _post(servers[1] + "/v1/completions", body)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    sm = servers[2].manager.get("draft")
    assert sm.scheduler.metrics()["spec_windows"] > 0
    assert sm.scheduler.spec.drafter._model == "draft#draft"
    assert sm.scheduler.spec.drafter.runner.mesh.tp == WIDTH


def test_followers_report_the_leaders_token_digest(servers):
    """Last: stop the port's server; every follower exits with a report
    whose digest per model is the leader's."""
    server = servers[2]
    digests = {name: sm.runner.digest.hexdigest()
               for name, sm in server.manager._models.items()}
    assert set(digests) == set(_models(WIDTH))
    before = len(mh.REPORTS)
    server.shutdown()
    reports = mh.REPORTS[before:]
    assert sorted(r["rank"] for r in reports) == list(range(1, WIDTH))
    for r in reports:
        assert r["errors"] == LOAD_ERRORS
        for name, want in digests.items():
            assert r["models"][name]["digest"] == want, (r["rank"], name)
            assert r["models"][name]["results"] > 0
        if WIDTH == 2:   # the draft's replays: proposals every window
            assert r["models"]["draft#draft"]["calls"]["propose"] > 0
    assert mh.current_group() is None
