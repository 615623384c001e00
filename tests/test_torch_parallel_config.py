"""Tensor-parallel settings and specs of the port against the JAX package,
on the CPU (no group is joined here).

* A model YAML's ``sharding:`` block and the top-level
  ``tensor_parallel_size`` alias load into the same ``ShardingConfig``
  values on both packages; an unknown key raises on both.
* ``parse_mesh_spec``, ``plan_from_sharding_config``,
  ``default_tensor_parallel``, ``LOCALAI_MESH`` and ``resolve_mode``
  (every gate, with its reason) give the JAX package's results.
* ``param_specs``, ``kv_spec`` and ``paged_kv_spec`` give the JAX
  package's specs, written as tuples, at ``model=2``, ``4`` and ``8``
  (the replicate fallback on debug:small's 4 kv heads at ``model=8``),
  on plain, biased, tied and MoE configs and on quantized leaves.
* The axes still in ROADMAP item 19 part 2 (``data``, ``expert``) are
  refused by name on the CLI, on ``LOCALAI_MESH`` and on ``sharding:``;
  the host KV tier and fleets of a meshed model too.
* ``--mesh seq=2``, ``pipe=2`` and ``seq=2,model=2``, ``LOCALAI_MESH``
  and ``sharding:`` build the JAX package's plans; ``pipe`` with another
  axis raises the JAX package's error; ``pp_param_specs`` and ``kv_spec``
  on a ``pipe`` mesh are the JAX package's; a YAML's
  ``engine.sp_prefill_threshold`` reaches the runner (ROADMAP §C 21).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from localai_tpu.config import app_config as japp  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.parallel import mesh as jmesh  # noqa: E402
from localai_tpu.parallel import overlap as jovl  # noqa: E402
from localai_tpu.parallel import sharding as jshd  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.config import app_config as tapp  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager, mesh_plan  # noqa: E402
from localai_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from localai_tpu_torch.parallel import overlap as tovl  # noqa: E402
from localai_tpu_torch.parallel import sharding as tshd  # noqa: E402

SHARDING_YAMLS = [
    {"model": "debug:small", "sharding": {"tensor_parallel_size": 2}},
    {"model": "debug:small", "tensor_parallel_size": 4},
    {"model": "debug:small", "tensor_parallel_size": 4,
     "sharding": {"tensor_parallel_size": 2}},
    {"model": "debug:small", "sharding": {
        "tensor_parallel_size": 2, "data_parallel_size": 1,
        "sequence_parallel_size": 2, "expert_parallel_size": 1,
        "pipeline_parallel_size": 1}},
    {"model": "debug:small"},
]


@pytest.mark.parametrize("doc", SHARDING_YAMLS,
                         ids=["block", "alias", "both", "all", "none"])
def test_sharding_config_loads_as_the_jax_package(doc):
    """The fault this slice repairs first: the port dropped ``sharding:``
    and the alias without a word (a single-device engine was served)."""
    port = ModelConfig.from_dict(doc).sharding
    ref = JaxModelConfig(**doc).sharding
    assert dataclasses.asdict(port) == ref.model_dump()
    assert ModelConfig.from_dict(doc).sharding_set() == (
        ref.model_dump() != type(ref)().model_dump())


def test_unknown_sharding_key_raises_on_both():
    doc = {"model": "debug:small", "sharding": {"tensor_paralel_size": 2}}
    with pytest.raises(ValueError, match="tensor_paralel_size"):
        ModelConfig.from_dict(doc)
    with pytest.raises(ValueError):
        JaxModelConfig(**doc)


@pytest.mark.parametrize("spec", ["data=2,model=4", "data:2,model:4",
                                  "model=2", "", "seq=8"])
def test_parse_mesh_spec_as_the_jax_package(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


def test_parse_mesh_spec_unknown_axis_raises():
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="unknown mesh axis"):
            mod.parse_mesh_spec("modle=4")


@pytest.mark.parametrize("kw", [
    dict(tensor_parallel_size=2, n_devices=8),
    dict(tensor_parallel_size=4, data_parallel_size=2, n_devices=8),
    dict(tensor_parallel_size=2, sequence_parallel_size=2, n_devices=8),
    dict(tensor_parallel_size=8, n_devices=8),
    dict(tensor_parallel_size=3, n_devices=8),
    dict(tensor_parallel_size=2, data_parallel_size=3, n_devices=8),
])
def test_plan_from_sharding_config_as_the_jax_package(kw):
    try:
        want = jmesh.plan_from_sharding_config(**kw).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:20]):
            tmesh.plan_from_sharding_config(**kw)
        return
    assert tmesh.plan_from_sharding_config(**kw).shape == want


@pytest.mark.parametrize("n,heads", [(8, 32), (8, 12), (8, 7), (1, 32),
                                     (2, 32), (4, 28), (6, 8)])
def test_default_tensor_parallel_as_the_jax_package(n, heads):
    assert (tmesh.default_tensor_parallel(n, heads)
            == jmesh.default_tensor_parallel(n, heads))


@pytest.mark.parametrize("env", ["data:2,model:4", "model=2", ""])
def test_localai_mesh_reaches_app_config_as_on_the_jax_package(
        monkeypatch, env):
    monkeypatch.setenv("LOCALAI_MESH", env)
    assert (tapp.AppConfig.from_env().mesh_shape
            == japp.AppConfig.from_env().mesh_shape)


def _jax_mesh(n):
    return jmesh.build_mesh(jmesh.MeshPlan(model=n),
                            devices=jax.devices()[:n])


def _port_mesh(n, rank=0):
    return tmesh.Mesh.abstract(tmesh.MeshPlan(model=n), rank)


def _cfgs():
    small = J_PRESETS["small"]
    return {
        "small": small,
        "tiny": J_PRESETS["tiny"],
        "moe": J_PRESETS["tiny-moe"],
        "bias": dataclasses.replace(small, attention_bias=True),
        "tied": dataclasses.replace(small, tie_word_embeddings=True),
        "odd-ffn": dataclasses.replace(small, intermediate_size=500),
        "odd-vocab": dataclasses.replace(small, vocab_size=509),
    }


def _port_cfg(cfg_j):
    return tl.LlamaConfig(**dataclasses.asdict(cfg_j))


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", list(_cfgs()))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_param_and_kv_specs_as_the_jax_package(name, n):
    cfg_j = _cfgs()[name]
    if cfg_j.num_heads % n:
        for fn, mesh in ((jshd.param_specs, _jax_mesh(n)),
                         (tshd.param_specs, _port_mesh(n))):
            with pytest.raises(ValueError, match="num_heads"):
                fn(cfg_j, mesh)
        return
    jm, pm = _jax_mesh(n), _port_mesh(n)
    cfg_t = _port_cfg(cfg_j)
    assert (tshd.param_specs(cfg_t, pm)
            == _as_tuples(jshd.param_specs(cfg_j, jm)))
    assert tshd.kv_spec(cfg_t, pm) == tuple(jshd.kv_spec(cfg_j, jm))
    assert (tshd.paged_kv_spec(cfg_t, pm)
            == tuple(jshd.paged_kv_spec(cfg_j, jm)))


def test_replicate_fallback_spec_at_model_8():
    """debug:small's 4 kv heads at model=8: the pool replicates on both
    packages; each port rank keeps the one kv head its q head reads."""
    cfg_t = _port_cfg(J_PRESETS["small"])
    assert tshd.paged_kv_spec(cfg_t, _port_mesh(8)) == (None,) * 5
    assert tuple(jshd.paged_kv_spec(J_PRESETS["small"], _jax_mesh(8))) \
        == (None,) * 5
    assert tshd.local_heads(cfg_t, 8) == (1, 1)
    assert tshd.local_config(cfg_t, 8).num_kv_heads == 1
    with pytest.raises(ValueError, match="neither divisible"):
        tshd.local_heads(dataclasses.replace(cfg_t, num_heads=12,
                                             num_kv_heads=8), 3)


@pytest.mark.parametrize("mode", ["int8", "int4", "int8_w8a8"])
@pytest.mark.parametrize("n", [2, 4])
def test_quantized_leaf_specs_as_the_jax_package(mode, n):
    """``expand_quantized_spec``: a weight's scales follow its output
    channels, on both packages, leaf by leaf."""
    cfg_j = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
    cfg_t = _port_cfg(cfg_j)
    full_j = _init_j(cfg_j)
    params_j = jq.quantize_params(full_j, mode)
    params_t = tq.quantize_params(
        tl.params_from_numpy(jax.tree.map(np.asarray, full_j), cfg_t,
                             device="cpu"), mode, device="cpu")
    jm, pm = _jax_mesh(n), _port_mesh(n)
    jspecs = jshd.param_specs(cfg_j, jm)
    tspecs = tshd.param_specs(cfg_t, pm)
    for key in ("wq", "wo", "w_down", "w_up"):
        js = jshd.expand_quantized_spec(jspecs["layers"][key],
                                        params_j["layers"][key], jm)
        ts = tshd.expand_quantized_spec(tspecs["layers"][key],
                                        params_t["layers"][key], pm)
        assert ts == (tuple(js.q), tuple(js.scale)), key
    for key in ("embed", "lm_head"):
        js = jshd.expand_quantized_spec(jspecs[key], params_j[key], jm)
        ts = tshd.expand_quantized_spec(tspecs[key], params_t[key], pm)
        assert ts == (tuple(js.q), tuple(js.scale)), key


def _init_j(cfg_j):
    from localai_tpu.models import llama as jl

    return jl.init_params(jax.random.key(0), cfg_j)


def test_table_and_state_specs():
    assert tshd.block_table_spec() == tuple(jshd.block_table_spec())
    assert tshd.state_specs(_port_mesh(2)) == _as_tuples(
        jshd.state_specs(_jax_mesh(2)))
    assert tshd.slots_per_data_shard(4, _port_mesh(2)) == \
        jshd.slots_per_data_shard(4, _jax_mesh(2))


@pytest.mark.parametrize("cfg_name,n,requested", [
    ("tiny", 2, "auto"), ("tiny", 2, "psum"), ("tiny", 2, "0"),
    ("tiny", 2, "bogus"), ("moe", 2, "auto"), ("odd-heads", 2, "auto"),
    ("small", 4, "overlap"), ("small", 8, "auto"), ("tiny", 1, "auto"),
])
def test_resolve_mode_as_the_jax_package(cfg_name, n, requested):
    cfgs = _cfgs()
    cfgs["odd-heads"] = dataclasses.replace(J_PRESETS["tiny"], num_heads=3,
                                            num_kv_heads=3)
    cfg_j = cfgs[cfg_name]
    want = jovl.resolve_mode(cfg_j, _jax_mesh(n), requested)
    assert tovl.resolve_mode(_port_cfg(cfg_j), _port_mesh(n),
                             requested) == want
    assert tovl.resolve_mode(_port_cfg(cfg_j), None, requested) == \
        jovl.resolve_mode(cfg_j, None, requested)


@pytest.mark.parametrize("backend,dev", [("gloo", "cpu"), ("gloo", "cuda"),
                                         ("nccl", "cuda")])
@pytest.mark.parametrize("requested", ["auto", "overlap", "psum", "0"])
def test_every_mesh_reduces_with_one_all_reduce(backend, dev, requested):
    """Whatever the JAX package would run (``resolve_mode``, reported),
    the port's reduction is ``psum``, on every backend; a mesh of one has
    none."""
    mesh = tmesh.Mesh(tmesh.MeshPlan(model=2), rank=0, world=2,
                      group=object(), backend=backend,
                      device=torch.device(dev))
    mode, _ = tovl.resolve_mode(_port_cfg(J_PRESETS["tiny"]), mesh,
                                requested)
    assert mode == {"0": ""}.get(requested, "psum" if requested == "psum"
                                  else "overlap")
    assert tovl.make_reduce(mesh).mode == "psum"
    assert tovl.make_reduce(tmesh.Mesh(tmesh.MeshPlan(model=1))) is None
    assert tovl.make_reduce(None) is None


# ---------------------------------------------------------------------------
# refusals of ROADMAP item 19 part 2


@pytest.mark.parametrize("mesh", ["data=2", "data=2,seq=2", "expert=2,pipe=2",
                                  "expert=2", "data=2,model=2"])
def test_run_mesh_of_part_2_axes_exits_2(tmp_path, capsys, mesh):
    with pytest.raises(SystemExit) as e:
        cli.build_server(["run", "--mesh", mesh, "--device", "cpu",
                          "--address", "127.0.0.1", "--port", "0",
                          "--models-path", str(tmp_path)])
    assert e.value.code == 2
    assert "ROADMAP item 19 part 2" in capsys.readouterr().err


def test_localai_mesh_of_part_2_axes_exits_2(tmp_path, capsys,
                                            monkeypatch):
    monkeypatch.setenv("LOCALAI_MESH", "data:2,model:2")
    with pytest.raises(SystemExit) as e:
        cli.build_server(["run", "--device", "cpu", "--address",
                          "127.0.0.1", "--port", "0", "--models-path",
                          str(tmp_path)])
    assert e.value.code == 2
    assert "ROADMAP item 19 part 2" in capsys.readouterr().err


@pytest.mark.parametrize("sharding", [
    {"data_parallel_size": 2},
    {"sequence_parallel_size": 2, "data_parallel_size": 2},
    {"sequence_parallel_size": 2, "expert_parallel_size": 2},
    {"expert_parallel_size": 2},
    {"tensor_parallel_size": 2, "data_parallel_size": 2},
])
def test_sharding_of_part_2_axes_is_refused_at_load(sharding):
    mcfg = ModelConfig.from_dict({"name": "m", "model": "debug:tiny",
                                  "sharding": sharding})
    app = tapp.AppConfig(device="cpu")
    with pytest.raises(ValueError, match="ROADMAP item 19 part 2"):
        mesh_plan(mcfg, app, tl.LlamaConfig())
    mgr = ModelManager(app)
    with pytest.raises(ValueError, match="ROADMAP item 19 part 2"):
        mgr._load(mcfg)


def test_mesh_plan_model_axis_and_defaults():
    """``--mesh model=2`` and ``sharding: {tensor_parallel_size: 2}`` plan
    model=2 on the CPU (no device count: no data axis to fill); a config
    that asks for nothing stays on one device there."""
    app = tapp.AppConfig(device="cpu")
    tp2 = ModelConfig.from_dict({"model": "debug:tiny",
                                 "sharding": {"tensor_parallel_size": 2}})
    assert mesh_plan(tp2, app, tl.LlamaConfig()).model == 2
    plain = ModelConfig.from_dict({"model": "debug:tiny"})
    assert mesh_plan(plain, app, tl.LlamaConfig()) is None
    assert mesh_plan(plain, tapp.AppConfig(device="cpu",
                                           mesh_shape={"model": 4}),
                     tl.LlamaConfig()).model == 4


def test_kv_tier_and_fleet_of_a_meshed_model_are_refused(monkeypatch):
    from localai_tpu_torch.models import manager as mgr_mod

    mcfg = ModelConfig.from_dict({"name": "m", "model": "debug:tiny",
                                  "sharding": {"tensor_parallel_size": 2}})
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    with pytest.raises(ValueError, match="KV tier.*ROADMAP item 19 part 2"):
        mgr_mod._mesh_for(tmesh.MeshPlan(model=2),
                          tapp.AppConfig(device="cpu"), mcfg)
    monkeypatch.delenv("LOCALAI_KV_TIER_MB")
    mgr = ModelManager(tapp.AppConfig(device="cpu", fleet_replicas=2,
                                      fleet_backend="inprocess"))
    with pytest.raises(ValueError, match="fleet.*ROADMAP item 19 part 2"):
        mgr._load(mcfg)



@pytest.mark.parametrize("backend", ["worker", "inprocess"])
@pytest.mark.parametrize("embeddings", [False, True],
                         ids=["generative", "embeddings"])
def test_the_auto_mesh_leaves_fleet_routing_as_on_the_jax_package(
        monkeypatch, backend, embeddings):
    """On a host with two cards (``device_count`` patched) a model with no
    topology set would be auto-meshed as one engine, yet ``--fleet-replicas
    2`` serves it as a fleet, and an embeddings model keeps its single
    engine, as the JAX manager routes them. Each replica decides its own
    mesh (a pinned worker sees one card); an in-process replica shares
    this process's card and is never auto-meshed."""
    from localai_tpu.models import manager as jmgr_mod
    from localai_tpu_torch import fleet as tfleet
    from localai_tpu_torch.models import manager as mgr_mod
    from localai_tpu_torch.models.registry import resolve_config

    monkeypatch.setattr(tmesh, "device_count", lambda: 2)
    doc = {"name": "m", "model": "debug:small", "embeddings": embeddings}
    mcfg = ModelConfig.from_dict(doc)
    app = tapp.AppConfig(device="cuda", fleet_replicas=2,
                         fleet_backend=backend)
    cfg = resolve_config("debug:small", app.model_path)
    assert mesh_plan(mcfg, app, cfg).model == 2

    def routes(mod, mgr, mc):
        seen = []
        monkeypatch.setattr(mod.ModelManager, "_load_fleet",
                            lambda self, m: seen.append("fleet"))
        monkeypatch.setattr(mod, "build_serving_model",
                            lambda m, a: seen.append("single"))
        mgr._load(mc)
        return seen

    want = routes(jmgr_mod, jmgr_mod.ModelManager(japp.AppConfig(
        fleet_replicas=2, fleet_backend=backend)), JaxModelConfig(**doc))
    assert routes(mgr_mod, ModelManager(app), mcfg) == want == [
        "single" if embeddings else "fleet"]
    if backend != "inprocess" or embeddings:
        return
    monkeypatch.undo()
    monkeypatch.setattr(tmesh, "device_count", lambda: 2)
    built = {}

    class Fleet:
        def __init__(self, mc, a, factory, **kw):
            built["replica"] = factory("m/r0", "decode")

    monkeypatch.setattr(tfleet, "FleetServingModel", Fleet)
    monkeypatch.setattr(mgr_mod, "build_serving_model",
                        lambda m, a: built.update(app=a))
    ModelManager(app)._load(mcfg)
    built["replica"]._factory()
    assert built["app"].device == "cuda"
    assert mesh_plan(mcfg, built["app"], cfg) is None


def test_a_set_topology_refuses_a_fleet_and_the_auto_mesh_does_not():
    mcfg = ModelConfig.from_dict({"name": "m", "model": "debug:small"})
    cfg = tl.LlamaConfig(num_heads=8)
    for app in (tapp.AppConfig(device="cpu", mesh_shape={"model": 2}),
                tapp.AppConfig(device="cpu", coordinator_address="h:1",
                               num_processes=2)):
        assert mesh_plan(mcfg, app, cfg, auto=False).model == 2
    app = tapp.AppConfig(device="cuda")
    assert mesh_plan(mcfg, app, cfg, auto=False) is None


@pytest.mark.parametrize("spec,axis,grouped", [
    ((None, None, "model"), 1, False), ((None, "model", None), 1, False),
    (("model", None), 1, False), ((None, "model"), 0, False),
    ((None, "model", None), 1, True), ((None, None, "model"), 1, True),
    ((None,), 2, False),
])
def test_quantized_spec_as_the_jax_package(spec, axis, grouped):
    from jax.sharding import PartitionSpec as P

    assert tq.quantized_spec(spec, axis, grouped) == tuple(
        jq.quantized_spec(P(*spec), axis, grouped))


# ---------------------------------------------------------------------------
# the seq and pipe axes (ROADMAP item 19 part 2, steps 2 and 3)


def _jax_plan(doc: dict, mesh_shape=None):
    """The mesh plan the JAX package's ``build_runner`` builds for a
    config (its sharding branch, without loading the model), or its
    error; ``data`` left out (the port builds the asked axes alone)."""
    if mesh_shape:
        return jmesh.MeshPlan(**mesh_shape)
    sh = JaxModelConfig(**doc).sharding
    tp, sp = sh.tensor_parallel_size, sh.sequence_parallel_size
    pp = sh.pipeline_parallel_size
    if pp > 1:
        if tp > 1 or sp > 1 or sh.expert_parallel_size > 1 \
                or sh.data_parallel_size not in (0, 1):
            raise ValueError("pipeline_parallel_size composes with no "
                             "other sharding axis yet")
        return jmesh.MeshPlan(pipe=pp)
    return jmesh.MeshPlan(seq=sp, model=tp)


@pytest.mark.parametrize("doc,mesh_shape", [
    ({}, {"seq": 2}),
    ({}, {"pipe": 2}),
    ({}, {"seq": 2, "model": 2}),
    ({"sharding": {"sequence_parallel_size": 2}}, None),
    ({"sharding": {"pipeline_parallel_size": 2}}, None),
    ({"sharding": {"sequence_parallel_size": 2,
                   "tensor_parallel_size": 2}}, None),
    ({"sharding": {"sequence_parallel_size": 4}}, None),
], ids=["mesh-seq", "mesh-pipe", "mesh-seq-model", "sharding-seq",
        "sharding-pipe", "sharding-seq-model", "sharding-seq4"])
def test_seq_and_pipe_plans_as_the_jax_package(doc, mesh_shape):
    mcfg = ModelConfig.from_dict({"name": "m", "model": "debug:small",
                                  **doc})
    app = tapp.AppConfig(device="cpu", mesh_shape=mesh_shape)
    got = mesh_plan(mcfg, app, tl.LlamaConfig())
    assert got.shape == _jax_plan({"model": "debug:small", **doc},
                                  mesh_shape).shape


@pytest.mark.parametrize("env,want", [("seq:2", {"seq": 2}),
                                      ("pipe=2", {"pipe": 2}),
                                      ("seq=2,model=2",
                                       {"seq": 2, "model": 2})])
def test_localai_mesh_seq_and_pipe_build_the_plan(monkeypatch, env, want):
    monkeypatch.setenv("LOCALAI_MESH", env)
    app = tapp.AppConfig.from_env()
    assert app.mesh_shape == japp.AppConfig.from_env().mesh_shape == want
    app.device = "cpu"
    plan = mesh_plan(ModelConfig.from_dict({"model": "debug:small"}), app,
                     tl.LlamaConfig())
    assert plan == tmesh.MeshPlan(**want)


@pytest.mark.parametrize("shard", [
    {"pipeline_parallel_size": 2, "tensor_parallel_size": 2},
    {"pipeline_parallel_size": 2, "sequence_parallel_size": 2},
    {"pipeline_parallel_size": 2, "data_parallel_size": 2},
])
def test_pipe_with_another_sharding_raises_the_jax_error(shard):
    from localai_tpu.models import manager as jmgr

    mcfg = ModelConfig.from_dict({"name": "m", "model": "debug:small",
                                  "sharding": shard})
    with pytest.raises(ValueError, match="composes with no other"):
        mesh_plan(mcfg, tapp.AppConfig(device="cpu"), tl.LlamaConfig())
    with pytest.raises(ValueError, match="composes with no other"):
        jmgr.build_runner(JaxModelConfig(name="m", model="debug:small",
                                         sharding=shard),
                          japp.AppConfig())


@pytest.mark.parametrize("mesh", ["pipe=2,model=2", "seq=2,pipe=2"])
def test_run_mesh_pipe_with_another_axis_exits_2(tmp_path, capsys, mesh):
    with pytest.raises(SystemExit) as e:
        cli.build_server(["run", "--mesh", mesh, "--device", "cpu",
                          "--address", "127.0.0.1", "--port", "0",
                          "--models-path", str(tmp_path)])
    assert e.value.code == 2
    assert "composes with no other axis" in capsys.readouterr().err


def test_refuse_part2_names_only_data_and_expert():
    for plan in (tmesh.MeshPlan(seq=2), tmesh.MeshPlan(pipe=4),
                 tmesh.MeshPlan(seq=2, model=2), tmesh.MeshPlan(model=8)):
        tmesh.refuse_part2(plan, "here")
    for plan in (tmesh.MeshPlan(data=2), tmesh.MeshPlan(expert=2, seq=2)):
        with pytest.raises(ValueError, match="ROADMAP item 19 part 2"):
            tmesh.refuse_part2(plan, "here")


@pytest.mark.parametrize("plan", [dict(seq=2, model=2), dict(seq=4),
                                  dict(pipe=2), dict(seq=2, model=4)])
def test_axis_layout_is_the_jax_meshes(plan):
    """Ranks lie in ``AXES`` order with ``model`` fastest, as a JAX mesh
    lays its devices out: a rank's index on each axis and its groups are
    the JAX mesh's device coordinates."""
    jm = jmesh.build_mesh(jmesh.MeshPlan(**plan),
                          devices=jax.devices()[:tmesh.MeshPlan(
                              **plan).size()])
    tp = tmesh.MeshPlan(**plan)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(tp.size()):
        coords = tmesh.axis_coords(tp, r)
        assert ids[tuple(coords[a] for a in tmesh.AXES)] == \
            jax.devices()[r].id
        for ax in tmesh.AXES:
            idx = [coords[a] for a in tmesh.AXES]
            idx[tmesh.AXES.index(ax)] = slice(None)
            assert tmesh.axis_ranks(tp, r, ax) == [
                [d.id for d in jax.devices()].index(i)
                for i in ids[tuple(idx)].tolist()]


def test_pp_param_specs_and_kv_spec_as_the_jax_package():
    from localai_tpu.parallel import pipeline as jpp
    from localai_tpu_torch.parallel import pipeline as tpp

    for name in ("small", "tiny"):
        cfg_j = J_PRESETS[name]
        jm = jmesh.build_mesh(jmesh.MeshPlan(pipe=2),
                              devices=jax.devices()[:2])
        tm = tmesh.Mesh.abstract(tmesh.MeshPlan(pipe=2), 1)
        want = jax.tree.map(tuple, jpp.pp_param_specs(cfg_j, jm),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
        assert tpp.pp_param_specs(_port_cfg(cfg_j), tm) == want
        assert tshd.kv_spec(_port_cfg(cfg_j), tm) == tuple(
            jshd.kv_spec(cfg_j, jm))
    bad = dataclasses.replace(_port_cfg(J_PRESETS["small"]), num_layers=3)
    with pytest.raises(ValueError, match="not divisible by pipe=2"):
        tpp.pp_param_specs(bad, tmesh.Mesh.abstract(tmesh.MeshPlan(pipe=2)))


def test_sp_prefill_threshold_is_kept_and_reaches_the_runner(tmp_path):
    """ROADMAP §C 21: ``engine.sp_prefill_threshold`` was dropped (the
    port's EngineConfig had no such field, so the default 1024 served a
    YAML that set 32)."""
    from localai_tpu_torch.models.manager import build_runner

    doc = {"name": "m", "model": "debug:tiny",
           "engine": {"sp_prefill_threshold": 32, "dtype": "float32",
                      "max_slots": 2}}
    mcfg = ModelConfig.from_dict(doc)
    assert mcfg.engine.sp_prefill_threshold == 32 == JaxModelConfig(
        **doc).engine.sp_prefill_threshold
    assert ModelConfig.from_dict({"model": "debug:tiny"}).engine \
        .sp_prefill_threshold == 1024 == JaxModelConfig(
            model="debug:tiny").engine.sp_prefill_threshold
    _model, runner = build_runner(mcfg, tapp.AppConfig(
        device="cpu", model_path=str(tmp_path)))
    assert runner.sp_threshold == 32


@pytest.mark.parametrize("have,ask", [
    (dict(model=2), dict(seq=2)), (dict(seq=2), dict(pipe=2)),
    (dict(pipe=2), dict(model=2)), (dict(model=2), dict(model=4))])
def test_a_process_group_is_keyed_by_its_mesh_plan(monkeypatch, have, ask):
    """A process serves one group: a model that asks for another plan,
    even of the same width, is refused naming both (a ``seq=2`` group is
    not a ``model=2`` one)."""
    from localai_tpu_torch.parallel import multihost as tmh

    plan = tmesh.MeshPlan(**have)
    group = tmh.Group(plan, plan.size(), leader=None, followers=[],
                      spawned=False)
    monkeypatch.setattr(tmh, "_group", group)
    with pytest.raises(ValueError) as e:
        tmh.ensure_group(tapp.AppConfig(device="cpu"),
                         tmesh.MeshPlan(**ask), "b")
    assert tmesh.spec_of(plan) in str(e.value)
    assert tmesh.spec_of(tmesh.MeshPlan(**ask)) in str(e.value)
    assert tmh.ensure_group(tapp.AppConfig(device="cpu"), plan,
                            "a") is group
