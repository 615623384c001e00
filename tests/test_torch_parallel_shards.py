"""Each tensor-parallel rank's weight slices against the JAX package's
device shards, on the CPU.

``params_from_numpy(tree, cfg, mesh=...)`` gives rank r exactly what
``jax.device_put(leaf, NamedSharding(mesh, spec))`` (the JAX package's
``shard_params``) puts on device r of a ``model=N`` mesh, leaf by leaf,
for float32, int8 and int4 trees at ``model=2`` and ``4`` (scales
included; int4 ``q`` compared unpacked). The load-time forms cut the
same slices: a checkpoint read through the port's loader and a debug
preset drawn shard by shard equal ``shard_params`` of the whole tree. On
the replicate fallback (debug:small's 4 kv heads at ``model=8``) a rank's
K/V projection columns are those of the kv head its q head reads.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.parallel import mesh as jmesh  # noqa: E402
from localai_tpu.parallel import sharding as jshd  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402
from localai_tpu_torch.ops.qmatmul import unpack_w4  # noqa: E402
from localai_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from localai_tpu_torch.parallel import sharding as tshd  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

_TREES: dict = {}


def _tree(mode: str):
    """(JAX cfg, JAX params) of f32 debug:small from jax.random.key(3),
    quantized by the JAX package when ``mode``."""
    if mode not in _TREES:
        cfg = dataclasses.replace(J_PRESETS["small"], dtype="float32")
        params = jl.init_params(jax.random.key(3), cfg)
        if mode:
            params = jq.quantize_params(params, mode)
        _TREES[mode] = (cfg, params)
    return _TREES[mode]


def _jax_shards(leaf, spec, mesh):
    """Device r's shard of ``leaf`` placed with ``spec`` on ``mesh``, by
    device order (the mesh's model axis)."""
    arr = jax.device_put(leaf, jax.sharding.NamedSharding(mesh, spec))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.reshape(-1)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_slices_equal_the_jax_device_shards(mode, n):
    cfg_j, params_j = _tree(mode)
    if mode == "int4" and n == 4:
        # debug:small's 256-row wo at tp=4 holds 64 local rows, half a
        # group of 128: refused at load, naming the shape
        with pytest.raises(ValueError, match="int4 weight of shape"):
            tl.params_from_numpy(
                jax.tree.map(np.asarray, params_j),
                tl.LlamaConfig(**dataclasses.asdict(cfg_j)), device="cpu",
                mesh=tmesh.Mesh.abstract(tmesh.MeshPlan(model=n), 0))
        return
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    jm = jmesh.build_mesh(jmesh.MeshPlan(model=n),
                          devices=jax.devices()[:n])
    specs = jshd.param_specs(cfg_j, jm)
    tree_np = jax.tree.map(np.asarray, params_j)
    ranks = [tl.params_from_numpy(
        tree_np, cfg_t, device="cpu",
        mesh=tmesh.Mesh.abstract(tmesh.MeshPlan(model=n), r))
        for r in range(n)]
    checked = 0
    for path, leaf in _leaves(params_j):
        spec = _get(specs, path)
        if isinstance(leaf, jq.QuantizedTensor):
            qspec = jshd.expand_quantized_spec(spec, leaf, jm)
            want_q = _jax_shards(leaf.q, qspec.q, jm)
            want_s = _jax_shards(leaf.scale, qspec.scale, jm)
            for r in range(n):
                got = _get(ranks[r], path)
                q = (unpack_w4(got.q, got.axis) if got.mode == "w4"
                     else got.q)
                np.testing.assert_array_equal(
                    q.numpy(), want_q[r].astype(np.int8), err_msg=str(path))
                np.testing.assert_array_equal(got.scale.numpy(), want_s[r],
                                              err_msg=str(path))
        else:
            want = _jax_shards(leaf, spec, jm)
            for r in range(n):
                np.testing.assert_array_equal(
                    _get(ranks[r], path).numpy(), want[r],
                    err_msg=str(path))
        checked += 1
    assert checked == len(list(_leaves(params_j)))


def test_replicate_fallback_keeps_the_kv_head_of_the_rank():
    cfg_j, params_j = _tree("")
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    full = tl.params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                device="cpu")
    hd, g = cfg_t.hd, cfg_t.num_heads // cfg_t.num_kv_heads
    for r in range(8):
        local = tshd.shard_params(full, cfg_t, tmesh.Mesh.abstract(
            tmesh.MeshPlan(model=8), r))
        head = r // g
        for name in ("wk", "wv"):
            np.testing.assert_array_equal(
                local["layers"][name].numpy(),
                full["layers"][name][..., head * hd:(head + 1) * hd].numpy())
        np.testing.assert_array_equal(
            local["layers"]["wq"].numpy(),
            full["layers"]["wq"][..., r * hd:(r + 1) * hd].numpy())


@pytest.mark.parametrize("mode", ["", "int8", "int4"])
def test_load_time_slices_equal_shard_params(tmp_path, mode):
    """A checkpoint read through the loader and a debug preset drawn shard
    by shard (quantized whole, then cut, as each tensor comes) give each
    rank ``shard_params`` of the whole tree, bit for bit."""
    cfg = dataclasses.replace(tl.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=256), dtype="float32")
    full = tl.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    write_llama_checkpoint(tmp_path / "ckpt", cfg, full)
    plain = resolve_model(str(tmp_path / "ckpt"), dtype="float32",
                          device="cpu", quantization=mode)
    for r in range(2):
        mesh = tmesh.Mesh.abstract(tmesh.MeshPlan(model=2), r)
        want = tshd.shard_params(plain.params, cfg, mesh)
        got = resolve_model(str(tmp_path / "ckpt"), dtype="float32",
                            device="cpu", quantization=mode,
                            mesh=mesh).params
        for path, leaf in _leaves(want):
            other = _get(got, path)
            if isinstance(leaf, tq.QuantizedTensor):
                assert torch.equal(other.q, leaf.q), path
                assert torch.equal(other.scale, leaf.scale), path
            else:
                assert torch.equal(other, leaf), path


@pytest.mark.parametrize("mode", ["", "int8"])
def test_debug_preset_drawn_shard_by_shard(mode):
    base = resolve_model("debug:tiny", dtype="float32", seed=4,
                         device="cpu", quantization=mode)
    cfg = base.cfg
    for r in range(2):
        mesh = tmesh.Mesh.abstract(tmesh.MeshPlan(model=2), r)
        want = tshd.shard_params(base.params, cfg, mesh)
        got = resolve_model("debug:tiny", dtype="float32", seed=4,
                            device="cpu", quantization=mode,
                            mesh=mesh).params
        for path, leaf in _leaves(want):
            other = _get(got, path)
            if isinstance(leaf, tq.QuantizedTensor):
                assert torch.equal(other.q, leaf.q), path
                assert torch.equal(other.scale, leaf.scale), path
            else:
                assert torch.equal(other, leaf), path
