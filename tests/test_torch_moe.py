"""Mixtral-class sparse MoE on the PyTorch port, held against the JAX
package on the CPU.

The same weights (JAX ``init_params`` carried across by
``params_from_numpy``) and the same numpy-drawn inputs go through both
packages: the MoE MLP within 1e-5 and full-forward logits within 1e-4 in
float32 (summation order differs between XLA's and PyTorch's CPU
products); int8 and int4 ``quantize_params`` give equal bytes; the expert
kernel's plain version (``w8_matmul_experts_ref``) equals the JAX
package's ``moe_up`` / ``moe_down`` within 1e-5; greedy token streams
through both schedulers (paged with the n-gram speculation on, and
contiguous) are equal token for token. A Mixtral checkpoint written here
loads equal in both packages, quantized on load equal to quantized after
load. ``synthetic_quantized_params`` gives the JAX package's shapes,
dtypes, axes and scales; its values come from another generator.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.engine import kvcache as jkvc  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import loader as jloader  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models import registry as jreg  # noqa: E402
from localai_tpu.spec import NGramDrafter as JaxNGram  # noqa: E402
from localai_tpu.spec import SpecEngine as JaxSpecEngine  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine import kvcache as tkvc  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import loader as tloader  # noqa: E402
from localai_tpu_torch.models import manager as tmanager  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.models import registry as treg  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from localai_tpu_torch.spec import NGramDrafter, SpecEngine  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

MLP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MOE = dataclasses.replace(jreg.DEBUG_PRESETS["tiny-moe"], dtype="float32")
# 128-aligned widths, so the port's MoE products take the expert kernel's
# path (its plain version on the CPU)
MOE_ALIGNED = dataclasses.replace(MOE, hidden_size=128,
                                  intermediate_size=256, num_heads=4,
                                  num_kv_heads=2)
_MODELS: dict = {}


def _model(cfg_j, weights=""):
    """(JAX params, port cfg, port params) from jax.random.key(0), each
    package quantizing its own copy when ``weights`` is int8/int4."""
    key = (cfg_j, weights)
    if key not in _MODELS:
        params_j = jl.init_params(jax.random.key(0), cfg_j)
        cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
        params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, device="cpu")
        if weights:
            params_j = jq.quantize_params(params_j, weights)
            params_t = tq.quantize_params(params_t, weights, device="cpu")
        _MODELS[key] = (params_j, cfg_t, params_t)
    return _MODELS[key]


def _layer0(params):
    """Layer 0's slices (a JAX QuantizedTensor is a pytree node)."""
    if isinstance(params["embed"], (jq.QuantizedTensor, jax.Array)):
        return jax.tree.map(lambda a: a[0], params["layers"])
    return {k: v[0] for k, v in params["layers"].items()}


def test_param_shapes_match_jax():
    assert tl.param_shapes(tl.LlamaConfig(**dataclasses.asdict(MOE))) == \
        jl.param_shapes(MOE)


def test_from_hf_reads_mixtral_fields():
    hf = {"model_type": "mixtral", "hidden_size": 4096,
          "intermediate_size": 14336, "num_hidden_layers": 32,
          "num_attention_heads": 32, "num_key_value_heads": 8,
          "num_local_experts": 8, "num_experts_per_tok": 2,
          "rope_theta": 1e6, "max_position_embeddings": 32768}
    assert dataclasses.asdict(tl.LlamaConfig.from_hf(hf)) == \
        dataclasses.asdict(jl.LlamaConfig.from_hf(hf))


@pytest.mark.parametrize("cfg_j", [MOE, MOE_ALIGNED], ids=["tiny", "aligned"])
@pytest.mark.parametrize("weights", ["", "int8"])
def test_moe_mlp_matches_jax(cfg_j, weights):
    params_j, cfg_t, params_t = _model(cfg_j, weights)
    h = np.random.default_rng(1).normal(
        size=(3, 7, cfg_j.hidden_size)).astype(np.float32)
    want = np.asarray(jl._moe_mlp(cfg_j, jnp.asarray(h), _layer0(params_j)))
    got = tl._moe_mlp(cfg_t, torch.from_numpy(h), _layer0(params_t)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **MLP_TOL)


def _prefill_logits(cfg_j, params_j, cfg_t, params_t, seed=11):
    rng = np.random.default_rng(seed)
    B, T = 2, 13
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mask_j = jnp.broadcast_to(jkvc.resume_mask(cfg_j, T, 0, T), (B, T, T))
    mask_t = tkvc.resume_mask(cfg_t, T, 0, T, device="cpu").expand(B, T, T)

    def write_j(kv, k, v):
        return kv, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)

    def write_t(kv, k, v):
        return kv, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    h_j, _ = jl.forward(cfg_j, params_j, jnp.asarray(tokens),
                        jnp.asarray(positions), write_j, None, mask_j,
                        jl.rope_table(cfg_j, 32))
    h_t, _ = tl.forward(cfg_t, params_t, torch.from_numpy(tokens),
                        torch.from_numpy(positions.copy()), write_t, None,
                        mask_t, tl.rope_table(cfg_t, 32, device="cpu"))
    return (np.asarray(jl.logits_from_hidden(cfg_j, params_j, h_j)),
            tl.logits_from_hidden(cfg_t, params_t, h_t).numpy())


@pytest.mark.parametrize("cfg_j", [MOE, MOE_ALIGNED], ids=["tiny", "aligned"])
@pytest.mark.parametrize("weights", ["", "int8", "int4"])
def test_forward_logits_match_jax(cfg_j, weights):
    params_j, cfg_t, params_t = _model(cfg_j, weights)
    want, got = _prefill_logits(cfg_j, params_j, cfg_t, params_t)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_quantize_params_equals_jax_tree(weights):
    params_j, _, params_t = _model(MOE, weights)
    for name in ("w_gate", "w_up", "w_down"):
        a, b = params_j["layers"][name], params_t["layers"][name]
        # expert stacks: per-channel int8 over K (axis 2) in every mode
        assert a.mode == b.mode == "w8" and a.axis == b.axis == 2
        np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    # the router stays in the compute dtype
    assert not isinstance(params_t["layers"]["moe_gate"], tq.QuantizedTensor)
    np.testing.assert_array_equal(params_t["layers"]["moe_gate"].numpy(),
                                  np.asarray(params_j["layers"]["moe_gate"]))
    wq = params_t["layers"]["wq"]
    assert wq.mode == ("w4" if weights == "int4" else "w8")


def test_params_from_numpy_carries_quantized_expert_stacks():
    params_j = jq.quantize_params(
        jl.init_params(jax.random.key(0), MOE), "int8")
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(MOE))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, device="cpu")
    w = params_t["layers"]["w_down"]
    assert isinstance(w, tq.QuantizedTensor) and w.axis == 2
    np.testing.assert_array_equal(w.q.numpy(),
                                  np.asarray(params_j["layers"]["w_down"].q))


@pytest.mark.parametrize("kind", ["up", "down"])
@pytest.mark.parametrize("M", [1, 8, 40])
def test_expert_kernel_plain_version_matches_jax(kind, M):
    """``w8_matmul_experts_ref`` (the kernel's math: f32 accumulation,
    each expert's scale on its accumulator) against the JAX package's
    ``moe_up`` / ``moe_down`` on the same int8 stack, f32, 1e-5."""
    rng = np.random.default_rng(M)
    E, D, F = 4, 128, 256
    K, N = (D, F) if kind == "up" else (F, D)
    w = (rng.normal(size=(E, K, N)) * 0.02).astype(np.float32)
    qt_j = jq.quantize_tensor(jnp.asarray(w), axis=1)
    qt_t = tq.quantize_tensor(torch.from_numpy(w), 1)
    np.testing.assert_array_equal(qt_t.q.numpy(), np.asarray(qt_j.q))
    if kind == "up":
        x = rng.normal(size=(M, D)).astype(np.float32)
        want = np.asarray(jq.moe_up(jnp.asarray(x), qt_j))
    else:
        x = rng.normal(size=(M, E, F)).astype(np.float32)
        want = np.asarray(jq.moe_down(jnp.asarray(x), qt_j))
    got = tqm.w8_matmul_experts_ref(torch.from_numpy(x), qt_t.q,
                                    qt_t.scale).numpy()
    assert got.shape == want.shape == (M, E, N)
    np.testing.assert_allclose(got, want, **MLP_TOL)
    # the CPU wrapper is the plain version, and the port's moe_up/moe_down
    # route an aligned stack to it
    out = tqm.w8_matmul_experts(torch.from_numpy(x), qt_t.q, qt_t.scale)
    np.testing.assert_array_equal(out.numpy(), got)
    fn = tq.moe_up if kind == "up" else tq.moe_down
    np.testing.assert_array_equal(fn(torch.from_numpy(x), qt_t).numpy(),
                                  got)
    assert tqm.w8_matmul_experts.launches == 0   # no kernel on the CPU
    assert tqm.w8_matmul_experts.up.launches == 0
    assert tqm.w8_matmul_experts.down.launches == 0


def test_experts_eligible_gate():
    q = torch.zeros((4, 128, 256), dtype=torch.int8)
    s = torch.ones((4, 256))
    assert tqm.experts_eligible((8, 128), q, s)
    assert tqm.experts_eligible((300, 4, 128), q, s)   # any row count
    assert not tqm.experts_eligible((8, 64), q, s)
    assert not tqm.experts_eligible((8, 96), q[:, :96], s)
    assert not tqm.experts_eligible((8, 128), q[:, :, :100], s[:, :100])
    assert not tqm.experts_eligible((8, 128), q.float(), s)
    assert not tqm.experts_eligible((8, 128), q[0], s[0])


@pytest.mark.parametrize("M,K,N,E,want", [
    # Mixtral-8x7B decode: 8 experts x 112 column tiles fill 132 SMs
    (8, 4096, 14336, 8, (1, 1, 4096)),
    # the down projection: 8 x 32 tiles, unsplit
    (8, 14336, 4096, 8, (1, 1, 14336)),
    # a verify window of 8 slots x 5 rows
    (40, 14336, 4096, 8, (4, 1, 14336)),
    # the moe_parity widths (debug:small, 4 experts): 16 tiles; K = 256
    # is one least split (two stages), K = 512 splits in two
    (8, 256, 512, 4, (1, 1, 256)),
    (8, 512, 256, 4, (1, 2, 256)),
])
def test_split_plan_counts_experts(M, K, N, E, want):
    assert tqm.qmm_split_plan(M, K, N, 128, 132, "w8", E) == want
    if E > 1:   # the same shape alone is split more
        assert tqm.qmm_split_plan(M, K, N, 128, 132, "w8")[1] >= want[1]


# ---------------------------------------------------------------------------
# greedy streams through the schedulers
# ---------------------------------------------------------------------------

RUNNER_KW = dict(num_slots=2, max_ctx=128, prefill_buckets=[32],
                 kv_dtype="float32")
PROMPTS = [list(b"mixture of experts"), list(b"abcabcabcabcabcabc")]


def _port_runner(weights, paged):
    _, cfg_t, params_t = _model(MOE, weights)
    kw = dict(RUNNER_KW, kv_block_tokens=16) if paged else dict(RUNNER_KW)
    return ModelRunner(cfg_t, params_t, paged=paged, device="cpu", **kw)


def _jax_runner(weights, paged):
    params_j, _, _ = _model(MOE, weights)
    kw = dict(RUNNER_KW, kv_block_tokens=16) if paged else dict(RUNNER_KW)
    return JaxRunner(MOE, params_j, paged=paged, attn_impl="xla", **kw)


@pytest.mark.parametrize("weights", ["", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged-spec",
                                                      "contiguous"])
def test_scheduler_greedy_streams_match_jax(weights, paged):
    """Paged engines speculate (n-gram, gamma 4) as a paged engine's user
    gets it; the contiguous one decodes plainly."""
    target = _port_runner(weights, paged)
    spec = (SpecEngine(target, NGramDrafter(2, gamma=4), gamma=4)
            if paged else None)
    sched = Scheduler(target, ByteTokenizer(), multi_step=4, spec=spec)
    try:
        got = [sched.generate(GenRequest(prompt=p, max_new_tokens=20,
                                         temperature=0.0, ignore_eos=True),
                              timeout=300).token_ids for p in PROMPTS]
        if paged:
            assert sched.metrics()["spec_windows"] > 0
    finally:
        sched.shutdown()
    jt = _jax_runner(weights, paged)
    jspec = (JaxSpecEngine(jt, JaxNGram(2, gamma=4), gamma=4)
             if paged else None)
    jsched = JaxScheduler(jt, JaxByteTokenizer(), multi_step=4, spec=jspec)
    try:
        want = [jsched.generate(JaxGenRequest(prompt=p, max_new_tokens=20,
                                              temperature=0.0,
                                              ignore_eos=True),
                                timeout=300).token_ids for p in PROMPTS]
    finally:
        jsched.shutdown()
    assert got == want
    assert all(len(t) == 20 for t in got)


def test_serving_model_speculates_on_a_paged_moe_engine():
    """build_serving_model takes a MoE preset as it takes a dense one: a
    paged engine with no ``spec`` key speculates with the n-gram
    drafter, as in the JAX package."""
    mcfg = ModelConfig.from_dict({
        "name": "moe", "model": "debug:tiny-moe",
        "engine": {"dtype": "float32", "kv_dtype": "float32",
                   "max_slots": 2}})
    mcfg.set_defaults()
    sm = tmanager.build_serving_model(mcfg, AppConfig(device="cpu"))
    try:
        assert sm.runner.paged and sm.runner.cfg.num_experts == 4
        assert sm.scheduler.spec is not None
        assert sm.scheduler.spec.drafter.name == "ngram"
        out = sm.scheduler.generate(GenRequest(
            prompt=list(b"hi"), max_new_tokens=4, temperature=0.0,
            ignore_eos=True), timeout=120)
        assert len(out.token_ids) == 4
    finally:
        sm.close()


def test_smoke_mixtral_engine_is_build_serving_models():
    """The smoke's Mixtral serve builds its engine by hand on weights drawn
    by ``synthetic_quantized_params`` (a bf16 Mixtral-8x7B would not fit
    the card). On the same config it has the settings of the engine
    ``build_serving_model`` makes (runner, n-gram speculation, scheduler),
    takes the weights as they are, and serves."""
    import chip_smoke

    cfg = dataclasses.replace(treg.DEBUG_PRESETS["tiny-moe"],
                              dtype="float32")
    params = treg.synthetic_quantized_params(cfg, "int8", device="cpu")
    mcfg = ModelConfig.from_dict({
        "name": "moe", "model": "debug:tiny-moe", "context_size": 256,
        "engine": {"dtype": "float32", "kv_dtype": "float32",
                   "max_slots": 2, "kv_block_tokens": 16,
                   "quantization": "int8"}})
    mcfg.set_defaults()
    app = AppConfig(device="cpu")
    mine = chip_smoke._synthetic_serving_model(mcfg, app, cfg, params)
    ref = tmanager.build_serving_model(mcfg, app)
    try:
        for a in ("num_slots", "max_ctx", "paged", "kv_dtype", "block_tokens",
                  "num_blocks", "prefill_chunk"):
            assert getattr(mine.runner, a) == getattr(ref.runner, a), a
        for a in ("default_max_tokens", "pipeline_depth", "multi_step",
                  "stream_latency_target"):
            assert getattr(mine.scheduler, a) == getattr(ref.scheduler, a), a
        assert mine.scheduler.spec.drafter.name == "ngram"
        assert ref.scheduler.spec.drafter.name == "ngram"
        assert mine.scheduler.spec.gamma == ref.scheduler.spec.gamma
        assert mine.runner.params["layers"]["w_up"] is params["layers"]["w_up"]
        out = mine.scheduler.generate(GenRequest(
            prompt=list(b"hi"), max_new_tokens=3, temperature=0.0,
            ignore_eos=True), timeout=120)
        assert len(out.token_ids) == 3
    finally:
        mine.close()
        ref.close()


# ---------------------------------------------------------------------------
# checkpoints and synthetic weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    """A Mixtral checkpoint (block_sparse_moe.gate, experts.{j}.w1/w3/w2)
    written by the port's writer from the JAX package's weights."""
    params_j, cfg_t, params_t = _model(MOE)
    path = tmp_path_factory.mktemp("mixtral")
    tloader.write_llama_checkpoint(path, cfg_t, params_t, dtype="float32")
    return path


def test_mixtral_checkpoint_names(mixtral_dir):
    index = tloader.read_safetensors_index(mixtral_dir / "model.safetensors")
    assert "model.layers.1.block_sparse_moe.gate.weight" in index
    assert index["model.layers.0.block_sparse_moe.experts.3.w2.weight"][
        4] == (MOE.hidden_size, MOE.intermediate_size)
    assert not any("mlp." in n for n in index)


def test_mixtral_checkpoint_loads_equal_in_both_packages(mixtral_dir):
    cfg_j, pj = jloader.load_llama_params(mixtral_dir, dtype="float32")
    cfg_t, pt = tloader.load_llama_params(mixtral_dir, dtype="float32",
                                          device="cpu")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.num_experts == 4
    flat_j = {k: np.asarray(v) for k, v in pj["layers"].items()}
    assert set(flat_j) == set(pt["layers"])
    for k, v in pt["layers"].items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    params_j, _, _ = _model(MOE)
    np.testing.assert_array_equal(
        pt["layers"]["w_down"].numpy(),
        np.asarray(params_j["layers"]["w_down"]))


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_quantize_on_load_equals_quantize_after_load(mixtral_dir, weights):
    _, after = tloader.load_llama_params(mixtral_dir, dtype="float32",
                                         device="cpu")
    after = tq.quantize_params(after, weights, device="cpu")
    _, on_load = tloader.load_llama_params(
        mixtral_dir, dtype="float32", device="cpu", quantization=weights)

    def same(a, b):
        if isinstance(a, tq.QuantizedTensor):
            assert isinstance(b, tq.QuantizedTensor)
            assert (a.axis, a.mode, a.group) == (b.axis, b.mode, b.group)
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)

    for k in ("embed", "final_norm", "lm_head"):
        same(after[k], on_load[k])
    assert set(after["layers"]) == set(on_load["layers"])
    for k in after["layers"]:
        same(after["layers"][k], on_load["layers"][k])


def test_resolve_quantizes_a_checkpoint_as_it_loads(mixtral_dir,
                                                    monkeypatch):
    """A checkpoint dir with ``quantization`` set never holds its whole
    float tree: quantize_params is not called on it."""
    def boom(*a, **k):
        raise AssertionError("the whole tree was quantized after loading")

    monkeypatch.setattr(treg, "quantize_params", boom)
    m = treg.resolve_model(str(mixtral_dir), dtype="float32", device="cpu",
                           quantization="int8")
    assert isinstance(m.params["layers"]["w_gate"], tq.QuantizedTensor)
    assert m.cfg.num_experts == 4


def test_tiny_moe_preset_resolves():
    m = treg.resolve_model("debug:tiny-moe", dtype="float32", device="cpu")
    assert m.cfg.num_experts == 4
    assert tuple(m.params["layers"]["w_gate"].shape) == (2, 4, 64, 96)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("preset", ["tiny-moe", "small"])
def test_synthetic_quantized_params_match_jax_layout(mode, preset):
    """Shapes, dtypes, axes, modes and scales equal to the JAX package's;
    the int values come from another generator (a seeded torch.Generator
    against jax.random), so only their range is compared."""
    cfg_j = jreg.DEBUG_PRESETS[preset]
    cfg_t = treg.DEBUG_PRESETS[preset]
    pj = jreg.synthetic_quantized_params(cfg_j, mode)
    pt = treg.synthetic_quantized_params(cfg_t, mode, device="cpu")

    def check(a, b):
        if isinstance(a, jq.QuantizedTensor):
            assert isinstance(b, tq.QuantizedTensor)
            assert (a.axis, a.mode) == (b.axis, b.mode)
            np.testing.assert_array_equal(b.scale.numpy(),
                                          np.asarray(a.scale))
            if a.mode == "w4":
                q = tqm.unpack_w4(b.q, b.axis)
                assert b.group == a.group
                lim = 7
            else:
                q = b.q
                lim = 127
            assert tuple(q.shape) == tuple(a.q.shape)
            assert int(q.min()) >= -lim and int(q.max()) <= lim
            assert int(q.max()) == lim and int(q.min()) == -lim
        else:
            assert tuple(b.shape) == tuple(a.shape)
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            if a.ndim == 1 or preset == "small" or a.shape[-1] != 4:
                np.testing.assert_array_equal(b.float().numpy(),
                                              np.asarray(a, np.float32))

    for k in ("embed", "final_norm", "lm_head"):
        check(pj[k], pt[k])
    assert set(pj["layers"]) == set(pt["layers"])
    for k in pj["layers"]:
        if k == "moe_gate":   # N(0, 0.02) draws in the compute dtype
            assert tuple(pt["layers"][k].shape) == pj["layers"][k].shape
            assert abs(float(pt["layers"][k].float().std()) - 0.02) < 0.01
            continue
        check(pj["layers"][k], pt["layers"][k])


def test_synthetic_weights_serve_the_forward():
    cfg = dataclasses.replace(treg.DEBUG_PRESETS["tiny-moe"],
                              dtype="float32")
    params = treg.synthetic_quantized_params(cfg, "int8", seed=3,
                                             device="cpu")
    again = treg.synthetic_quantized_params(cfg, "int8", seed=3,
                                            device="cpu")
    assert torch.equal(params["layers"]["w_up"].q, again["layers"]["w_up"].q)
    tokens = torch.tensor([[1, 2, 3, 4]])
    pos = torch.arange(4)[None]
    mask = tkvc.resume_mask(cfg, 4, 0, 4, device="cpu").expand(1, 4, 4)

    def write(kv, k, v):
        return kv, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    h, _ = tl.forward(cfg, params, tokens, pos, write, None, mask,
                      tl.rope_table(cfg, 8, device="cpu"))
    logits = tl.logits_from_hidden(cfg, params, h)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all() and float(logits.std()) > 0
