"""int8_w8a8 weights of the PyTorch port against the JAX package.

``quantize_params(mode="int8_w8a8")`` gives the JAX package's tree (the
per-channel int8 bytes and scales, mode w8a8 on embed, lm_head and the
layer matmuls, expert stacks per-channel w8). ``matmul`` / ``matmul_t``
on a w8a8 weight quantize x per token, take the int8 product in int32
(``torch._int_mm``) and scale the f32 accumulator in the JAX package's
order: float32 results are bit-equal to its, bfloat16 ones within 1e-2 of
the largest output (the final rounding to bf16 of products that differ
only in the order of their last float32 operations). The product equals
its exact float64 plain version. Quantizing a checkpoint as it loads
gives the tree of quantizing after the load, and greedy tokens on the
paged (int8 pool) and contiguous layouts equal the JAX runner's, with
no w8 kernel call on the way. Inputs come from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import loader as tloader  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.models import registry as treg  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_quant import _tree_equal  # noqa: E402
from test_torch_runner import PROMPTS, RUNNER_KW, _greedy, _model  # noqa: E402


def _w(shape, seed, scale=0.02):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("preset", ["small", "small-tied"])
def test_quantize_params_equals_jax_tree(preset):
    tie = preset == "small-tied"
    cfg_j = dataclasses.replace(J_PRESETS["small"], dtype="float32",
                                tie_word_embeddings=tie,
                                num_layers=2 if tie else 4)
    params_j = jl.init_params(jax.random.key(0), cfg_j)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, device="cpu")
    want = tl.params_from_numpy(jax.tree.map(
        np.asarray, jq.quantize_params(params_j, "int8_w8a8")), cfg_t,
        device="cpu")
    got = tq.quantize_params(params_t, "int8_w8a8", device="cpu")
    _tree_equal(got, want)
    assert got["embed"].mode == "w8a8"
    assert got["layers"]["wq"].mode == "w8a8"
    assert tie or got["lm_head"].mode == "w8a8"


def _pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    if dtype == jnp.bfloat16:
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(j))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,K,N", [((8,), 256, 384), ((2, 5), 64, 40),
                                      ((300,), 128, 128), ((1,), 24, 16)])
@pytest.mark.parametrize("transpose", [False, True])
def test_matmul_matches_jax(lead, K, N, dtype, transpose):
    """matmul against a [K, N] weight over K, matmul_t against an [N, K]
    table per row: f32 bit-equal, bf16 within 1e-2 of the largest."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = np.random.default_rng(4).normal(size=(*lead, K)).astype(np.float32)
    w = _w((N, K) if transpose else (K, N), 5)
    axis = 1 if transpose else 0
    jw = dataclasses.replace(jq.quantize_tensor(jnp.asarray(w), axis),
                             mode="w8a8")
    tw = tq.quantize_tensor(torch.from_numpy(w), axis, "w8a8")
    assert torch.equal(tw.q, torch.from_numpy(np.array(jw.q)))
    xj, xt = _pair(x, jdt)
    if transpose:
        want, got = jq.matmul_t(xj, jw), tq.matmul_t(xt, tw)
    else:
        want, got = jq.matmul(xj, jw), tq.matmul(xt, tw)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (*lead, N)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("M,K,N", [(1, 64, 40), (17, 256, 384),
                                   (40, 4096, 1024), (8, 256, 32001),
                                   (3, 60, 37)])
def test_int8_product_equals_its_plain_version(M, K, N):
    """The library product in int32 equals the exact float64 product,
    at full int8 range (the largest sums a row can reach), with the
    padding of rows, of a K off a multiple of 8 and of an N off one (a
    32001-id vocabulary)."""
    rng = np.random.default_rng(M)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    want = tq.int8_matmul_ref(xq, wq)
    assert want.dtype == torch.int32
    assert torch.equal(tq.int8_matmul(xq, wq), want)
    wt = wq.t().contiguous()
    assert torch.equal(tq.int8_matmul(xq, wt, transpose_w=True), want)
    assert torch.equal(want, (xq.long() @ wq.long()).int())


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    _, _, cfg_t, params_t = _model("small")
    path = tmp_path_factory.mktemp("small-ckpt")
    tloader.write_llama_checkpoint(path, cfg_t, params_t, dtype="float32")
    return path


def test_quantize_on_load_equals_quantize_after_load(small_dir):
    _, after = tloader.load_llama_params(small_dir, dtype="float32",
                                         device="cpu")
    after = tq.quantize_params(after, "int8_w8a8", device="cpu")
    _, on_load = tloader.load_llama_params(
        small_dir, dtype="float32", device="cpu", quantization="int8_w8a8")
    _tree_equal(on_load, after)
    assert on_load["layers"]["w_down"].mode == "w8a8"


def test_synthetic_w8a8_params():
    cfg = dataclasses.replace(treg.DEBUG_PRESETS["tiny-moe"],
                              dtype="float32")
    p = treg.synthetic_quantized_params(cfg, "int8_w8a8", device="cpu")
    assert p["embed"].mode == p["lm_head"].mode == "w8a8"
    assert p["layers"]["wq"].mode == "w8a8"
    # expert stacks stay per-channel w8 on the expert grid
    assert p["layers"]["w_gate"].mode == "w8"
    assert p["layers"]["wq"].q.dtype == torch.int8


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_tokens_match_jax(paged, monkeypatch):
    """w8a8 weights with an int8 KV pool (paged) or cache (contiguous):
    the JAX runner's greedy tokens, and no call reaches the w8 kernel's
    wrapper (a w8a8 product never takes K4)."""
    cfg_j, params_j, cfg_t, params_t = _model("small")
    kw = dict(RUNNER_KW, kv_dtype="int8")
    if not paged:
        kw = dict(num_slots=4, max_ctx=160, prefill_buckets=[32, 64],
                  kv_dtype="int8")
    jr = JaxRunner(cfg_j, jq.quantize_params(params_j, "int8_w8a8"),
                   paged=paged, attn_impl="xla", **kw)
    want = _greedy(jr, PROMPTS)[1]
    calls = []
    real = tqm.w8_matmul

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tqm, "w8_matmul", counted)
    qparams = tq.quantize_params(params_t, "int8_w8a8", device="cpu")
    r = ModelRunner(cfg_t, qparams, device="cpu", paged=paged, **kw)
    before = real.launches
    _, seqs = _greedy(r, PROMPTS)
    assert seqs == want
    assert calls == [] and real.launches == before
    # the same weights as int8 (w8) do reach the wrapper
    r8 = ModelRunner(cfg_t, tq.quantize_params(params_t, "int8",
                                               device="cpu"),
                     device="cpu", paged=paged, **kw)
    _greedy(r8, PROMPTS[:1], steps=1)
    assert calls
