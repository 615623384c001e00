"""Quantization of the PyTorch port held against the JAX package.

The quantizers must give JAX's ``q`` and ``scale`` bit for bit from the
same input (int4 weights after the port's w4 unpacking, the int4 KV pool
byte for byte in the halves layout). Products (``matmul``, ``matmul_t``,
``embed_rows``, ``dequantize_tensor``) match the JAX functions within
atol/rtol 1e-5 in float32: both sides compute in f32 from the same int
values and scales, and only the order of summation differs. The quantized
paged KV writes must leave the same pool bytes and scales as JAX's.
Inputs come from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine import kvcache as jkvc  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu_torch.engine import kvcache as tkvc  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _w(shape, seed, scale=0.02):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _bf16(a):
    """(JAX bf16 array, port bf16 tensor) holding the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


@pytest.mark.parametrize("shape,axis", [((64, 96), 0), ((64, 96), 1),
                                        ((3, 256, 384), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_is_bit_exact(shape, axis, dtype):
    w = _w(shape, 0)
    if dtype == "bfloat16":
        wj, wt = _bf16(w)
    else:
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
    want = jq.quantize_tensor(wj, axis)
    got = tq.quantize_tensor(wt, axis)
    assert got.q.dtype == torch.int8 and got.mode == "w8"
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("shape,axis,group", [
    ((256, 384), 0, 128), ((3, 256, 128), 1, 128), ((96, 40), 0, 128),
    ((2, 512, 256), 1, 256)])
def test_quantize_tensor4_is_bit_exact(shape, axis, group):
    w = _w(shape, 1)
    want = jq.quantize_tensor4(jnp.asarray(w), axis, group=group)
    got = tq.quantize_tensor4(torch.from_numpy(w), axis, group=group)
    assert got.q.dtype == torch.uint8 and got.mode == "w4"
    assert got.q.shape[axis] * 2 == shape[axis]
    assert got.group == want.group
    np.testing.assert_array_equal(tqm.unpack_w4(got.q, axis).numpy(),
                                  np.asarray(want.q).astype(np.int8))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_w4_packing_pairs_rows_and_round_trips():
    q = torch.from_numpy(np.random.default_rng(2).integers(
        -8, 8, (6, 10)).astype(np.int8))
    p = tqm.pack_w4(q, 0)
    assert p.shape == (3, 10) and p.dtype == torch.uint8
    assert int(p[1, 4]) == (int(q[2, 4]) & 0xF) | ((int(q[3, 4]) & 0xF) << 4)
    np.testing.assert_array_equal(tqm.unpack_w4(p, 0).numpy(), q.numpy())
    np.testing.assert_array_equal(
        tqm.unpack_w4(tqm.pack_w4(q, 1), 1).numpy(), q.numpy())
    with pytest.raises(ValueError):
        tqm.pack_w4(q[:5], 0)


@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 4, 3, 128)])
def test_lastdim_quantizers_are_bit_exact(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    for jfn, tfn in ((jq.quantize_lastdim, tq.quantize_lastdim),
                     (jq.quantize_lastdim4, tq.quantize_lastdim4)):
        wq, ws = jfn(jnp.asarray(x))
        gq, gs = tfn(torch.from_numpy(x))
        assert gq.dtype == torch.int8
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    packed, _ = jq.quantize_lastdim4(jnp.asarray(x))
    np.testing.assert_array_equal(
        tq.unpack_int4_lastdim(torch.from_numpy(np.asarray(packed))).numpy(),
        np.asarray(jq.unpack_int4_lastdim(packed)))
    with pytest.raises(ValueError):
        tq.quantize_lastdim4(torch.ones((2, 15)))


def _tree_equal(got, want):
    """Leaf-by-leaf equality of two port parameter trees."""
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = got[k], want[k]
        if isinstance(a, dict):
            _tree_equal(a, b)
        elif isinstance(a, tq.QuantizedTensor):
            assert isinstance(b, tq.QuantizedTensor), k
            assert (a.axis, a.mode, a.group) == (b.axis, b.mode, b.group), k
            assert a.q.dtype == b.q.dtype, k
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), k
        else:
            assert torch.equal(a, b), k


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("preset", ["small", "small-tied"])
def test_quantize_params_equals_jax_tree(mode, preset):
    """The port quantizes a debug:small-shaped tree (and a tied one) into
    exactly the tree JAX quantizes and ``params_from_numpy`` carries."""
    if preset == "small":
        cfg_j = dataclasses.replace(J_PRESETS["small"], dtype="float32")
    else:
        cfg_j = dataclasses.replace(J_PRESETS["small"], dtype="float32",
                                    tie_word_embeddings=True, num_layers=2)
    params_j = jl.init_params(jax.random.key(0), cfg_j)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, device="cpu")
    want = tl.params_from_numpy(
        jax.tree.map(np.asarray, jq.quantize_params(params_j, mode)), cfg_t,
        device="cpu")
    got = tq.quantize_params(params_t, mode, device="cpu")
    _tree_equal(got, want)
    assert got["embed"].mode == "w8"
    assert got["layers"]["wq"].mode == ("w4" if mode == "int4" else "w8")


def test_quantize_params_refuses_w8a8():
    """int8_w8a8 (once refused) quantizes as the JAX package does (the
    whole tree: tests/test_torch_w8a8.py); an unknown mode is refused."""
    w = _w((8, 4), 0)
    got = tq.quantize_params(
        {"embed": torch.from_numpy(w), "final_norm": torch.ones(4),
         "layers": {}}, "int8_w8a8", device="cpu")["embed"]
    want = jq.quantize_tensor(jnp.asarray(w), 1)
    assert got.mode == "w8a8" and got.axis == 1
    assert torch.equal(got.q, torch.from_numpy(np.array(want.q)))
    assert torch.equal(got.scale, torch.from_numpy(np.array(want.scale)))
    with pytest.raises(ValueError, match="int2"):
        tq.quantize_params({}, "int2", device="cpu")


def test_params_from_numpy_refuses_w8a8_leaves():
    """A w8a8 leaf of the JAX package (once refused) carries across with
    its mode; an unknown mode is refused."""
    cfg = tl.LlamaConfig(vocab_size=8, hidden_size=4, num_layers=1,
                         num_heads=1, num_kv_heads=1, dtype="float32")
    leaf = jq.quantize_tensor(jnp.ones((8, 4)), 1)
    leaf = jax.tree.map(np.asarray, dataclasses.replace(leaf, mode="w8a8"))
    got = tl.params_from_numpy({"embed": leaf}, cfg, device="cpu")["embed"]
    assert (got.mode, got.axis) == ("w8a8", 1)
    assert torch.equal(got.q, torch.from_numpy(np.array(leaf.q)))
    with pytest.raises(ValueError, match="w2"):
        tl.params_from_numpy(
            {"embed": dataclasses.replace(leaf, mode="w2")}, cfg,
            device="cpu")


@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (3, 64, 40),
                                   (300, 128, 128)])
def test_matmul_matches_jax(M, K, N):
    """Eligible shapes (the plain versions of the kernels on the CPU) and
    ineligible ones (unaligned K, M > 256) both match JAX's products."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = _w((K, N), 5)
    for jqt, tqt in ((jq.quantize_tensor(jnp.asarray(w), 0),
                      tq.quantize_tensor(torch.from_numpy(w), 0)),
                     (jq.quantize_tensor4(jnp.asarray(w), 0),
                      tq.quantize_tensor4(torch.from_numpy(w), 0))):
        want = np.asarray(jq.matmul(jnp.asarray(x), jqt))
        got = tq.matmul(torch.from_numpy(x), tqt)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(
            tq.dequantize_tensor(tqt).numpy(),
            np.asarray(jq.dequantize_tensor(jqt)), **TOL)
    # 3-D activations keep their leading shape
    x3 = torch.from_numpy(x[None])
    assert tq.matmul(x3, tq.quantize_tensor(torch.from_numpy(w), 0)).shape \
        == (1, M, N)


@pytest.mark.parametrize("V", [384, 100])
def test_matmul_t_and_embed_rows_match_jax(V):
    rng = np.random.default_rng(6)
    table = _w((V, 128), 7)
    x = rng.normal(size=(1, 5, 128)).astype(np.float32)
    tokens = rng.integers(0, V, (2, 7)).astype(np.int32)
    jqt = jq.quantize_tensor(jnp.asarray(table), 1)
    tqt = tq.quantize_tensor(torch.from_numpy(table), 1)
    np.testing.assert_allclose(
        tq.matmul_t(torch.from_numpy(x), tqt).numpy(),
        np.asarray(jq.matmul_t(jnp.asarray(x), jqt)), **TOL)
    np.testing.assert_allclose(
        tq.embed_rows(tqt, torch.from_numpy(tokens).long(),
                      torch.float32).numpy(),
        np.asarray(jq.embed_rows(jqt, jnp.asarray(tokens), jnp.float32)),
        **TOL)


def test_layer_slice_of_a_stacked_weight():
    w = _w((3, 256, 128), 8)
    q8 = tq.quantize_tensor(torch.from_numpy(w), 1)
    q4 = tq.quantize_tensor4(torch.from_numpy(w), 1)
    for qt in (q8, q4):
        one = qt[2]
        assert one.axis == 0
        full = tq.dequantize_tensor(qt)
        np.testing.assert_array_equal(tq.dequantize_tensor(one).numpy(),
                                      full[2].numpy())


# ---------------------------------------------------------------------------
# quantized paged KV pools
# ---------------------------------------------------------------------------

_KV_CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=64,
               num_layers=1, num_heads=4, num_kv_heads=2,
               dtype="float32")


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_init_paged_cache_quantized_layout(kv_dtype):
    cfg = tl.LlamaConfig(**_KV_CFG)
    kv = tkvc.init_paged_cache(cfg, 5, 8, kv_dtype, device="cpu")
    hd = cfg.hd
    assert kv.k.dtype == kv.v.dtype == torch.int8
    assert kv.k.shape == (1, 5, 2, 8, hd // 2 if kv_dtype == "int4" else hd)
    assert kv.k_scale.shape == kv.v_scale.shape == (1, 5, 2, 8)
    assert kv.k_scale.dtype == torch.float32
    assert len(kv.stacked()) == 4
    assert len(tkvc.init_paged_cache(cfg, 5, 8, "float32",
                                     device="cpu").stacked()) == 2


def test_init_paged_cache_int4_odd_head_dim_raises():
    cfg = tl.LlamaConfig(**{**_KV_CFG, "head_dim": 15})
    with pytest.raises(ValueError, match="even head_dim"):
        tkvc.init_paged_cache(cfg, 3, 8, "int4", device="cpu")


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_paged_writes_match_jax(kv_dtype):
    """Decode and prefill writes into scaled pools leave JAX's bytes and
    scales; the prefill policy's dequantized context matches JAX's."""
    cfg_j = jl.LlamaConfig(**_KV_CFG)
    cfg_t = tl.LlamaConfig(**_KV_CFG)
    rng = np.random.default_rng(9)
    N, bt, MB, H, hd = 7, 8, 3, 2, cfg_t.hd
    jkv = jkvc.init_paged_cache(cfg_j, N, bt, kv_dtype)
    tkv = tkvc.init_paged_cache(cfg_t, N, bt, kv_dtype, device="cpu")
    jstack = tuple(t[0] for t in jkv.stacked())
    tstack = tuple(t[0] for t in tkv.stacked())
    table_row = np.array([4, 2, 6], np.int32)
    T, length = 16, 13
    k = rng.normal(size=(1, T, H, hd)).astype(np.float32)
    v = rng.normal(size=(1, T, H, hd)).astype(np.float32)
    new_j, keys_j, vals_j = jkvc.paged_prefill_write(
        jnp.asarray(table_row), jnp.int32(5), jnp.int32(length))(
            jstack, jnp.asarray(k), jnp.asarray(v))
    _, keys_t, vals_t = tkvc.paged_prefill_write(
        torch.from_numpy(table_row), 5, length)(
            tstack, torch.from_numpy(k), torch.from_numpy(v))
    # block 0 (trash) takes the padding rows, in no defined order
    for a, b in zip(tstack, new_j):
        np.testing.assert_array_equal(a[1:].numpy(), np.asarray(b)[1:])
    live = 5 + length
    np.testing.assert_allclose(keys_t[:, :, :live].numpy(),
                               np.asarray(keys_j)[:, :, :live], **TOL)
    np.testing.assert_allclose(vals_t[:, :, :live].numpy(),
                               np.asarray(vals_j)[:, :, :live], **TOL)

    # decode: two slots, one on a block edge
    tables = np.array([[4, 2, 6], [1, 3, 5]], np.int32)
    pos = np.array([18, 8], np.int32)
    kd = rng.normal(size=(2, 1, H, hd)).astype(np.float32)
    vd = rng.normal(size=(2, 1, H, hd)).astype(np.float32)
    new_j, _, _ = jkvc.paged_decode_write(jnp.asarray(tables),
                                          jnp.asarray(pos), raw=True)(
        new_j, jnp.asarray(kd), jnp.asarray(vd))
    _, kt, vt = tkvc.paged_decode_write(torch.from_numpy(tables),
                                        torch.from_numpy(pos))(
        tstack, torch.from_numpy(kd), torch.from_numpy(vd))
    assert kt[0] is tstack[0] and kt[1] is tstack[2]
    assert vt[0] is tstack[1] and vt[1] is tstack[3]
    for a, b in zip(tstack, new_j):
        np.testing.assert_array_equal(a[1:].numpy(), np.asarray(b)[1:])
