"""Paged decode attention of the PyTorch port held against the JAX package.

On the CPU the port's ``paged_decode_attention`` takes its plain PyTorch
version; it must match the JAX Pallas kernel (interpret mode) and the JAX
plain reference within atol 1e-5 in float32 (both sides compute a float32
softmax over the same inputs; only summation order differs). Inputs come
from a numpy seed; tables are shuffled, positions ragged and on block
edges. The CUDA kernel itself is checked on the card (``cuda`` marker).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from localai_tpu import ops as jops  # noqa: E402
from localai_tpu_torch import ops as tops  # noqa: E402
from localai_tpu_torch.ops import attention as tatt  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

# (S, Hq, Hkv, hd, bt, MB, positions, window)
CASES = {
    "g2-edges": (3, 4, 2, 16, 8, 4, [7, 8, 31], None),
    "g4-ragged": (4, 8, 2, 32, 16, 4, [0, 15, 16, 63], None),
    "g1": (2, 4, 4, 32, 8, 6, [5, 40], None),
    "window": (3, 8, 2, 16, 8, 8, [3, 30, 63], 11),
    "window-edge": (2, 4, 2, 16, 16, 4, [16, 47], 16),
}


def _inputs(S, Hq, Hkv, hd, bt, MB, positions, seed):
    rng = np.random.default_rng(seed)
    N = S * MB + 1
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    # shuffled physical blocks; block 0 (trash) is never mapped
    tables = (rng.permutation(N - 1) + 1).astype(np.int32).reshape(S, MB)
    return q, k, v, tables, np.asarray(positions, np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_attention_matches_jax(case):
    S, Hq, Hkv, hd, bt, MB, positions, window = CASES[case]
    q, k, v, tables, pos = _inputs(S, Hq, Hkv, hd, bt, MB, positions, 4)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, pos)]
    want_kernel = np.asarray(jops.paged_decode_attention(
        *jargs, sliding_window=window, interpret=True))
    want_ref = np.asarray(jops.paged_decode_attention_ref(
        *jargs, sliding_window=window))
    got = tops.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, tables, pos)],
        sliding_window=window)
    assert got.dtype == torch.float32 and got.shape == (S, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5)


def test_gather_blocks_matches_jax():
    q, k, v, tables, pos = _inputs(2, 4, 2, 8, 4, 3, [1, 2], 5)
    got = tatt.gather_blocks(torch.from_numpy(k), torch.from_numpy(tables))
    want = jops.attention.gather_blocks(jnp.asarray(k), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrapper_does_not_count_launches():
    before = tops.paged_decode_attention.launches
    q, k, v, tables, pos = _inputs(1, 2, 1, 8, 4, 2, [3], 6)
    tops.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, tables, pos)])
    assert tops.paged_decode_attention.launches == before


@pytest.mark.parametrize("head_dim,kv_dtype", [(16, torch.float32),
                                                (128, torch.bfloat16),
                                                (48, torch.float16)])
def test_select_impl_on_cpu_is_the_plain_version(head_dim, kv_dtype):
    """The CPU takes any shape: the wrapper's plain version has no gates."""
    got, why = tops.select_paged_attn_impl(
        device=torch.device("cpu"), num_heads=4, num_kv_heads=2,
        head_dim=head_dim, block_tokens=16, kv_dtype=kv_dtype)
    assert got == "torch" and why


def test_select_impl_on_card_is_the_kernel_or_raises():
    dev = torch.device("cuda")
    impl, why = tops.select_paged_attn_impl(
        device=dev, num_heads=32, num_kv_heads=8, head_dim=128,
        block_tokens=64, kv_dtype=torch.bfloat16)
    assert (impl, why) == ("kernel", "")
    for bad in (dict(head_dim=16), dict(kv_dtype=torch.float16),
                dict(num_heads=24), dict(block_tokens=512,
                                         kv_dtype=torch.float32)):
        kw = dict(num_heads=32, num_kv_heads=8, head_dim=128,
                  block_tokens=64, kv_dtype=torch.bfloat16)
        kw.update(bad)
        with pytest.raises(ValueError):
            tops.select_paged_attn_impl(device=dev, **kw)


def test_kernel_smem_fits_the_serving_shapes():
    for dtype in (torch.bfloat16, torch.float32):
        assert tatt.kernel_gate(dtype, 128, 4, 64) == ""
    assert "shared memory" in tatt.kernel_gate(torch.float32, 128, 4, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """On the card: the kernel against its plain version run in float32 on
    the same inputs. float32 within atol 1e-4; bfloat16 per slot within
    1e-2 of that slot's largest output (the output's bf16 rounding is at
    most 2**-8 of it), so a long-context slot is held as tightly as a
    short one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dt = getattr(torch, dtype)
    q, k, v, tables, pos = _inputs(8, 32, 8, 128, 64, 8, [0, 63, 64, 100,
                                                          200, 300, 400,
                                                          511], 7)
    t = [torch.from_numpy(a).cuda() for a in (q, k, v, tables, pos)]
    before = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(t[0].to(dt), t[1].to(dt), t[2].to(dt),
                                      t[3], t[4])
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    want = tops.paged_decode_attention_ref(
        t[0].to(dt).float(), t[1].to(dt).float(), t[2].to(dt).float(),
        t[3], t[4])
    err = (got.float() - want).abs().flatten(1).amax(1)
    if dt == torch.float32:
        tol = torch.full_like(err, 1e-4)
    else:
        tol = 1e-2 * want.abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err.tolist(), tol.tolist())
