"""Quantized-weight matmul kernels of the PyTorch port against the JAX
package.

On the CPU the port's ``w8_matmul`` / ``w4_matmul`` take their plain
PyTorch versions; those must match the JAX Pallas kernels run in
interpret mode (as tests/test_qmatmul.py and tests/test_int4.py run them)
within atol/rtol 1e-4 in float32, the tolerance of tests/test_qmatmul.py:
both accumulate f32 products of the same int values and apply the same
scales; only the order of summation differs. The eligibility gates must
agree with JAX's. The CUDA kernels are checked on the card against the
plain versions by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.ops import qmatmul as jqm  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(M, K, N, seed, transpose=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(N, K) if transpose else (K, N)) * 0.02).astype(
        np.float32)
    return x, w


@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (1, 128, 128),
                                   (16, 512, 256)])
def test_w8_ref_matches_jax_kernel(M, K, N):
    x, w = _inputs(M, K, N, 0)
    qt = jq.quantize_tensor(jnp.asarray(w), axis=0)
    want = np.asarray(jqm.w8_matmul(jnp.asarray(x), qt.q, qt.scale,
                                    interpret=True))
    q, s = torch.from_numpy(np.asarray(qt.q)), torch.from_numpy(
        np.asarray(qt.scale))
    got = tqm.w8_matmul(torch.from_numpy(x), q, s)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tqm.w8_matmul_ref(torch.from_numpy(x), q,
                                                 s).numpy(), want, **TOL)


def test_w8_ref_transposed_matches_jax_kernel():
    """The tied-embedding lm_head orientation: x @ table.T, per-row scale."""
    x, tbl = _inputs(8, 256, 384, 1, transpose=True)
    qt = jq.quantize_tensor(jnp.asarray(tbl), axis=1)
    want = np.asarray(jqm.w8_matmul(jnp.asarray(x), qt.q, qt.scale,
                                    transpose_w=True, interpret=True))
    got = tqm.w8_matmul(torch.from_numpy(x),
                        torch.from_numpy(np.asarray(qt.q)),
                        torch.from_numpy(np.asarray(qt.scale)),
                        transpose_w=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("M,K,N,group", [(8, 256, 384, 128),
                                         (1, 512, 128, 256),
                                         (16, 384, 256, 128)])
def test_w4_ref_matches_jax_kernel(M, K, N, group):
    x, w = _inputs(M, K, N, 2)
    jt = jq.quantize_tensor4(jnp.asarray(w), axis=0, group=group)
    want = np.asarray(jqm.w4_matmul(jnp.asarray(x), jt.q, jt.scale,
                                    interpret=True))
    tt = tq.quantize_tensor4(torch.from_numpy(w), axis=0, group=group)
    got = tqm.w4_matmul(torch.from_numpy(x), tt.q, tt.scale)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _gate_cases():
    """(x shape, q, scale, transpose) cases of tests/test_qmatmul.py's
    eligibility test, plus the transposed and w4 ones."""
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 127, (256, 384)).astype(np.int8)
    s = np.ones(384, np.float32)
    q_odd = rng.integers(-127, 127, (250, 384)).astype(np.int8)
    return [
        ((8, 256), q, s, False),
        ((8, 100), q, s, False),       # K mismatch
        ((512, 256), q, s, False),     # prefill-sized M
        ((8, 250), q_odd, s, False),   # unaligned K
        ((8, 256), q, np.ones((2, 384), np.float32), False),  # grouped
        ((8, 384), q, np.ones(256, np.float32), True),        # tied
        ((2, 4, 256), q, s, False),    # M over leading dims
        ((300, 256), q, s, False),
    ]


def test_w8_eligibility_gates_agree_with_jax():
    for x_shape, q, s, tr in _gate_cases():
        want = jqm.eligible(x_shape, jnp.asarray(q), jnp.asarray(s), tr)
        got = tqm.eligible(x_shape, torch.from_numpy(q), torch.from_numpy(s),
                           tr)
        assert got == want, (x_shape, q.shape, s.shape, tr)


@pytest.mark.parametrize("K,N,group,x_shape", [
    (256, 384, 128, (8, 256)), (256, 384, 128, (8, 100)),
    (256, 384, 128, (512, 256)), (256, 384, 64, (8, 256)),
    (320, 384, 128, (8, 320)), (256, 200, 128, (8, 256)),
    (512, 128, 256, (1, 2, 512))])
def test_w4_eligibility_gates_agree_with_jax(K, N, group, x_shape):
    w = np.random.default_rng(3).normal(size=(K, N)).astype(np.float32)
    jt = jq.quantize_tensor4(jnp.asarray(w), 0, group=group)
    tt = tq.quantize_tensor4(torch.from_numpy(w), 0, group=group)
    assert tqm.w4_eligible(x_shape, tt.q, tt.scale) == jqm.w4_eligible(
        x_shape, jt.q, jt.scale)


def test_cpu_wrappers_do_not_count_launches():
    before = (tqm.w8_matmul.launches, tqm.w4_matmul.launches)
    x, w = _inputs(2, 128, 128, 4)
    t8 = tq.quantize_tensor(torch.from_numpy(w), 0)
    t4 = tq.quantize_tensor4(torch.from_numpy(w), 0)
    tqm.w8_matmul(torch.from_numpy(x), t8.q, t8.scale)
    tqm.w4_matmul(torch.from_numpy(x), t4.q, t4.scale)
    assert (tqm.w8_matmul.launches, tqm.w4_matmul.launches) == before
