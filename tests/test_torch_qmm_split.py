"""The split of K in the port's bf16 tensor-core tile for K4/K5, on the CPU.

``w4_matmul_split_ref`` and ``w8_matmul_split_ref`` model how the CUDA
tile (``csrc/qmm_mma.cuh``) partitions K over CUDA blocks: f32 partials
per split on group edges (128-row edges for w8), folded in split order.
They must match the JAX Pallas kernels, run in interpret mode as
tests/test_qmatmul.py runs them, within atol/rtol 1e-4 in float32 (the
tolerance of tests/test_torch_qmatmul.py: the same f32 products of the
same integers and scales, summed in another order) at one split, two, and
the most the shape allows. ``qmm_split_plan`` takes shapes and an SM count
and must cut K on group edges into a grid that covers the SMs.
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


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            (rng.normal(size=(K, N)) * 0.02).astype(np.float32))


def _splits(groups):
    """One split, two, and the most group edges allow (one per group)."""
    return sorted({1, min(2, groups), groups})


W4_CASES = [(8, 512, 256, 128), (17, 1024, 128, 256), (1, 384, 128, 128),
            (64, 768, 256, 256)]


@pytest.mark.parametrize("M,K,N,group", W4_CASES)
def test_w4_split_model_matches_jax_kernel(M, K, N, group):
    x, w = _inputs(M, K, N, 7)
    jt = jq.quantize_tensor4(jnp.asarray(w), axis=0, group=group)
    want = np.asarray(jqm.w4_matmul(jnp.asarray(x), jt.q, jt.scale,
                                    interpret=True))
    tt = tq.quantize_tensor4(torch.from_numpy(w), axis=0, group=group)
    assert tt.group == group
    for s in _splits(K // group):
        got = tqm.w4_matmul_split_ref(torch.from_numpy(x), tt.q, tt.scale, s)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{s} splits",
                                   **TOL)


W8_CASES = [(8, 512, 256, False), (3, 384, 384, False),
            (256, 1024, 128, False), (8, 512, 384, True), (17, 256, 128, True)]


@pytest.mark.parametrize("M,K,N,transpose", W8_CASES)
def test_w8_split_model_matches_jax_kernel(M, K, N, transpose):
    """Both orientations; ``transpose``: the tied lm_head's [N, K] table
    with per-row scales."""
    x, w = _inputs(M, K, N, 8)
    w = w.T.copy() if transpose else w
    qt = jq.quantize_tensor(jnp.asarray(w), axis=1 if transpose else 0)
    want = np.asarray(jqm.w8_matmul(jnp.asarray(x), qt.q, qt.scale,
                                    transpose_w=transpose, interpret=True))
    q = torch.from_numpy(np.array(qt.q))
    scale = torch.from_numpy(np.array(qt.scale))
    for s in _splits(K // tqm.QMM_BK):
        got = tqm.w8_matmul_split_ref(torch.from_numpy(x), q, scale, s,
                                      transpose_w=transpose)
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"{s} splits",
                                   **TOL)


def test_split_models_refuse_a_cut_off_group_edges():
    x, w = _inputs(8, 1024, 128, 9)
    tt = tq.quantize_tensor4(torch.from_numpy(w), axis=0)
    # 8 groups: 5 splits would need runs of 2 groups, which make 4
    for bad in (0, 5, 9):
        with pytest.raises(ValueError, match="splits"):
            tqm.w4_matmul_split_ref(torch.from_numpy(x), tt.q, tt.scale, bad)
    t8 = tq.quantize_tensor(torch.from_numpy(w), 0)
    with pytest.raises(ValueError, match="splits"):
        tqm.w8_matmul_split_ref(torch.from_numpy(x), t8.q, t8.scale, 9)


# Llama-3-8B's decode projections (K, N) and the M edges of the tile
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("kind,group", [("w8", 128), ("w4", 128),
                                        ("w4", 256)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 256])
def test_split_plan_cuts_on_group_edges_and_covers_the_sms(M, kind, group,
                                                           sms):
    for K, N in SHAPES_8B:
        mi, splits, split_k = tqm.qmm_split_plan(M, K, N, group, sms, kind)
        assert mi == (1 if M <= 8 else 2 if M <= 16 else 4)
        assert split_k % group == 0 and split_k % tqm.QMM_BK == 0
        assert (splits - 1) * split_k < K <= splits * split_k
        # a split walks at least two stages (one group when groups are
        # longer), so K can be cut at most K / that many times
        assert splits == 1 or split_k >= max(group, tqm.QMM_MIN_SPLIT_K)
        most = K // max(group, tqm.QMM_MIN_SPLIT_K)
        tiles = (N // tqm.QMM_BN) * -(-M // (8 * mi))
        grid = tiles * splits
        # every SM gets a CUDA block whenever the split edges allow it
        assert grid >= min(sms, tiles * most), (K, N, grid)
        # a grid that covers the card is not split
        if tiles >= sms:
            assert splits == 1
        # the plan reads shapes only: the same shapes give the same plan
        assert tqm.qmm_split_plan(M, K, N, group, sms, kind) == (
            mi, splits, split_k)


def test_split_plan_at_the_serving_shapes():
    """The plan chip_smoke.py and the decode step run at M = 8 on 132 SMs
    (one per projection, PERF.md §6): narrow weights split most, K5 twice
    as finely as K4 where the edges allow."""
    plan = {kind: {(K, N): tqm.qmm_split_plan(8, K, N, 128, 132, kind)
                   for K, N in SHAPES_8B} for kind in ("w8", "w4")}
    assert plan["w8"] == {(4096, 4096): (1, 8, 512),
                          (4096, 1024): (1, 16, 256),
                          (4096, 14336): (1, 2, 2048),
                          (14336, 4096): (1, 8, 1792),
                          (4096, 128256): (1, 1, 4096)}
    assert plan["w4"] == {(4096, 4096): (1, 16, 256),
                          (4096, 1024): (1, 16, 256),
                          (4096, 14336): (1, 5, 896),
                          (14336, 4096): (1, 16, 896),
                          (4096, 128256): (1, 1, 4096)}
    for kind in ("w8", "w4"):
        assert tqm.qmm_split_plan(256, 4096, 4096, 128, 132, kind) == (
            4, 1, 4096)


def test_split_plan_refuses_shapes_the_tile_does_not_take():
    for args in ((8, 4096, 4000, 128, 132, "w4"),
                 (8, 4096, 4096, 64, 132, "w4"),
                 (8, 4096, 4096, 128, 0, "w8"),
                 (0, 4096, 4096, 128, 132, "w8"),
                 (8, 4096, 4096, 128, 132, "int4")):
        with pytest.raises(ValueError):
            tqm.qmm_split_plan(*args)
