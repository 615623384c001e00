"""The split walk of the port's paged decode kernel, modelled on the CPU.

The CUDA kernel splits each slot's block walk over several CUDA blocks
and merges their partial softmax states (m, l, acc) with a log-sum-exp
merge. ``paged_decode_attention_split_ref`` is the plain PyTorch model of
that split; here it must match the JAX package's ``paged_decode_attention``
(Pallas interpret mode) and its plain reference within atol 1e-5 in
float32, as tests/test_torch_attention.py holds the unsplit plain version:
both sides compute a float32 softmax over the same inputs and only the
summation order differs. ``split_blocks`` 1 and 2 give splits with no live
block and windows that start inside a split; MB gives one split. Scaled
int8 and int4 pools come from the JAX package's quantizers. The split plan
is checked on the CPU with a given SM count.
"""

import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from localai_tpu import ops as jops  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu_torch.ops import attention as tatt  # noqa: E402
from test_torch_attention import CASES, _inputs  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

SPLITS = ("1", "2", "MB")
# every case of the unsplit test, and a window whose first block is odd,
# so that it starts inside a 2-block split
SPLIT_CASES = dict(CASES, **{"window-odd": (2, 8, 2, 16, 8, 8, [45, 62], 20)})


@functools.lru_cache(maxsize=None)
def _case(case: str, pool: str):
    """Inputs of ``case`` (a float pool, or an int8/int4 pool from the JAX
    quantizers) as numpy arrays, and the JAX kernel's and plain
    reference's outputs on them."""
    S, Hq, Hkv, hd, bt, MB, positions, window = SPLIT_CASES[case]
    q, k, v, tables, pos = _inputs(S, Hq, Hkv, hd, bt, MB, positions, 11)
    if pool:
        quantize = (jq.quantize_lastdim4 if pool == "int4"
                    else jq.quantize_lastdim)
        k, ks = quantize(jnp.asarray(k))
        v, vs = quantize(jnp.asarray(v))
        arrays = (q, k, v, tables, pos, ks, vs)
    else:
        arrays = (q, k, v, tables, pos)
    jargs = [jnp.asarray(a) for a in arrays]
    want_kernel = np.asarray(jops.paged_decode_attention(
        *jargs, sliding_window=window, interpret=True))
    want_ref = np.asarray(jops.paged_decode_attention_ref(
        *jargs, sliding_window=window))
    return [np.array(a) for a in arrays], want_kernel, want_ref


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pool", ["", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_model_matches_jax(case, pool, split):
    S, Hq, Hkv, hd, bt, MB, positions, window = SPLIT_CASES[case]
    arrays, want_kernel, want_ref = _case(case, pool)
    t = [torch.from_numpy(a) for a in arrays]
    if pool == "int4":
        assert t[1].shape[-1] * 2 == hd
    bps = MB if split == "MB" else int(split)
    got = tatt.paged_decode_attention_split_ref(
        *t, split_blocks=bps, sliding_window=window)
    assert got.dtype == torch.float32 and got.shape == (S, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5)


def test_split_model_has_empty_and_window_splits():
    """The cases above do reach the split's edges: at split_blocks 1 some
    slot has a split past its last live block, and a window starts inside
    a 2-block split (lo odd) and covers more than one split."""
    empty = window_inside = 0
    for S, Hq, Hkv, hd, bt, MB, positions, window in SPLIT_CASES.values():
        for p in positions:
            nb = min(p // bt + 1, MB)
            empty += nb < MB
            if window:
                lo = max((p - window + 1) // bt, 0)
                window_inside += lo % 2 == 1 and nb - lo > 1
    assert empty and window_inside


def test_split_model_is_the_plain_version_for_one_split():
    """One split is the unsplit walk: the model then equals the plain
    version up to rounding, on a bf16 q too (output in q's dtype)."""
    S, Hq, Hkv, hd, bt, MB, positions, window = CASES["window"]
    q, k, v, tables, pos = [torch.from_numpy(a) for a in _inputs(
        S, Hq, Hkv, hd, bt, MB, positions, 12)]
    for dt in (torch.float32, torch.bfloat16):
        got = tatt.paged_decode_attention_split_ref(
            q.to(dt), k.to(dt), v.to(dt), tables, pos, split_blocks=MB,
            sliding_window=window)
        want = tatt.paged_decode_attention_ref(
            q.to(dt), k.to(dt), v.to(dt), tables, pos, sliding_window=window)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("split_blocks", [1, 2, 4])
def test_split_model_zeroes_a_slot_without_live_blocks(split_blocks):
    """A position past the table whose window starts past it too leaves
    the slot no live block (lo >= nb): every split is (-1e30, 0, 0) and
    the slot's output is 0, as the kernel writes it; the other slot is
    the plain version's."""
    q, k, v, tables, pos = [torch.from_numpy(a) for a in _inputs(
        2, 4, 2, 16, 8, 4, [20, 50], 13)]
    got = tatt.paged_decode_attention_split_ref(
        q, k, v, tables, pos, split_blocks=split_blocks, sliding_window=10)
    want = tatt.paged_decode_attention_ref(q, k, v, tables, pos,
                                           sliding_window=10)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5)
    assert not got[1].any()


def test_split_plan_reads_no_positions():
    """The plan takes shapes, the SM count and the pool kind only: it
    cannot read the device's positions (which would synchronise the
    decode step)."""
    params = list(inspect.signature(tatt.paged_split_plan).parameters)
    assert params == ["S", "Hkv", "MB", "sms", "pool"]


@pytest.mark.parametrize("S,Hkv,MB,sms", [
    (8, 8, 64, 132), (8, 8, 16, 132), (4, 2, 16, 132), (1, 1, 1, 132),
    (1, 1, 2, 132), (1, 1, 3, 132), (64, 8, 64, 132), (256, 8, 64, 132),
    (8, 8, 64, 1), (2, 4, 1000, 108), (3, 1, 7, 16)])
def test_split_plan_covers_the_table(S, Hkv, MB, sms):
    """For every pool kind the splits cover [0, MB) exactly, walk at least
    the pool's MIN_SPLIT_BLOCKS entries (one split when the table is that
    short) and give full tables at most SPLIT_CTAS_PER_SM CUDA blocks per
    SM."""
    for pool in tatt.KERNEL_POOLS:
        least = tatt.MIN_SPLIT_BLOCKS[pool]
        bps, splits = tatt.paged_split_plan(S, Hkv, MB, sms, pool)
        assert 1 <= bps <= MB and splits >= 1
        assert (splits - 1) * bps < MB <= splits * bps
        if MB <= least:
            assert (bps, splits) == (MB, 1)
        else:
            assert bps >= least
        if splits > 1:
            assert splits * S * Hkv <= tatt.SPLIT_CTAS_PER_SM * sms


def test_split_plan_at_the_serving_shape():
    """8 slots x 8 kv heads over 64-entry tables on 132 SMs: 32 splits of
    2 blocks on a float pool (the 4096-token slot walks 2 tiles a split),
    64 splits of 1 on a quantized one; 64 slots: 8 splits of 8."""
    assert tatt.paged_split_plan(8, 8, 64, 132) == (2, 32)
    for pool in ("int8", "int4"):
        assert tatt.paged_split_plan(8, 8, 64, 132, pool) == (1, 64)
    assert tatt.paged_split_plan(64, 8, 64, 132) == (8, 8)


def test_split_plan_refuses_empty_shapes():
    for bad in ((0, 8, 64, 132), (8, 8, 0, 132), (8, 8, 64, 0),
                (8, 8, 64, 132, "fp8")):
        with pytest.raises(ValueError):
            tatt.paged_split_plan(*bad)
