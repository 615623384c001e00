"""The split walk of the port's contiguous decode kernel, modelled on the CPU.

The CUDA kernel cuts each slot's cache row into ``DECODE_TILE``-row
tiles, splits the slot's walk over those tiles across several CUDA blocks
and merges their partial softmax states (m, l, acc) with a log-sum-exp
merge. ``decode_attention_split_ref`` is the plain PyTorch model of that
split; here it must match the JAX package's ``decode_attention`` (Pallas
interpret mode, as tests/test_torch_contiguous.py runs it) at every split
size:

* float32 and scaled int8 caches (the int8 bytes and f32 scales from the
  JAX quantizer go to both sides) within atol 1e-5, as the unsplit K2
  tests hold the plain version: both sides compute a float32 softmax over
  the same inputs and only the summation order differs;
* bfloat16 caches and q (the same bf16 values on both sides) per slot
  within 1e-2 of that slot's largest output: products of bf16 values are
  exact in float32, so the two sides differ by the summation order and
  the final rounding to bf16, at most one bf16 ulp (2**-7 of the value).

The cases reach the split's edges: a context that is no multiple of the
tile, a slot at position 0, and a window of 70 rows that starts inside a
2-tile split and crosses split edges. The split plan is checked on the
CPU with a given SM count.
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
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TILE = tatt.DECODE_TILE
# (S, Hq, Hkv, hd, C, positions, window, JAX block_k)
CASES = {
    # 200 rows: four tiles, the last one ragged; a slot at position 0
    "ragged": (4, 8, 2, 16, 200, [199, 0, 64, 130], None, 40),
    # a window of 70: the 150-slot walks tiles 1-2, starting inside the
    # first 2-tile split and crossing into the second
    "window70": (4, 8, 2, 16, 256, [255, 150, 69, 0], 70, 32),
    "g1-c132": (2, 4, 4, 32, 132, [131, 63], None, 44),
}
SPLITS = ("1", "2", "all")
KV = ("float32", "bfloat16", "int8")


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _case(case: str, kv: str):
    """Inputs of ``case`` as numpy arrays (q and the cache rounded to bf16
    for a bf16 cache; int8 bytes and scales from the JAX quantizer for an
    int8 one) and the JAX Pallas kernel's output on them, as float32."""
    S, Hq, Hkv, hd, C, positions, window, bk = CASES[case]
    rng = np.random.default_rng(21)
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    if kv == "int8":
        kq, ks = jq.quantize_lastdim(jnp.asarray(k))
        vq, vs = jq.quantize_lastdim(jnp.asarray(v))
        arrays = [q, *(np.array(a) for a in (kq, vq)), pos,
                  *(np.array(a) for a in (ks, vs))]
        jargs = [jnp.asarray(a) for a in arrays]
    elif kv == "bfloat16":
        arrays = [_bf16(q), _bf16(k), _bf16(v), pos]
        jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]]
        jargs.append(jnp.asarray(pos))
    else:
        arrays = [q, k, v, pos]
        jargs = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jops.decode_attention(
        *jargs, sliding_window=window, block_k=bk, interpret=True)
        .astype(jnp.float32))
    return arrays, want


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_jax(case, kv, split):
    S, Hq, Hkv, hd, C, positions, window, bk = CASES[case]
    arrays, want = _case(case, kv)
    t = [torch.from_numpy(a) for a in arrays]
    if kv == "bfloat16":
        t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    ntiles = -(-C // TILE)
    tiles = ntiles if split == "all" else int(split)
    got = tatt.decode_attention_split_ref(
        *t, split_tiles=tiles, sliding_window=window)
    assert got.dtype == t[0].dtype and got.shape == (S, Hq, hd)
    if kv == "bfloat16":
        err = np.abs(got.float().numpy() - want).reshape(S, -1).max(1)
        tol = 1e-2 * np.abs(want).reshape(S, -1).max(1)
        assert (err <= tol).all(), (err, tol)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cases_reach_the_split_edges():
    """At one tile a split some slot has splits past its last live tile,
    a window starts inside a 2-tile split (lo odd) and walks more than
    one tile, a slot sits at position 0, and a context is ragged."""
    empty = window_inside = at_zero = ragged = 0
    for S, Hq, Hkv, hd, C, positions, window, bk in CASES.values():
        ntiles = -(-C // TILE)
        ragged += C % TILE != 0
        for p in positions:
            nb = min(p // TILE + 1, ntiles)
            empty += nb < ntiles
            at_zero += p == 0
            if window:
                lo = max((p - window + 1) // TILE, 0)
                window_inside += lo % 2 == 1 and nb - lo > 1
    assert empty and window_inside and at_zero and ragged


def test_one_split_is_the_plain_version():
    """One split is the unsplit walk: the model then equals the plain
    version up to rounding, on a bf16 q too (output in q's dtype)."""
    S, Hq, Hkv, hd, C, positions, window, _ = CASES["window70"]
    rng = np.random.default_rng(22)
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               for shp in ((S, Hq, hd), (S, Hkv, C, hd), (S, Hkv, C, hd))]
    pos = torch.tensor(positions, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        got = tatt.decode_attention_split_ref(
            q.to(dt), k.to(dt), v.to(dt), pos, split_tiles=-(-C // TILE),
            sliding_window=window)
        want = tatt.decode_attention_ref(q.to(dt), k.to(dt), v.to(dt), pos,
                                         sliding_window=window)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=1e-5 if dt == torch.float32 else 1e-2)


def test_split_model_zeroes_a_slot_without_live_tiles():
    """A position past the cache whose window ends before the cache's
    last tile leaves the slot no live tile (lo >= nb): every split is
    (-1e30, 0, 0) and the slot's output is 0, as the kernel writes it."""
    rng = np.random.default_rng(23)
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               for shp in ((2, 4, 16), (2, 2, 128, 16), (2, 2, 128, 16))]
    pos = torch.tensor([100, 300], dtype=torch.int32)
    for tiles in (1, 2):
        got = tatt.decode_attention_split_ref(q, k, v, pos, split_tiles=tiles,
                                              sliding_window=10)
        want = tatt.decode_attention_ref(q, k, v, pos, sliding_window=10)
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   atol=1e-5)
        assert not got[1].any()


def test_split_plan_reads_no_positions():
    """The plan takes shapes, the SM count and the cache kind only."""
    params = list(inspect.signature(tatt.decode_split_plan).parameters)
    assert params == ["S", "Hkv", "C", "sms", "pool"]


@pytest.mark.parametrize("S,Hkv,C,sms", [
    (8, 8, 4096, 132), (8, 8, 1000, 132), (4, 2, 520, 132), (1, 1, 1, 132),
    (1, 1, 64, 132), (1, 1, 65, 132), (64, 8, 4096, 132), (8, 8, 4096, 1),
    (3, 1, 200, 16)])
def test_split_plan_covers_the_tiles(S, Hkv, C, sms):
    """For each cache kind the splits cover the ceil(C / DECODE_TILE)
    tiles exactly; the plan is K1's over those tiles."""
    ntiles = -(-C // TILE)
    for pool in ("", "int8"):
        tps, splits = tatt.decode_split_plan(S, Hkv, C, sms, pool)
        assert 1 <= tps <= ntiles and splits >= 1
        assert (splits - 1) * tps < ntiles <= splits * tps
        assert (tps, splits) == tatt.paged_split_plan(S, Hkv, ntiles, sms,
                                                      pool)


def test_split_plan_at_the_serving_shape():
    """8 slots x 8 kv heads over a 4096-row cache on 132 SMs: 32 splits
    of 2 tiles for a bf16/f32 cache, 64 of 1 for int8 (2048 and 4096 CUDA
    blocks)."""
    assert tatt.decode_split_plan(8, 8, 4096, 132) == (2, 32)
    assert tatt.decode_split_plan(8, 8, 4096, 132, "int8") == (1, 64)


def test_split_plan_refuses_empty_shapes():
    for bad in ((0, 8, 4096, 132), (8, 8, 0, 132), (8, 8, 4096, 0),
                (8, 8, 4096, 132, "fp8")):
        with pytest.raises(ValueError):
            tatt.decode_split_plan(*bad)
