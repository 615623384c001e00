"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only torch; ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel output is compared with the plain version run in float32 on
the same inputs: float32 within 1e-4 (absolute for attention, relative to
the output's largest magnitude for the matmuls); bfloat16 per slot or row
within 1e-2 of that slot's or row's largest output (the output's bf16
rounding is at most 2**-8 of it), so a small row is held as tightly as a
large one. Inputs come from a numpy seed.
"""

import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu_torch import ops as tops  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _attn_inputs(seed):
    """S=8, Hq=32, Hkv=8, hd=128, bt=64 serving shape, ragged positions
    on block edges, shuffled tables; float32 on the card."""
    S, Hq, Hkv, hd, bt, MB = 8, 32, 8, 128, 64, 8
    rng = np.random.default_rng(seed)
    N = S * MB + 1
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    tables = (rng.permutation(N - 1) + 1).astype(np.int32).reshape(S, MB)
    pos = np.asarray([0, 63, 64, 100, 200, 300, 400, 511], np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, tables, pos)]


def _slot_check(got, want, dt):
    err = (got.float() - want).abs().flatten(1).amax(1)
    if dt == torch.float32:
        tol = torch.full_like(err, 1e-4)
    else:
        tol = 1e-2 * want.abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err.tolist(), tol.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    """K1 on a pool in the compute dtype."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, tables, pos = _attn_inputs(7)
    before = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(q.to(dt), k.to(dt), v.to(dt), tables,
                                      pos)
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    want = tops.paged_decode_attention_ref(
        q.to(dt).float(), k.to(dt).float(), v.to(dt).float(), tables, pos)
    _slot_check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_quantized_pools_match_plain(dtype, kv_dtype):
    """K1 on scaled int8 / int4 pools built by the port's quantizers."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, tables, pos = _attn_inputs(9)
    quantize = (tq.quantize_lastdim4 if kv_dtype == "int4"
                else tq.quantize_lastdim)
    kq, ks = quantize(k)
    vq, vs = quantize(v)
    before = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(q.to(dt), kq, vq, tables, pos, ks, vs)
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    want = tops.paged_decode_attention_ref(q.to(dt).float(), kq, vq, tables,
                                           pos, ks, vs)
    _slot_check(got, want, dt)


@functools.lru_cache(maxsize=1)
def _long_inputs(seed):
    """Long contexts at the serving shape: 64-entry tables of 64-token
    blocks, positions up to 4095 on block and split edges; float32 on the
    card."""
    S, Hq, Hkv, hd, bt, MB = 8, 32, 8, 128, 64, 64
    rng = np.random.default_rng(seed)
    N = S * MB + 1
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    tables = (rng.permutation(N - 1) + 1).astype(np.int32).reshape(S, MB)
    pos = np.asarray([4095, 4032, 3071, 2048, 2047, 1000, 255, 0], np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, tables, pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "1", "MB"])
@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("pool,dtype", [
    ("", "bfloat16"), ("", "float32"), ("int8", "bfloat16"),
    ("int8", "float32"), ("int4", "bfloat16"), ("int4", "float32")])
def test_cuda_kernel_long_context_splits_match_plain(pool, dtype, window,
                                                     split):
    """K1's split walk at MB=64 (contexts up to 4096) on every pool kind,
    with the plan's split, the finest (1 block) and a single walk (MB); a
    window of 700 starts inside a split and crosses split boundaries.
    One call counts one launch."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, tables, pos = _long_inputs(13)
    if pool:
        quantize = (tq.quantize_lastdim4 if pool == "int4"
                    else tq.quantize_lastdim)
        k, ks = quantize(k)
        v, vs = quantize(v)
        scales = (ks, vs)
        ref_kv = (k, v)
    else:
        k, v = k.to(dt), v.to(dt)
        scales = ()
        ref_kv = (k.float(), v.float())
    split_blocks = {"plan": None, "1": 1, "MB": tables.shape[1]}[split]
    before = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(q.to(dt), k, v, tables, pos, *scales,
                                      sliding_window=window,
                                      split_blocks=split_blocks)
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    want = tops.paged_decode_attention_ref(q.to(dt).float(), *ref_kv, tables,
                                           pos, *scales,
                                           sliding_window=window)
    _slot_check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("split_blocks", [None, 1, 2, 4])
def test_cuda_kernel_matches_the_split_model(split_blocks):
    """The kernel against the plain model of its split, on a slot whose
    window leaves it no live block (output 0, no tile loaded) beside a
    slot with a window inside its table."""
    _card()
    rng = np.random.default_rng(14)
    S, Hq, Hkv, hd, bt, MB = 2, 4, 2, 32, 8, 4
    N = S * MB + 1
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .cuda() for shp in ((S, Hq, hd), (N, Hkv, bt, hd),
                                   (N, Hkv, bt, hd))]
    tables = torch.from_numpy((rng.permutation(N - 1) + 1).astype(
        np.int32).reshape(S, MB)).cuda()
    pos = torch.tensor([20, 50], dtype=torch.int32, device="cuda")
    got = tops.paged_decode_attention(q, k, v, tables, pos,
                                      sliding_window=10,
                                      split_blocks=split_blocks)
    torch.cuda.synchronize()
    bps = split_blocks or tops.attention.paged_split_plan(
        S, Hkv, MB, torch.cuda.get_device_properties(0)
        .multi_processor_count)[0]
    want = tops.attention.paged_decode_attention_split_ref(
        q, k, v, tables, pos, split_blocks=bps, sliding_window=10)
    _slot_check(got, want, torch.float32)
    assert not got[1].any()


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_bad_split():
    """split_blocks outside [1, MB] raises; nothing falls back."""
    _card()
    q, k, v, tables, pos = _attn_inputs(7)
    for bad in (0, tables.shape[1] + 1):
        with pytest.raises(ValueError, match="split_blocks"):
            tops.paged_decode_attention(q, k, v, tables, pos,
                                        split_blocks=bad)


def _contiguous_inputs(seed, hd=128, Hq=32, Hkv=8, C=520):
    """S=8 slots over a contiguous cache of C rows (not a multiple of the
    kernel's 64-row tile), ragged positions on tile edges; float32."""
    S = 8
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    pos = np.asarray([0, 63, 64, 100, 200, 300, 511, C - 1], np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hd,window", [(128, None), (128, 150), (64, None)])
def test_cuda_decode_kernel_matches_plain(kv, hd, window):
    """K2 over the contiguous cache: float caches in the compute dtype,
    the int8 cache (built by the port's quantizer) with a bf16 q."""
    _card()
    q, k, v, pos = _contiguous_inputs(11, hd=hd, Hq=16 if hd == 64 else 32,
                                      Hkv=4 if hd == 64 else 8)
    if kv == "int8":
        dt = torch.bfloat16
        k, ks = tq.quantize_lastdim(k)
        v, vs = tq.quantize_lastdim(v)
        scales = (ks, vs)
        ref_kv = (k, v)
    else:
        dt = getattr(torch, kv)
        k, v = k.to(dt), v.to(dt)
        scales = ()
        ref_kv = (k.float(), v.float())
    before = tops.decode_attention.launches
    got = tops.decode_attention(q.to(dt), k, v, pos, *scales,
                                sliding_window=window)
    torch.cuda.synchronize()
    assert tops.decode_attention.launches == before + 1
    want = tops.decode_attention_ref(q.to(dt).float(), *ref_kv, pos, *scales,
                                     sliding_window=window)
    _slot_check(got, want, dt)


@functools.lru_cache(maxsize=1)
def _long_contiguous_inputs(seed):
    """K2 at the serving shape: S=8, Hq=32, Hkv=8, hd=128 over a 4096-row
    cache, positions up to 4095 on tile and split edges; float32 on the
    card."""
    S, Hq, Hkv, hd, C = 8, 32, 8, 128, 4096
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    pos = np.asarray([4095, 4032, 3071, 2048, 2047, 1000, 255, 0], np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "1", "all"])
@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("kv,dtype", [
    ("", "bfloat16"), ("", "float32"), ("int8", "bfloat16"),
    ("int8", "float32")])
def test_cuda_decode_kernel_long_context_splits_match_plain(kv, dtype,
                                                            window, split):
    """K2's split walk over a 4096-row cache on every cache kind, with the
    plan's split, the finest (1 tile) and a single walk (all 64 tiles); a
    window of 700 starts inside a split and crosses split edges. One call
    counts one launch."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, pos = _long_contiguous_inputs(15)
    if kv:
        k, ks = tq.quantize_lastdim(k)
        v, vs = tq.quantize_lastdim(v)
        scales = (ks, vs)
        ref_kv = (k, v)
    else:
        k, v = k.to(dt), v.to(dt)
        scales = ()
        ref_kv = (k.float(), v.float())
    tiles = {"plan": None, "1": 1,
             "all": -(-k.shape[2] // tops.attention.DECODE_TILE)}[split]
    before = tops.decode_attention.launches
    got = tops.decode_attention(q.to(dt), k, v, pos, *scales,
                                sliding_window=window, split_tiles=tiles)
    torch.cuda.synchronize()
    assert tops.decode_attention.launches == before + 1
    want = tops.decode_attention_ref(q.to(dt).float(), *ref_kv, pos, *scales,
                                     sliding_window=window)
    _slot_check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("split_tiles", [None, 1, 2])
def test_cuda_decode_kernel_matches_the_split_model(split_tiles):
    """K2 against the plain model of its split, on a ragged 200-row cache:
    a slot whose window leaves it no live tile (output 0, no tile loaded)
    beside slots at position 0 and with a window inside the row."""
    _card()
    rng = np.random.default_rng(16)
    S, Hq, Hkv, hd, C = 3, 8, 2, 32, 200
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .cuda() for shp in ((S, Hq, hd), (S, Hkv, C, hd),
                                   (S, Hkv, C, hd))]
    pos = torch.tensor([150, 400, 0], dtype=torch.int32, device="cuda")
    got = tops.decode_attention(q, k, v, pos, sliding_window=70,
                                split_tiles=split_tiles)
    torch.cuda.synchronize()
    tps = split_tiles or tops.attention.decode_split_plan(
        S, Hkv, C, torch.cuda.get_device_properties(0)
        .multi_processor_count)[0]
    want = tops.attention.decode_attention_split_ref(
        q, k, v, pos, split_tiles=tps, sliding_window=70)
    _slot_check(got, want, torch.float32)
    assert not got[1].any()


@pytest.mark.cuda
def test_cuda_decode_kernel_refuses_a_bad_split():
    """split_tiles outside [1, ceil(C / DECODE_TILE)] raises; nothing
    falls back."""
    _card()
    q, k, v, pos = _contiguous_inputs(17)
    for bad in (0, -(-k.shape[2] // tops.attention.DECODE_TILE) + 1):
        with pytest.raises(ValueError, match="split_tiles"):
            tops.decode_attention(q, k, v, pos, split_tiles=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,length,window,hd,Hq,Hkv", [
    (200, 200, None, 128, 32, 8), (200, 150, None, 128, 32, 8),
    (130, 130, 40, 128, 32, 8), (96, 90, None, 64, 16, 16),
    (70, 70, None, 32, 8, 1)])
def test_cuda_prefill_kernel_matches_plain(dtype, T, length, window, hd, Hq,
                                           Hkv):
    """K3 on every row (rows past ``length`` attend to the real keys up to
    their own position), with a window, hd 64/32 and GQA groups 1/4/8."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .cuda().to(dt)
               for shp in ((T, Hq, hd), (Hkv, T, hd), (Hkv, T, hd))]
    before = tops.prefill_attention.launches
    got = tops.prefill_attention(q, k, v, length, sliding_window=window)
    torch.cuda.synchronize()
    assert tops.prefill_attention.launches == before + 1
    want = tops.prefill_attention_ref(q.float(), k.float(), v.float(), length,
                                      sliding_window=window)
    _slot_check(got, want, dt)


def _prefill_check(T, length, window, hd, Hq, Hkv, rows, seed):
    """K3 bf16 with ``rows`` query rows a CUDA block against the plain
    version on every row; one call counts one launch."""
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for shp in ((T, Hq, hd), (Hkv, T, hd), (Hkv, T, hd))]
    before = tops.prefill_attention.launches
    got = tops.prefill_attention(q, k, v, length, sliding_window=window,
                                 block_rows=rows)
    torch.cuda.synchronize()
    assert tops.prefill_attention.launches == before + 1
    want = tops.prefill_attention_ref(q.float(), k.float(), v.float(), length,
                                      sliding_window=window)
    _slot_check(got, want, torch.bfloat16)


PREFILL_TS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 512, 2048, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 64, 128])
@pytest.mark.parametrize("T", PREFILL_TS)
def test_cuda_prefill_bf16_lengths_of_prompt(T, rows):
    """K3 bf16 at the serving widths (Hq=32, Hkv=8, hd=128) on every edge
    of its 64-key tiles and 16/32-position blocks, at the plan's rows and
    at both forced sizes."""
    _card()
    _prefill_check(T, T, None, 128, 32, 8, rows, 20 + T % 97)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("T,length,window", [
    (200, 150, None), (300, 1, None), (129, 65, None), (257, 200, 64),
    (520, 520, 70), (1000, 900, 129), (2048, 1500, 700), (4096, 3500, 1000)])
def test_cuda_prefill_bf16_lengths_and_windows(T, length, window, rows):
    """K3 bf16 with a real length below T (rows past it attend to the real
    keys up to their own position) and windows whose edges fall inside
    and across key tiles and blocks. Each window is wider than T - length,
    so every row keeps a key (a row that keeps none has no defined output:
    the plain version spreads it evenly over all T keys)."""
    _card()
    _prefill_check(T, length, window, 128, 32, 8, rows, T + length)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_cuda_prefill_bf16_groups_and_head_dims(G, hd, rows):
    """K3 bf16 at every compiled GQA group and head dim, with a length
    below T and a window across a tile edge."""
    _card()
    _prefill_check(300, 250, 90, hd, 4 * G, 4, rows, 3 * G + hd)


# GQA groups the kernels take beyond the powers of two: K1/K2 run them on
# the next compiled group capacity with the rows past the group masked, K3
# reads the group at run time (its left-over rows masked)
NEW_GROUPS = (3, 5, 6, 7, 11, 16)


def _group_pool(G, hd, seed, pool=""):
    """Two kv heads at group G over 8-entry tables of 64-token blocks
    (positions on block edges and a split's), in float32, or an int8/int4
    pool by the port's quantizers: (q, k, v, tables, pos, scales)."""
    S, Hkv, bt, MB = 4, 2, 64, 8
    rng = np.random.default_rng(seed)
    N = S * MB + 1
    q = rng.normal(size=(S, G * Hkv, hd)).astype(np.float32)
    k = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    v = rng.normal(size=(N, Hkv, bt, hd)).astype(np.float32)
    tables = (rng.permutation(N - 1) + 1).astype(np.int32).reshape(S, MB)
    pos = np.asarray([0, 64, 300, 511], np.int32)
    q, k, v, tables, pos = [torch.from_numpy(a).cuda()
                            for a in (q, k, v, tables, pos)]
    if not pool:
        return q, k, v, tables, pos, ()
    quantize = (tq.quantize_lastdim4 if pool == "int4"
                else tq.quantize_lastdim)
    k, ks = quantize(k)
    v, vs = quantize(v)
    return q, k, v, tables, pos, (ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("pool", ["", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", NEW_GROUPS)
def test_cuda_paged_kernel_at_new_groups(G, hd, dtype, pool, split):
    """K1 at GQA groups that are not compiled capacities, on float and
    scaled pools, at the split plan and the finest split."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, tables, pos, scales = _group_pool(G, hd, 40 + G + hd, pool)
    if not pool:
        k, v = k.to(dt), v.to(dt)
    q = q.to(dt)
    before = tops.paged_decode_attention.launches
    got = tops.paged_decode_attention(q, k, v, tables, pos, *scales,
                                      split_blocks=split)
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    want = tops.paged_decode_attention_ref(
        q.float(), k if pool else k.float(), v if pool else v.float(),
        tables, pos, *scales)
    _slot_check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", NEW_GROUPS)
def test_cuda_decode_kernel_at_new_groups(G, hd, kv):
    """K2 at GQA groups that are not compiled capacities: float caches in
    the compute dtype, an int8 cache with a bf16 q."""
    _card()
    q, k, v, pos = _contiguous_inputs(50 + G, hd=hd, Hq=2 * G, Hkv=2)
    scales = ()
    if kv == "int8":
        q = q.to(torch.bfloat16)
        k, ks = tq.quantize_lastdim(k)
        v, vs = tq.quantize_lastdim(v)
        scales = (ks, vs)
        dt = torch.bfloat16
    else:
        dt = getattr(torch, kv)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    before = tops.decode_attention.launches
    got = tops.decode_attention(q, k, v, pos, *scales)
    torch.cuda.synchronize()
    assert tops.decode_attention.launches == before + 1
    want = tops.decode_attention_ref(q.float(), k if scales else k.float(),
                                     v if scales else v.float(), pos,
                                     *scales)
    _slot_check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", NEW_GROUPS)
def test_cuda_prefill_bf16_at_new_groups(G, hd, rows):
    """K3 bf16 at GQA groups that leave rows of a block over, with T not
    a multiple of the block and a length below it (the left-over rows meet
    the length mask), and a window."""
    _card()
    _prefill_check(301, 250, None, hd, 2 * G, 2, rows, 5 * G + hd)
    _prefill_check(257, 257, 90, hd, 2 * G, 2, rows, 7 * G + hd)


@pytest.mark.cuda
@pytest.mark.parametrize("G", NEW_GROUPS)
def test_cuda_prefill_f32_at_new_groups(G):
    """K3 float32 (64-row blocks on the CUDA cores) at the same groups."""
    _card()
    rng = np.random.default_rng(60 + G)
    T, length, hd, Hkv = 201, 180, 128, 2
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               .cuda() for shp in ((T, G * Hkv, hd), (Hkv, T, hd),
                                   (Hkv, T, hd))]
    got = tops.prefill_attention(q, k, v, length)
    torch.cuda.synchronize()
    _slot_check(got, tops.prefill_attention_ref(q, k, v, length),
                torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("name,heads,kv_heads", [
    ("llama-3.2-3b", 24, 8), ("qwen2.5-7b", 28, 4), ("qwen2.5-14b", 40, 8)])
def test_cuda_runner_builds_at_published_groups(name, heads, kv_heads,
                                                paged):
    """A runner at Llama-3.2-3B's, Qwen2.5-7B's and Qwen2.5-14B's heads
    (hd 128, one layer, a small vocabulary, seeded bf16 weights) builds on
    the card, takes the kernels and decodes the CPU's greedy tokens."""
    _card()
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(vocab_size=512, hidden_size=heads * 128,
                      intermediate_size=512, num_layers=1, num_heads=heads,
                      num_kv_heads=kv_heads, max_position_embeddings=512,
                      attention_bias=name.startswith("qwen"),
                      dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(heads), "cpu")
    to = functools.partial(_tree_to, device="cuda")
    seqs = {}
    for dev, p in (("cuda", to(params)), ("cpu", params)):
        r = ModelRunner(cfg, p, num_slots=2, max_ctx=256, kv_dtype="float32",
                        kv_block_tokens=16, prefill_chunk=32, paged=paged,
                        device=dev)
        want = "kernel" if dev == "cuda" else "torch"
        assert (r.paged_attn_impl if paged else r.attn_impl) == want
        wrapper = (tops.paged_decode_attention if paged
                   else tops.decode_attention)
        before = wrapper.launches
        s = r.acquire_slot()
        out = [r.admit(s, list(b"grouped query heads"), temperature=0.0)]
        for _ in range(6):
            out.append(int(r.step()[s]))
        seqs[dev] = out
        assert wrapper.launches - before == (6 if dev == "cuda" else 0)
    assert seqs["cuda"] == seqs["cpu"]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_group_above_16_is_refused():
    """A group above 16 raises on the card, naming the group."""
    _card()
    q = torch.zeros((2, 17, 64), device="cuda")
    k = torch.zeros((1, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="GQA group 17"):
        tops.prefill_attention(q, k, k, 2)


@pytest.mark.cuda
def test_cuda_prefill_refuses_bad_block_rows():
    """block_rows outside PREFILL_ROWS raises; nothing falls back."""
    _card()
    q = torch.zeros((8, 4, 32), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((2, 8, 32), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="block_rows"):
        tops.prefill_attention(q, k, k, 8, block_rows=96)


def _mm_inputs(M, K, N, seed, transpose=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(N, K) if transpose else (K, N)) * 0.02).astype(
        np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()


def _row_check(got, want, dtype):
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * float(want.abs().max())
    else:
        tol = 1e-2 * want.abs().amax(1, keepdim=True)
        assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,transpose", [(8, 512, 384, False),
                                             (1, 256, 128, False),
                                             (256, 1024, 256, False),
                                             (13, 2304, 128, False),
                                             (8, 1024, 384, True),
                                             (3, 2048, 256, True)])
def test_cuda_w8_kernel_matches_plain(dtype, M, K, N, transpose):
    _card()
    dt = getattr(torch, dtype)
    x, w = _mm_inputs(M, K, N, 5, transpose=transpose)
    qt = tq.quantize_tensor(w, 1 if transpose else 0)
    xc = x.to(dt)
    before = tqm.w8_matmul.launches
    got = tqm.w8_matmul(xc, qt.q, qt.scale, transpose_w=transpose)
    torch.cuda.synchronize()
    assert tqm.w8_matmul.launches == before + 1
    _row_check(got, tqm.w8_matmul_ref(xc.float(), qt.q, qt.scale, transpose),
               dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,group", [(8, 512, 384, 128),
                                         (1, 256, 128, 128),
                                         (256, 1024, 256, 256),
                                         (5, 2304, 128, 384),
                                         (9, 2048, 128, 128)])
def test_cuda_w4_kernel_matches_plain(dtype, M, K, N, group):
    _card()
    dt = getattr(torch, dtype)
    x, w = _mm_inputs(M, K, N, 6)
    qt = tq.quantize_tensor4(w, 0, group=group)
    assert qt.group == group
    xc = x.to(dt)
    before = tqm.w4_matmul.launches
    got = tqm.w4_matmul(xc, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert tqm.w4_matmul.launches == before + 1
    _row_check(got, tqm.w4_matmul_ref(xc.float(), qt.q, qt.scale), dt)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_ineligible_shapes():
    """No fallback: a CUDA shape the kernel does not take raises."""
    _card()
    x, w = _mm_inputs(300, 256, 128, 7)
    qt = tq.quantize_tensor(w, 0)
    with pytest.raises(ValueError):
        tqm.w8_matmul(x, qt.q, qt.scale)
    q4 = tq.quantize_tensor4(w, 0)
    with pytest.raises(ValueError):
        tqm.w4_matmul(x, q4.q, q4.scale)
    q = torch.zeros((2, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tops.prefill_attention(q, torch.zeros((2, 2, 48), device="cuda"),
                               torch.zeros((2, 2, 48), device="cuda"), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        kq = torch.zeros((2, 2, 30, 48), dtype=torch.int8, device="cuda")
        sc = torch.ones((2, 2, 30), device="cuda")
        tops.decode_attention(q, kq, kq, torch.zeros(2, dtype=torch.int32,
                                                     device="cuda"), sc, sc)


# the bf16 tensor-core tile of K4/K5 (csrc/qmm_mma.cuh): every M edge of
# its n8 tiles (1, 8 | 16 | 17, 64, 256), both gated w4 group sizes, and
# f32 x (the CUDA-core kernels) at the same shapes
QMM_MS = (1, 8, 16, 17, 64, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", QMM_MS)
@pytest.mark.parametrize("kind,group", [("w8", 0), ("w4", 128),
                                        ("w4", 256)])
def test_cuda_qmm_tile_matches_plain(kind, group, M, dtype):
    _card()
    dt = getattr(torch, dtype)
    x, w = _mm_inputs(M, 1024, 384, 11 + M)
    xc = x.to(dt)
    if kind == "w8":
        qt = tq.quantize_tensor(w, 0)
        got = tqm.w8_matmul(xc, qt.q, qt.scale)
        want = tqm.w8_matmul_ref(xc.float(), qt.q, qt.scale)
    else:
        qt = tq.quantize_tensor4(w, 0, group=group)
        got = tqm.w4_matmul(xc, qt.q, qt.scale)
        want = tqm.w4_matmul_ref(xc.float(), qt.q, qt.scale)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (M, 384)
    _row_check(got, want, dt)


def _split_counts(groups):
    """Every split count group edges can cut ``groups`` groups into."""
    return [s for s in range(1, groups + 1)
            if -(-groups // -(-groups // s)) == s]


@pytest.mark.cuda
@pytest.mark.parametrize("M", (1, 8, 17, 256))
@pytest.mark.parametrize("kind,group", [("w8", 128), ("w8t", 128),
                                        ("w4", 128), ("w4", 256)])
def test_cuda_qmm_every_split_matches_the_split_model(kind, group, M):
    """K = 2048: every split count on group edges (w8t: the tied lm_head's
    [N, K] table), one launch count per call whatever the split, and two
    identical calls bit for bit equal (the partials fold in split order,
    no atomics)."""
    _card()
    tr = kind == "w8t"
    x, w = _mm_inputs(M, 2048, 256, 3 + M, transpose=tr)
    xb = x.to(torch.bfloat16)
    if kind == "w4":
        qt = tq.quantize_tensor4(w, 0, group=group)
        fn = tqm.w4_matmul
        model = tqm.w4_matmul_split_ref
    else:
        qt = tq.quantize_tensor(w, 1 if tr else 0)
        fn = functools.partial(tqm.w8_matmul, transpose_w=tr)
        model = functools.partial(tqm.w8_matmul_split_ref, transpose_w=tr)
    wrapper = tqm.w4_matmul if kind == "w4" else tqm.w8_matmul
    for s in _split_counts(2048 // group):
        before = wrapper.launches
        got = fn(xb, qt.q, qt.scale, k_splits=s)
        again = fn(xb, qt.q, qt.scale, k_splits=s)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert torch.equal(got, again), s
        _row_check(got, model(xb.float(), qt.q, qt.scale, s), torch.bfloat16)


@pytest.mark.cuda
def test_cuda_qmm_plan_runs_the_8b_shapes():
    """The card's own plan at Llama-3-8B's narrow and wide projections:
    the same output as a single split, bit for bit run to run."""
    _card()
    for K, N in ((4096, 1024), (4096, 4096)):
        x, w = _mm_inputs(8, K, N, 21)
        xb = x.to(torch.bfloat16)
        qt = tq.quantize_tensor4(w, 0)
        got = tqm.w4_matmul(xb, qt.q, qt.scale)
        assert torch.equal(got, tqm.w4_matmul(xb, qt.q, qt.scale))
        _row_check(got, tqm.w4_matmul_ref(xb.float(), qt.q, qt.scale),
                   torch.bfloat16)
        q8 = tq.quantize_tensor(w, 0)
        got = tqm.w8_matmul(xb, q8.q, q8.scale)
        assert torch.equal(got, tqm.w8_matmul(xb, q8.q, q8.scale))
        _row_check(got, tqm.w8_matmul_ref(xb.float(), q8.q, q8.scale),
                   torch.bfloat16)


@pytest.mark.cuda
def test_cuda_qmm_refuses_a_bad_split():
    _card()
    x, w = _mm_inputs(8, 1024, 128, 9)
    qt = tq.quantize_tensor4(w, 0)
    with pytest.raises(ValueError, match="splits"):
        tqm.w4_matmul(x.to(torch.bfloat16), qt.q, qt.scale, k_splits=5)
    q8 = tq.quantize_tensor(w, 0)
    with pytest.raises(ValueError, match="splits"):
        tqm.w8_matmul(x.to(torch.bfloat16), q8.q, q8.scale, k_splits=9)


# ---------------------------------------------------------------------------
# speculative verify windows: K4/K5 at M = slots x (gamma + 1), and the
# window on the card against the CPU
# ---------------------------------------------------------------------------

SHAPES_8B = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256))
VERIFY_M = sorted({S * (g + 1) for S in (1, 2, 3, 8) for g in (1, 4, 8)})


@functools.lru_cache(maxsize=None)
def _quantized_8b(kind, K, N):
    """A seeded [K, N] weight quantized on the card, kept across tests."""
    _, w = _mm_inputs(1, K, N, 40 + K % 97 + N % 89)
    return (tq.quantize_tensor(w, 0) if kind == "w8"
            else tq.quantize_tensor4(w, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["w8", "w4"])
@pytest.mark.parametrize("M", VERIFY_M)
def test_cuda_qmm_at_verify_rows_matches_plain(kind, M):
    """Every verify window's M (2..72, most no multiple of 8) on the 8B
    projections and lm_head, at the card's own split plan."""
    _card()
    fn = tqm.w8_matmul if kind == "w8" else tqm.w4_matmul
    ref = tqm.w8_matmul_ref if kind == "w8" else tqm.w4_matmul_ref
    for K, N in SHAPES_8B:
        qt = _quantized_8b(kind, K, N)
        x, _ = _mm_inputs(M, K, 128, M + K % 13)
        xb = x.to(torch.bfloat16)
        before = fn.launches
        got = fn(xb, qt.q, qt.scale)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _row_check(got, ref(xb.float(), qt.q, qt.scale), torch.bfloat16)


def _spec_runner(weights, dev):
    """A debug:small runner (f32 compute) made on the CPU from a seed and
    moved to ``dev``, its weights and pool int8/int4 or float32."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.registry import resolve_model

    model = resolve_model("debug:small", dtype="float32", device="cpu")
    params = (tq.quantize_params(model.params, weights, device="cpu")
              if weights else model.params)

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to(dev))

    return ModelRunner(model.cfg, to(params), num_slots=4, max_ctx=256,
                       kv_dtype=weights or "float32", kv_block_tokens=16,
                       prefill_chunk=32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["", "int8", "int4"])
def test_cuda_verify_windows_match_the_cpu(weights):
    """Three verify windows with scripted proposals (the greedy tokens
    for slot 0, so some are accepted; a constant for slot 1) over two
    admitted slots: the card emits the CPU's rows and ends at its
    frontiers, and the w8/w4 kernel runs 7L+1 times a window."""
    _card()
    prompts = [list(b"abcabcabcabcabcabc"), list(b"speculation target")]
    out = {}
    for dev in ("cuda", "cpu"):
        r = _spec_runner(weights, dev)
        firsts = [r.admit(r.acquire_slot(), p, temperature=0.0,
                          spec_tokens=5) for p in prompts]
        props = np.zeros((4, 4), np.int32)
        props[:, :] = 7
        props[0, :2] = firsts[0]
        rows = []
        fn = tqm.w8_matmul if weights == "int8" else tqm.w4_matmul
        before = fn.launches
        for _ in range(3):
            rows.append(np.asarray(r.verify_async(props)))
        if dev == "cuda" and weights:
            L = r.cfg.num_layers
            assert fn.launches - before == 3 * (7 * L + 1)
        out[dev] = (np.stack(rows), r.slot_positions(),
                    r.state.tokens.cpu().numpy())
        assert r.verify_windows == 3
        assert not r.allocator.check_invariants()
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a == b).all(), (a, b)


# step_frozen_n: K1 (paged) and K2 (contiguous) under the frozen dispatch
# of constrained decoding: bias rows of -1e30 over most of the vocab,
# slots inactive on steps 1+ with live tables and positions, and rows
# written twice. (layout, compute dtype, KV storage)
FROZEN_KINDS = [("paged", "bfloat16", "bfloat16"),
                ("paged", "float32", "float32"),
                ("paged", "float32", "int8"), ("paged", "float32", "int4"),
                ("contiguous", "bfloat16", "bfloat16"),
                ("contiguous", "float32", "float32"),
                ("contiguous", "float32", "int8")]
FROZEN_S = 8


def _frozen_runner(layout, dtype, kv, hd, dev):
    """Two layers, 4 q heads over 2 kv heads of ``hd``, weights made on the
    CPU from a seed and moved to ``dev``."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=512, hidden_size=4 * hd,
                      intermediate_size=256, num_layers=2, num_heads=4,
                      num_kv_heads=2, max_position_embeddings=512,
                      dtype=dtype)
    params = tl.init_params(cfg, torch.Generator().manual_seed(11), "cpu")

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to(dev))

    return ModelRunner(cfg, to(params), num_slots=FROZEN_S, max_ctx=256,
                       kv_dtype=kv, kv_block_tokens=16, prefill_chunk=32,
                       paged=layout == "paged", device=dev)


def _frozen_bias(slot, vocab, forced):
    """A bias row banning all but a band of ids (one id when ``forced``:
    bf16 near-ties may break apart between the card and the CPU, so bf16
    streams are forced and held by their K/V instead)."""
    row = np.full(vocab, -1e30, np.float32)
    lo = 40 + 20 * slot
    row[lo:lo + (1 if forced else 12)] = 0.0
    return row


def _frozen_cache(r):
    """Every slot's valid K/V rows [0, position) as float tensors on the
    CPU (scaled storage dequantized, int4 unpacked), and the largest scale
    (0 for float storage). Rows past a slot's frontier and the paged
    pool's trash block hold padding writes (several slots' padding rows
    land on one trash row, in no set order on the card): not compared."""
    out, qmax = [], 0.0
    for slot, pos in enumerate(r.state.positions.tolist()):
        rows = []
        for t in r.kv.stacked():
            if r.paged:
                g = t[:, r.block_tables[slot].long()].transpose(2, 3)
                g = g.reshape(t.shape[0], -1, *g.shape[3:])
            else:
                g = t[:, slot].transpose(1, 2)
            rows.append(g[:, :pos].cpu())
        if len(rows) == 4:
            k, v, ks, vs = rows
            if k.shape[-1] * 2 == r.cfg.hd:
                k, v = tq.unpack_int4_lastdim(k), tq.unpack_int4_lastdim(v)
            rows = [k.float() * ks[..., None], v.float() * vs[..., None]]
            qmax = max(qmax, float(ks.max()), float(vs.max()))
        out.extend(x.float() for x in rows)
    return out, qmax


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [1, FROZEN_S // 2, FROZEN_S - 1],
                         ids=["one", "half", "all-but-one"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout,dtype,kv", FROZEN_KINDS,
                         ids=["-".join(k) for k in FROZEN_KINDS])
def test_cuda_step_frozen_n_matches_the_cpu(layout, dtype, kv, hd, frozen):
    """Frozen dispatches (``frozen`` of 8 slots take part in the first step
    only, behind bias rows) and plain steps on the card emit the CPU's
    rows and leave the CPU's decode state; the K/V caches agree (float32:
    1e-4; bfloat16: 2e-2 of the cache's largest magnitude; scaled storage:
    one quantum more); K1 or K2 launches once per layer per decode
    step."""
    _card()
    forced = dtype == "bfloat16"
    kernel = (tops.paged_decode_attention if layout == "paged"
              else tops.decode_attention)
    freeze = np.zeros(FROZEN_S, bool)
    freeze[FROZEN_S - frozen:] = True
    out = {}
    for dev in ("cuda", "cpu"):
        r = _frozen_runner(layout, dtype, kv, hd, dev)
        V = r.cfg.vocab_size
        rows = [[r.admit(r.acquire_slot(), list(range(1, 10 + 7 * s)),
                         temperature=0.0,
                         bias_row=_frozen_bias(s, V, forced)
                         if freeze[s] or forced else None)
                 for s in range(FROZEN_S)]]
        before, steps0 = kernel.launches, r.decode_steps
        for i in range(4):
            rows.extend(r.step_frozen_n(freeze, 4).tolist())
            if i == 1:
                rows.append(r.step().tolist())
        if dev == "cuda":
            torch.cuda.synchronize()
            L = r.cfg.num_layers
            assert r.decode_steps - steps0 == 17
            assert kernel.launches - before == L * 17
            assert r.frozen_dispatches == 4
        st = r.state
        out[dev] = (np.asarray(rows), st.tokens.cpu().numpy(),
                    st.positions.cpu().numpy(), st.counts.cpu().numpy(),
                    _frozen_cache(r))
    for a, b in zip(out["cuda"][:4], out["cpu"][:4]):
        assert (a == b).all(), (a, b)
    (cache_c, qc), (cache_p, _) = out["cuda"][4], out["cpu"][4]
    for x, y in zip(cache_c, cache_p):
        scale = float(y.abs().max())
        tol = (2e-2 * scale if forced else 1e-4) + qc
        assert float((x - y).abs().max()) <= tol


TEMPLATED_YAML = """\
name: t
model: {model}
context_size: 512
engine:
  dtype: float32
  kv_dtype: {kv}
  max_slots: 4
  kv_block_tokens: 16
  prefill_chunk: 32
  kv_paged: {paged}
template:
  chat_message: |-
    <|start_header_id|>{{{{if eq .RoleName "assistant"}}}}assistant{{{{else if eq .RoleName "system"}}}}system{{{{else}}}}user{{{{end}}}}<|end_header_id|>

    {{{{.Content}}}}<|eot_id|>
  chat: "<|begin_of_text|>{{{{.Input}}}}\\n<|start_header_id|>assistant<|end_header_id|>\\n\\n"
"""
TEMPLATED_CHATS = [
    [{"role": "system", "content": "Be brief."},
     {"role": "user", "content": "The paged kernel walks each table"}],
    [{"role": "user", "content": "hi"},
     {"role": "assistant", "content": "hello"},
     {"role": "user", "content": "again"}],
]


def _templated_run(models, device):
    """(prompt ids, greedy ids, decode steps, layers) of the chats, served
    in turn through the chat endpoint from the models dir on ``device``."""
    from localai_tpu_torch.api import openai as oa
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager

    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device=device),
                           loader)
    try:
        sm = manager.get("t")
        handles = []
        submit = sm.scheduler.submit
        sm.scheduler.submit = lambda req: handles.append(submit(req)) or \
            handles[-1]
        steps0 = sm.runner.decode_steps
        for messages in TEMPLATED_CHATS:
            oa.chat(manager, {"model": "t", "messages": messages,
                              "max_tokens": 16, "temperature": 0})
        return ([list(h.request.prompt) for h in handles],
                [list(h.token_ids) for h in handles],
                sm.runner.decode_steps - steps0, sm.runner.cfg.num_layers)
    finally:
        manager.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kv", [("paged", "float32"),
                                       ("contiguous", "float32"),
                                       ("paged", "int8")])
def test_cuda_templated_chat_matches_the_cpu(tmp_path, layout, kv):
    """A chat_message + chat template from a YAML read by the port's own
    reader: on the card the prompt ids equal the CPU rendering's and the
    greedy tokens the CPU's; on a paged pool K1 launches once per layer
    per decode step."""
    _card()
    from localai_tpu_torch.models.loader import write_llama_checkpoint
    from localai_tpu_torch.models.registry import resolve_model

    # debug:small's weights drawn once on the CPU, so both devices load
    # the same ones
    small = resolve_model("debug:small", dtype="float32", device="cpu")
    ckpt = write_llama_checkpoint(tmp_path / "ckpt", small.cfg, small.params)
    (tmp_path / "t.yaml").write_text(TEMPLATED_YAML.format(
        model=ckpt, kv=kv, paged="true" if layout == "paged" else "false"))
    k1 = tops.paged_decode_attention
    before = k1.launches
    card = _templated_run(tmp_path, "cuda")
    launched = k1.launches - before
    cpu = _templated_run(tmp_path, "cpu")
    assert card[0] == cpu[0]
    assert card[1] == cpu[1]
    steps, layers = card[2], card[3]
    assert steps > 0
    assert launched == (layers * steps if layout == "paged" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("env,want", [
    ({"LOCALAI_KV_DTYPE": "int8"}, (True, torch.int8)),
    ({"LOCALAI_KV_PAGED": "0"}, (False, torch.bfloat16)),
    ({"LOCALAI_KV_PAGED": "0", "LOCALAI_KV_DTYPE": "int8"},
     (False, torch.int8))], ids=["int8", "contiguous", "contiguous-int8"])
def test_cuda_kv_environment_sets_the_pool(monkeypatch, env, want):
    """``LOCALAI_KV_PAGED``/``LOCALAI_KV_DTYPE`` reach the runner on the
    card: the layout and the dtype of the KV storage."""
    _card()
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.models.manager import build_runner

    for k in ("LOCALAI_KV_PAGED", "LOCALAI_KV_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, runner = build_runner(ModelConfig.from_dict(
        {"name": "kv", "model": "debug:small", "context_size": 256,
         "engine": {"max_slots": 2, "dtype": "bfloat16", "spec": False}}),
        AppConfig(device="cuda"))
    kv = runner.kv
    assert (runner.paged, kv.k.dtype, kv.v.dtype) == (want[0], want[1],
                                                      want[1])
    assert kv.k.is_cuda and kv.v.is_cuda
    assert type(kv).__name__ == ("PagedKVCache" if want[0] else "KVCache")


@pytest.mark.cuda
def test_cuda_checkpoint_with_tokenizer_json_serves(tmp_path, monkeypatch):
    """A checkpoint directory with the smoke's tokenizer.json served on the
    card through ``build_server`` with API keys from the environment:
    401 without a key, the golden prompt ids, K1 once per layer per
    decode step."""
    _card()
    import json
    import sys
    import urllib.error
    import urllib.request
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from localai_tpu_torch.cli.main import build_server

    cfg, params = chip_smoke._small_128k()
    chip_smoke.write_checkpoint_dir(tmp_path / "ckpt", cfg, params,
                                    "float32",
                                    chip_smoke._small_hf_config(cfg))
    models = tmp_path / "models"
    models.mkdir()
    (models / "ck.yaml").write_text(
        f"model: {tmp_path / 'ckpt'}\nengine: {{dtype: float32, "
        "kv_dtype: float32, max_slots: 2}\ncontext_size: 512\n")
    for k, v in {"LOCALAI_MODELS_PATH": str(models),
                 "LOCALAI_API_KEYS": "a,b", "LOCALAI_ADDRESS": "127.0.0.1",
                 "LOCALAI_PORT": "0",
                 "LOCALAI_CONFIG_PATH": str(tmp_path / "conf")}.items():
        monkeypatch.setenv(k, v)
    server = build_server(["run"]).start()
    try:
        sm = server.manager.get("ck")
        prompts = []
        submit = sm.scheduler.submit
        sm.scheduler.submit = lambda r: prompts.append(
            list(r.prompt)) or submit(r)
        body = dict(chip_smoke.CHECKPOINT_CHATS[3], model="ck",
                    max_tokens=8)
        url = server.url + "/v1/chat/completions"
        with pytest.raises(urllib.error.HTTPError) as e:
            chip_smoke._post(url, body)
        assert e.value.code == 401
        k1 = tops.paged_decode_attention
        before, steps0 = k1.launches, sm.runner.decode_steps
        out = json.loads(chip_smoke._post(url, body, key="b").read())
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        assert prompts == [chip_smoke.CHECKPOINT_GOLDEN[3][1]]
        steps = sm.runner.decode_steps - steps0
        assert steps > 0
        assert k1.launches - before == cfg.num_layers * steps
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# K4's expert grid (sparse-MoE projections, one launch over all experts)


def _expert_inputs(M, E, K, N, shared, seed):
    """x [M, K] (shared rows) or [M, E, K], and a [E, K, N] stack
    quantized per channel over K on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K) if shared else (M, E, K)).astype(np.float32)
    w = (rng.normal(size=(E, K, N)) * 0.02).astype(np.float32)
    qt = tq.quantize_tensor(torch.from_numpy(w).cuda(), 1)
    return torch.from_numpy(x).cuda(), qt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [8, 40, 1, 300])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_cuda_w8_experts_matches_plain(kind, M, dtype):
    """One launch computes every expert's product, held per expert and
    row against ``w8_matmul_experts_ref``: moe_up reads the same rows
    for every expert, moe_down each expert's own."""
    _card()
    dt = getattr(torch, dtype)
    E, D, F = 4, 256, 640
    K, N = (D, F) if kind == "up" else (F, D)
    x, qt = _expert_inputs(M, E, K, N, kind == "up", M + len(kind))
    xc = x.to(dt)
    counted = (tqm.w8_matmul_experts.up if kind == "up"
               else tqm.w8_matmul_experts.down)
    before = tqm.w8_matmul_experts.launches, counted.launches
    got = tqm.w8_matmul_experts(xc, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert (tqm.w8_matmul_experts.launches, counted.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (M, E, N) and got.dtype == dt
    want = tqm.w8_matmul_experts_ref(xc.float(), qt.q, qt.scale)
    for e in range(E):
        _row_check(got[:, e], want[:, e], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_cuda_w8_experts_every_split_matches_plain(kind, M):
    """The bf16 tile at every split count K allows (the scratch holds E x
    splits partials), and the card's own plan."""
    _card()
    E, D, F = 4, 512, 1024
    K, N = (D, F) if kind == "up" else (F, D)
    x, qt = _expert_inputs(M, E, K, N, kind == "up", 3 * M)
    xb = x.to(torch.bfloat16)
    want = tqm.w8_matmul_experts_ref(xb.float(), qt.q, qt.scale)
    for splits in [None] + _split_counts(K // 128):
        got = tqm.w8_matmul_experts(xb, qt.q, qt.scale, k_splits=splits)
        torch.cuda.synchronize()
        for e in range(E):
            _row_check(got[:, e], want[:, e], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["up", "down"])
def test_cuda_w8_experts_at_mixtral_widths(kind):
    """Mixtral-8x7B's expert projections (8 experts, D 4096, F 14336) at
    a decode step's M = 8, in bf16."""
    _card()
    E, D, F = 8, 4096, 14336
    K, N = (D, F) if kind == "up" else (F, D)
    x, qt = _expert_inputs(8, E, K, N, kind == "up", 11)
    xb = x.to(torch.bfloat16)
    got = tqm.w8_matmul_experts(xb, qt.q, qt.scale)
    torch.cuda.synchronize()
    want = tqm.w8_matmul_experts_ref(xb.float(), qt.q, qt.scale)
    for e in range(E):
        _row_check(got[:, e], want[:, e], torch.bfloat16)


@pytest.mark.cuda
def test_cuda_w8_experts_refuses_what_it_does_not_take():
    _card()
    x, qt = _expert_inputs(8, 4, 256, 256, True, 1)
    with pytest.raises(ValueError):
        tqm.w8_matmul_experts(x[:, :128], qt.q, qt.scale)
    with pytest.raises(ValueError):       # an expert axis of another size
        tqm.w8_matmul_experts(x[:, None].expand(8, 3, 256).contiguous(),
                              qt.q, qt.scale)
    with pytest.raises(ValueError):
        tqm.w8_matmul_experts(x.half(), qt.q, qt.scale)


def _moe_runner(paged, dev, weights="int8"):
    """debug:small's widths with 4 experts (top 2), f32 compute, int8 or
    int4 weights (the experts per-channel int8 in both), made on the CPU
    from a seed and moved to ``dev``."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["small"], dtype="float32",
                              num_experts=4, num_experts_per_tok=2)
    params = tq.quantize_params(
        tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        weights, device="cpu")

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to(dev))

    kw = dict(kv_block_tokens=16, prefill_chunk=32) if paged else {}
    return ModelRunner(cfg, to(params), num_slots=4, max_ctx=256,
                       kv_dtype="float32", paged=paged, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["int8", "int4"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged",
                                                      "contiguous"])
def test_cuda_moe_runner_matches_the_cpu(paged, weights):
    """Greedy tokens of a MoE runner on the card equal the CPU's; each
    decode step launches the expert kernel 3 times a layer (gate, up,
    down over all experts, int8 in both modes) and the dense K4 (int8)
    or K5 (int4) 4 times a layer plus the lm_head."""
    _card()
    prompts = [list(b"mixture of experts"), list(b"abcabcabcabcabc")]
    dense = tqm.w8_matmul if weights == "int8" else tqm.w4_matmul
    out = {}
    for dev in ("cuda", "cpu"):
        r = _moe_runner(paged, dev, weights)
        slots = [r.acquire_slot() for _ in prompts]
        toks = [[r.admit(s, p, temperature=0.0)]
                for s, p in zip(slots, prompts)]
        ex, mm = tqm.w8_matmul_experts.launches, dense.launches
        up, down = (tqm.w8_matmul_experts.up.launches,
                    tqm.w8_matmul_experts.down.launches)
        for _ in range(6):
            row = r.step()
            for t, s in zip(toks, slots):
                t.append(int(row[s]))
        if dev == "cuda":
            L = r.cfg.num_layers
            assert tqm.w8_matmul_experts.launches - ex == 6 * 3 * L
            assert tqm.w8_matmul_experts.up.launches - up == 6 * 2 * L
            assert tqm.w8_matmul_experts.down.launches - down == 6 * L
            assert dense.launches - mm == 6 * (4 * L + 1)
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 17, 40, 256])
@pytest.mark.parametrize("K,N,transpose", [(4096, 1024, False),
                                           (14336, 4096, False),
                                           (2048, 8192, True),
                                           (4096, 32001, False),
                                           (4096, 32001, True),
                                           (4100, 1000, False)])
def test_cuda_int8_product_is_exact(M, K, N, transpose):
    """The w8a8 product (torch._int_mm, rows padded past its 16-row
    floor, K and N padded to multiples of 8: a 32001-id vocabulary in
    the lm_head and a tied table) on a weight in its served column-major
    storage equals the exact float64 product, bit for bit."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(M * 7 + K)
    w = torch.randn((N, K) if transpose else (K, N), generator=g,
                    device="cuda")
    qt = tq.quantize_tensor(w, 1 if transpose else 0, "w8a8")
    xq = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                       dtype=torch.int8)
    got = tq.int8_matmul(xq, qt.q, transpose)
    assert got.shape == (M, N) and got.dtype == torch.int32
    assert torch.equal(got, tq.int8_matmul_ref(xq, qt.q, transpose))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_cuda_selfextend_runner_matches_the_cpu(kv):
    """Self-extend (ga_n 4, ga_w 32) past a trained context cut to 64 on
    the contiguous layout: the card's greedy tokens equal the CPU's, and
    neither K2 nor K3 launches (they take roped K only)."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.registry import resolve_model

    _card()
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    cfg = dataclasses.replace(model.cfg, max_position_embeddings=64)
    prompt = [(i * 7 + 3) % 256 for i in range(150)]
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in model.params.items()}
        r = ModelRunner(cfg, params, num_slots=2, max_ctx=256,
                        prefill_buckets=[64, 256], kv_dtype=kv, paged=False,
                        ga_n=4, ga_w=32, device=dev)
        before = (tops.decode_attention.launches,
                  tops.prefill_attention.launches)
        s = r.acquire_slot()
        toks = [r.admit(s, prompt, temperature=0.0)]
        toks += [int(r.step()[s]) for _ in range(8)]
        assert (tops.decode_attention.launches,
                tops.prefill_attention.launches) == before
        out[dev] = toks
    assert out["cuda"] == out["cpu"]


# -- speech and sound: no kernel of the port on these paths; card = CPU ------


def _speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(120 + 30 * np.sin(
        2 * np.pi * 0.7 * t)) / 16000)
    return (x + 0.02 * rng.normal(size=t.size)).astype(np.float32)


@pytest.mark.cuda
def test_cuda_whisper_matches_the_cpu():
    """A float32 whisper with large-v3's mel bins and vocabulary: encoder
    states within 1e-4 of their largest value, greedy ids equal per
    chunk, TF32 off inside the model and restored after."""
    _card()
    from localai_tpu_torch.audio import mel as tmel
    from localai_tpu_torch.models import whisper as twh

    cfg = twh.WhisperConfig(n_mels=128, d_model=256, n_heads=4,
                            n_enc_layers=3, n_dec_layers=3, d_ff=1024,
                            vocab_size=51866, max_target_positions=64)
    params = twh.init_params(cfg, seed=3, device="cpu")
    cpu = twh.WhisperModel(cfg, params, device="cpu")
    card = twh.WhisperModel(cfg, {k: ({kk: vv.cuda() for kk, vv in v.items()}
                                      if isinstance(v, dict) else v.cuda())
                                  for k, v in params.items()},
                            device="cuda")
    before = torch.backends.cudnn.allow_tf32
    for chunk in tmel.chunk_audio(_speech_like(40.0)):
        a, b = card.encode_chunk(chunk).cpu(), cpu.encode_chunk(chunk)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
        assert card.transcribe_chunk(chunk) == cpu.transcribe_chunk(chunk)
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.cuda
@pytest.mark.parametrize("speakers", [1, 4])
def test_cuda_vits_matches_the_cpu(speakers):
    """mms-tts-eng's widths (the VitsConfig defaults), seeded weights:
    the waveform within 1e-4 at zero and at the default noise (drawn from
    the same CPU generator), single- and multi-speaker."""
    _card()
    from localai_tpu_torch.audio import vits as tv

    cfg = tv.VitsConfig(num_speakers=speakers,
                        speaker_embedding_size=256 if speakers > 1 else 0)
    state = tv.init_params(cfg, seed=5)
    ids = np.asarray([[0, 5, 0, 9, 0, 3, 0, 17, 0, 2, 0]], np.int64)
    emb = (np.random.default_rng(0).normal(size=256).astype(np.float32)
           if speakers > 1 else None)
    out = []
    for dev in ("cuda", "cpu"):
        voice = tv.VitsTTS(cfg, tv._P(state, dev), None)
        out.append([voice._forward(
            ids, np.ones(ids.shape, np.float32), noise_scale=n,
            noise_scale_duration=n, speaking_rate=1.0, speaker_id=None,
            seed=7, speaker_embedding=emb) for n in (0.0, 0.667)])
    for a, b in zip(*out):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_musicgen_matches_the_cpu():
    """The serving preset: greedy codes equal, EnCodec audio within
    1e-4."""
    _card()
    from localai_tpu_torch.audio.musicgen import MusicGenerator

    card, cpu = MusicGenerator(device="cuda"), MusicGenerator(device="cpu")
    a = card.generate_codes("rain", 1.0, temperature=0.0)
    b = cpu.generate_codes("rain", 1.0, temperature=0.0)
    assert torch.equal(a.cpu(), b)
    assert float(np.abs(card.decode(a) - cpu.decode(b)).max()) <= 1e-4


def _image_layout(name):
    import chip_smoke

    return chip_smoke._image_layouts()[name]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sd1", "sdxl"])
def test_cuda_image_models_match_the_cpu(layout):
    """Debug-width float32 UNet (its eps), VAE (decode, encode) and CLIP
    (states; SDXL's pooled output) on the card against the CPU, within
    1e-4 of the largest output, TF32 off inside ``full_f32``."""
    _card()
    import chip_smoke
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import unet as tunet
    from localai_tpu_torch.image import vae as tvae
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.utils.device import full_f32

    cfgs = _image_layout(layout)
    rng = np.random.default_rng(3)
    trees = {"unet": tunet.init_params(cfgs["unet"], 1, "cpu"),
             "vae": tvae.init_params(cfgs["vae"], 2, "cpu"),
             "text": tclip.init_params(cfgs["text2"] if layout == "sdxl"
                                       else cfgs["text"], 3, "cpu")}
    trees = {k: chip_smoke._perturbed(v, i) for i, (k, v) in
             enumerate(trees.items())}
    lat = torch.from_numpy(rng.normal(size=(2, 4, 16, 16)).astype(
        np.float32))
    ts = torch.tensor([999.0, 3.5])
    ctx = torch.from_numpy(rng.normal(
        size=(2, 5, cfgs["unet"].context_dim)).astype(np.float32))
    kw = {}
    if layout == "sdxl":
        kw = {"pooled_text": torch.randn(2, 24),
              "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2)}
    ids = torch.from_numpy(rng.integers(1, 299, (2, 12)))
    img = torch.rand(1, 3, 32, 32) * 2 - 1
    out = {}
    with torch.inference_mode(), full_f32():
        for dev in ("cuda", "cpu"):
            p = {k: map_tree(v, lambda t, d=dev: t.to(d))
                 for k, v in trees.items()}
            tcfg = cfgs["text2"] if layout == "sdxl" else cfgs["text"]
            out[dev] = [
                tunet.forward(cfgs["unet"], p["unet"], lat.to(dev),
                              ts.to(dev), ctx.to(dev),
                              **{k: v.to(dev) for k, v in kw.items()}),
                tvae.decode(cfgs["vae"], p["vae"], lat[:1].to(dev)),
                tvae.encode(cfgs["vae"], p["vae"], img.to(dev)),
                *(tclip.encode_sdxl(tcfg, p["text"], ids.to(dev))
                  if layout == "sdxl"
                  else [tclip.forward(tcfg, p["text"], ids.to(dev))])]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert chip_smoke._rel_err(a, b) <= 1e-4


@pytest.mark.cuda
def test_cuda_image_generate_matches_the_cpu():
    """The smoke's image parity phase: 4-step euler_a and dpmpp_2m
    generations on both layouts (a ControlNet on one), card = CPU:
    latents within 1e-4, pixels within 1; no kernel launched."""
    _card()
    import chip_smoke

    kernels = chip_smoke._all_kernels()
    before = {k: w.launches for k, w in kernels.items()}
    out = chip_smoke.phase_image_parity()
    assert set(out) == {"sd1", "sdxl"}
    assert {k: w.launches for k, w in kernels.items()} == before


@pytest.mark.cuda
def test_cuda_flux_matches_the_cpu():
    """The smoke's FLUX parity phase: ``debug:flux-tiny``'s widths in
    float32 (T5 with and without a mask, the MMDiT's velocity, a 3-step
    generate and a 0.5-strength img2img from one seeded CPU draw) card =
    CPU within 1e-4, pixels within 1; no kernel launched."""
    _card()
    import chip_smoke

    kernels = chip_smoke._all_kernels()
    before = {k: w.launches for k, w in kernels.items()}
    errs = chip_smoke.phase_flux_parity()
    assert max(v for k, v in errs.items() if not k.startswith("pixels")) \
        <= 1e-4
    assert {k: w.launches for k, w in kernels.items()} == before


@pytest.mark.cuda
def test_cuda_flux_tiny_preset_matches_the_cpu():
    """``debug:flux-tiny`` as the router builds it, its weights drawn on
    the CPU, the VAE and CLIP widened to float32, then copied to the card:
    a 2-step generation and a 0.5-strength img2img, latents within 1e-4
    of the CPU's, pixels within 1."""
    _card()
    import dataclasses

    import chip_smoke
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.image.pipeline import resolve_image_model

    pipes = {}
    for dev in ("cpu", "cuda"):
        p = resolve_image_model("debug:flux-tiny", device="cpu")
        p.vae_cfg = dataclasses.replace(p.vae_cfg, dtype="float32")
        p.clip_cfg = dataclasses.replace(p.clip_cfg, dtype="float32")
        p.device = torch.device(dev)
        for name in ("params", "vae_params", "clip_params", "t5_params"):
            setattr(p, name, map_tree(getattr(p, name),
                                      lambda t, d=dev: t.float().to(d)))
        pipes[dev] = p
    init = np.random.default_rng(4).integers(0, 256, (64, 64, 3), np.uint8)
    for kw in ({}, {"init_image": init, "strength": 0.5}):
        a = pipes["cuda"].generate("a fox", width=64, height=64, seed=2,
                                   **kw)
        b = pipes["cpu"].generate("a fox", width=64, height=64, seed=2,
                                  **kw)
        assert chip_smoke._rel_err(a.latents, b.latents) <= 1e-4
        assert np.abs(a.image.astype(int) - b.image.astype(int)).max() <= 1


# -- the engine observatory on the card (obs.device, /backend/trace) ----------


def _small_runner(paged=True):
    """debug:small in float32 (head dim 32, one the kernels take) on the
    card, weights from a CPU seed."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["small"], dtype="float32")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to("cuda"))

    kw = dict(kv_block_tokens=16, prefill_chunk=32) if paged else {}
    return ModelRunner(cfg, to(params), num_slots=4, max_ctx=256,
                       kv_dtype="float32", paged=paged, device="cuda", **kw)


@pytest.mark.cuda
def test_cuda_probe_and_device_memory():
    """The probe's add and synchronize answer on the card; the memory
    entry is the caching allocator's reading."""
    _card()
    from localai_tpu_torch.obs import device as tdev
    from localai_tpu_torch.obs.metrics import Registry

    reg = Registry()
    res = tdev.probe_device(timeout=30.0, registry=reg)
    assert res.ok and res.device == torch.cuda.get_device_name(0)
    assert "localai_device_ok 1" in reg.render()
    torch.cuda.synchronize()
    mem = tdev.device_memory(reg)[0]
    assert mem["platform"] == "gpu"
    assert mem["memory"]["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert mem["memory"]["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    rl = tdev.roofline()
    assert rl["source"] in ("table", "assumed")
    assert "tpu" not in rl["device_kind"]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged",
                                                      "contiguous"])
def test_cuda_census_against_memory_allocated(paged):
    """The census's KV is the pool's bytes, its weights the parameters'
    bytes, and its total the allocator's ``memory_allocated()``."""
    _card()
    from localai_tpu_torch.obs import device as tdev

    r = _small_runner(paged)
    torch.cuda.synchronize()
    census = tdev.hbm_census(tdev.known_arrays([r]))
    kv = sum(t.numel() * t.element_size() for t in (r.kv.k, r.kv.v))
    weights = sum(t.numel() * t.element_size()
                  for t in tdev._param_tensors(r.params))
    cats = census["by_category"]
    assert cats["kv_cache"] == kv and cats["weights"] == weights
    assert census["total_bytes"] == sum(
        torch.cuda.memory_allocated(i)
        for i in range(torch.cuda.device_count()))
    del r


@pytest.mark.cuda
def test_cuda_backend_trace_holds_a_k1_launch(tmp_path):
    """``POST /backend/trace`` on a paged server on the card while chats
    stream: the Chrome trace's CUDA kernel events include K1, launched by
    the engine thread while the capture ran on an HTTP thread."""
    _card()
    import json
    import threading
    import urllib.request

    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager

    models = tmp_path / "models"
    models.mkdir()
    (models / "obs-small.yaml").write_text(json.dumps({
        "name": "obs-small", "model": "debug:small", "context_size": 256,
        "engine": {"max_slots": 4, "kv_block_tokens": 16, "spec": False,
                   "dtype": "float32", "kv_dtype": "float32"}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    srv = APIServer(ModelManager(AppConfig(
        model_path=str(models), device="cuda",
        backend_assets_path=str(tmp_path / "assets")), loader),
        "127.0.0.1", 0).start()

    def post(path, body):
        req = urllib.request.Request(
            srv.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    chat = {"model": "obs-small", "max_tokens": 64, "temperature": 0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "hello"}]}
    stop = threading.Event()
    try:
        post("/v1/chat/completions", chat)   # load + first shapes

        def chats():
            while not stop.is_set():
                post("/v1/chat/completions", chat)

        t = threading.Thread(target=chats)
        t.start()
        try:
            out = post("/backend/trace", {"seconds": 2.0})
        finally:
            stop.set()
            t.join()
        with open(out["trace_dir"] + "/trace.json") as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert any("paged_decode_kernel" in n for n in kernels), \
            sorted(set(kernels))[:30]
    finally:
        srv.shutdown()


# -- self-healing on the card (faults, Scheduler.rebuild) ---------------------


def _small_on(dev):
    """debug:small in float32 on ``dev`` (paged, 4 slots), weights from a
    CPU seed, so the card and the CPU serve the same model."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["small"], dtype="float32")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to(dev))

    return ModelRunner(cfg, to(params), num_slots=4, max_ctx=256,
                       kv_dtype="float32", kv_block_tokens=16,
                       prefill_chunk=32, device=dev)


def _greedy(text, n, **kw):
    from localai_tpu_torch.engine.scheduler import GenRequest

    return GenRequest(prompt=list(text.encode()), max_new_tokens=n,
                      temperature=0.0, **kw)


@pytest.mark.cuda
def test_cuda_nan_quarantine_keeps_cobatched_streams():
    """``decode.nan`` poisons one slot's bias row on the card: that request
    fails, its slot is quarantined, and the co-batched greedy stream
    equals the same stream without the fault and the CPU's; K1 launches
    through it all."""
    _card()
    from localai_tpu_torch import faults
    from localai_tpu_torch.engine.scheduler import Scheduler
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    out = {}
    try:
        for dev in ("cuda", "cpu"):
            sched = Scheduler(_small_on(dev), ByteTokenizer())
            try:
                ref = sched.generate(_greedy("co-batched survivor", 24),
                                     timeout=300)
                faults.arm(faults.FaultSpec(site="decode.nan", mode="nan",
                                            match="poison-me", times=1))
                k1 = tops.paged_decode_attention.launches
                bad = sched.submit(_greedy("poison target", 200,
                                           ignore_eos=True,
                                           correlation_id="poison-me"))
                good = sched.submit(_greedy("co-batched survivor", 24))
                bad.result(300)
                good.result(300)
                m = sched.metrics()
                out[dev] = (ref.token_ids, good.token_ids)
                assert bad.finish_reason == "error"
                assert good.token_ids == ref.token_ids
                assert m["nan_rows"] == 1 and m["quarantined_slots"] == 1
                if dev == "cuda":
                    assert tops.paged_decode_attention.launches > k1
            finally:
                faults.clear()
                sched.shutdown()
    finally:
        faults.clear()
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_cuda_rebuild_serves_again():
    """An ``engine.drain`` hang past the watchdog's deadline rebuilds the
    engine on the card: the wedged request ends in an error, the rebuilt
    pool lies on new storage, and the next greedy request equals the
    CPU's."""
    _card()
    from localai_tpu_torch import faults
    from localai_tpu_torch.engine.scheduler import Scheduler
    from localai_tpu_torch.faults import EngineSupervisor
    from localai_tpu_torch.obs.metrics import Registry
    from localai_tpu_torch.obs.trace import TraceStore
    from localai_tpu_torch.obs.watchdog import Watchdog
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    cpu = Scheduler(_small_on("cpu"), ByteTokenizer())
    try:
        want = cpu.generate(_greedy("after rebuild", 16), timeout=300)
    finally:
        cpu.shutdown()
    reg = Registry()
    wd = Watchdog(deadline=0.4, registry=reg, store=TraceStore(),
                  poll_interval=0.1)
    runner = _small_on("cuda")
    sched = Scheduler(runner, ByteTokenizer(), watchdog=wd)
    EngineSupervisor(sched, registry=reg, backoff_s=0.05,
                     probe_timeout_s=120.0)
    try:
        old_k = runner.kv.k
        wedged = sched.submit(_greedy("about to wedge", 200,
                                      ignore_eos=True))
        deadline = time.monotonic() + 120
        while wedged.t_first_token is None and time.monotonic() < deadline:
            time.sleep(0.01)
        faults.arm(faults.FaultSpec(site="engine.drain", mode="hang",
                                    delay_s=2.0, times=1))
        wedged.result(120)
        assert wedged.finish_reason == "error"
        deadline = time.monotonic() + 120
        while sched.rebuilds == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sched.rebuilds == 1 and not sched.failed
        assert runner.kv.k is not old_k
        assert runner.kv.k.data_ptr() != old_k.data_ptr()
        faults.clear()
        got = sched.generate(_greedy("after rebuild", 16), timeout=300)
        assert got.token_ids == want.token_ids
        assert runner.allocator.check_invariants() == []
    finally:
        faults.clear()
        sched.shutdown()
        wd.stop()


# -- the vector store, the tuning table and its sweep on the card ----------


@pytest.mark.cuda
def test_cuda_store_find_equals_the_cpu_store():
    """One seeded sequence of sets, deletes (a freed row reused) and
    finds on a store on the card and one on the CPU: the same rows in the
    same order, equal scores lower row first (power-of-two multiples of
    one vector), similarities within 1e-6."""
    _card()
    from localai_tpu_torch.stores import VectorStore

    rng = np.random.default_rng(5)
    keys = rng.normal(size=(300, 48)).astype(np.float32)
    tie = keys[0].copy()
    for j, row in enumerate((17, 90, 211)):
        keys[row] = tie * np.float32(2.0 ** (j + 1))
    stores = {d: VectorStore(device=d) for d in ("cuda", "cpu")}
    reused = rng.normal(size=48).astype(np.float32)
    for st in stores.values():
        st.set(keys, [str(i).encode() for i in range(len(keys))])
        st.delete([keys[40], keys[41]])
        st.set([reused], [b"reused"])
    rng = np.random.default_rng(6)
    queries = [tie, np.zeros(48, np.float32)] + [
        rng.normal(size=48).astype(np.float32) for _ in range(8)]
    for q in queries:
        got = {d: st.find(q, 12) for d, st in stores.items()}
        assert got["cuda"][1] == got["cpu"][1]
        assert got["cuda"][0] == got["cpu"][0]
        np.testing.assert_allclose(got["cuda"][2], got["cpu"][2],
                                   atol=1e-6)
    ties = stores["cuda"].find(tie, 4)[1]
    assert ties == [b"0", b"17", b"90", b"211"]


@pytest.mark.cuda
def test_cuda_runner_drops_a_refused_tuned_block(tmp_path, monkeypatch,
                                                 caplog):
    """A table entry whose block size K1 cannot take at this shape (f32,
    head dim 128, bt 128: 262144 B of tiles) is dropped on the card with
    one warning naming the entry and the gate's reason; the runner loads
    at the default 64. On the CPU the same entry applies."""
    import json
    import logging

    _card()
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.llama import LlamaConfig, init_params
    from localai_tpu_torch.ops import tuning

    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=256, num_layers=1, num_heads=2,
                      num_kv_heads=1, max_position_embeddings=512,
                      dtype="float32")
    path = tmp_path / "tuning.json"
    key = tuning.shape_key(128, 1, "float32", 1)
    path.write_text(json.dumps({key: {"impl": "pallas",
                                      "block_tokens": 128}}))
    monkeypatch.setenv(tuning.ENV_CACHE, str(path))
    monkeypatch.delenv("LOCALAI_KV_BLOCK_TOKENS", raising=False)
    tuning.reset()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    try:
        with caplog.at_level(logging.WARNING):
            r = ModelRunner(cfg, _tree_to(params, "cuda"), num_slots=2,
                            max_ctx=256, kv_dtype="float32", paged=True,
                            device="cuda")
        dropped = [m for m in caplog.messages if key in m]
        assert r.block_tokens == 64 and r.paged_attn_impl == "kernel"
        assert len(dropped) == 1 and "shared memory" in dropped[0]
        cpu = ModelRunner(cfg, params, num_slots=2, max_ctx=256,
                          kv_dtype="float32", paged=True, device="cpu")
        assert cpu.block_tokens == 128
    finally:
        tuning.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("block_tokens", [16, 32, 64, 128])
def test_cuda_sweep_kernel_point_equals_plain(kv_dtype, block_tokens):
    """The sweep's kernel point (K1 on ``tools.autotune``'s inputs at the
    llama3-8b preset) equals its plain point at every candidate block."""
    _card()
    from localai_tpu_torch.tools import autotune

    hd, kv = autotune.PRESET_SHAPES["llama3-8b"]
    inp = autotune.point_inputs(hd, kv, kv_dtype, block_tokens=block_tokens,
                                device="cuda")
    before = tops.paged_decode_attention.launches
    got = autotune.point_fn(inp, autotune.KERNEL_IMPL)()
    torch.cuda.synchronize()
    assert tops.paged_decode_attention.launches == before + 1
    q = inp["q"]
    kvs = ((inp["k"], inp["v"]) if inp["k_scale"] is not None
           else (inp["k"].float(), inp["v"].float()))
    want = tops.paged_decode_attention_ref(
        q.float(), *kvs, inp["tables"], inp["positions"], inp["k_scale"],
        inp["v_scale"])
    _slot_check(got, want, q.dtype)
    for impl in (autotune.KERNEL_IMPL, autotune.PLAIN_IMPL):
        runs = []
        us = autotune.measure_point(hd, kv, kv_dtype, impl=impl,
                                    block_tokens=block_tokens,
                                    num_buffers=2, reps=2, device="cuda",
                                    runs=runs)
        assert us == min(runs) > 0 and len(runs) == 2


# -- the host KV tier on the card ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_cuda_pool_block_round_trip_is_bit_exact(kv_dtype, monkeypatch):
    """``pack_block`` copies a card pool block into pinned host memory
    behind a CUDA event; after ``wait()`` the payload holds the block's
    bytes, and ``load_block`` writes them back bit for bit without
    touching another block; the payload's bytes equal a CPU pool's."""
    _card()
    monkeypatch.delenv("LOCALAI_KV_TIER_MB", raising=False)
    from localai_tpu_torch.fleet.kveconomy.tiering import payload_nbytes

    runners = {dev: _small_tiered(dev, kv_dtype) for dev in ("cuda", "cpu")}
    r = runners["cuda"]
    g = torch.Generator(device="cuda").manual_seed(3)
    pool = r._pool_tensors()
    for t in pool.values():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        else:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                  device="cuda", dtype=torch.int8))
    before = {n: t.clone() for n, t in pool.items()}
    payload = r.pack_block(5)
    assert payload.event is not None
    payload.wait()
    for n, t in pool.items():
        assert payload[n].is_pinned() and payload[n].dtype == t.dtype
        assert torch.equal(payload[n].view(torch.uint8),
                           before[n][:, 5].cpu().view(torch.uint8)), n
        t[:, 5].zero_()
    r.load_block(5, payload)
    torch.cuda.synchronize()
    for n, t in pool.items():
        assert torch.equal(t.view(torch.uint8), before[n].view(torch.uint8))
    assert payload_nbytes(payload) == payload_nbytes(
        runners["cpu"].pack_block(5))


def _small_tiered(dev, kv_dtype="float32"):
    """debug:small on ``dev`` with a 12-block pool: a few prompts evict.
    A bf16 pool computes in bf16 (the kernel takes a float pool in the
    compute dtype), every other pool in float32."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(
        DEBUG_PRESETS["small"],
        dtype="bfloat16" if kv_dtype == "bfloat16" else "float32")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(p):
        return ({k: to(v) for k, v in p.items()} if isinstance(p, dict)
                else p.to(dev))

    return ModelRunner(cfg, to(params), num_slots=2, max_ctx=96,
                       prefill_buckets=[16, 32], kv_dtype=kv_dtype,
                       paged=True, kv_block_tokens=16, prefill_chunk=16,
                       kv_num_blocks=12, device=dev)


def _tier_drill(r):
    """A reference chain, cold fillers until it spills, the chain again:
    (first ids, second ids)."""
    def generate(prompt, steps):
        s = r.acquire_slot()
        out = [int(r.admit(s, list(prompt), temperature=0.0))]
        out += [int(r.step()[s]) for _ in range(steps)]
        r.release(s)
        return out

    prompt = list(b"spill me to host ram and bring me back intact")
    first = generate(prompt, 5)
    filler = 0
    while r.allocator.spills_total < 1 and filler < 12:
        generate([60 + filler] * 33, 2)
        filler += 1
    return first, generate(prompt, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int4"])
def test_cuda_tiered_runner_equals_the_cpu(kv_dtype, monkeypatch):
    """``LOCALAI_KV_TIER_MB`` on the card: the evicted chain spills to
    pinned memory, the next hit reloads it, K1 decodes over the reloaded
    blocks, and the greedy ids and tier counters equal the CPU's."""
    _card()
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    out = {}
    for dev in ("cuda", "cpu"):
        r = _small_tiered(dev, kv_dtype)
        k1 = tops.paged_decode_attention.launches
        first, again = _tier_drill(r)
        a = r.allocator
        assert a.spills_total >= 1 and a.reloads_total >= 1
        assert first == again and a.check_invariants() == []
        if dev == "cuda":
            assert tops.paged_decode_attention.launches > k1
        out[dev] = (first, a.tier_stats())
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# tensor parallelism (model=2) on the card


def _tp_models(tmp_path):
    import json

    models = tmp_path / "models"
    models.mkdir()
    (models / "s.yaml").write_text(json.dumps({
        "name": "s", "model": "debug:small", "seed": 3,
        "context_size": 512, "engine": {
            "dtype": "float32", "kv_dtype": "float32", "max_slots": 4,
            "kv_block_tokens": 16}}))
    return models


def _tp_streams(models, mesh_shape):
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.engine.scheduler import GenRequest
    from localai_tpu_torch.models.manager import ModelManager

    loader = ConfigLoader(models)
    loader.load_from_path(context_size=512)
    mgr = ModelManager(AppConfig(model_path=str(models), device="cuda",
                                 mesh_shape=mesh_shape), loader)
    try:
        sm = mgr.get("s")
        hs = [sm.scheduler.submit(GenRequest(prompt=list(p),
                                             max_new_tokens=16,
                                             temperature=0.0))
              for p in (b"two ranks", b"one card each", b"abcabcabc")]
        streams = [h.result(300).token_ids for h in hs]
        return streams, sm, mgr
    except BaseException:
        mgr.shutdown()
        raise


@pytest.mark.cuda
@pytest.mark.parametrize("cards,width", [(1, 2), (2, 2), (4, 4)],
                         ids=["one-card-gloo", "two-cards-nccl",
                              "four-cards-nccl"])
def test_cuda_tensor_parallel_group(tmp_path, monkeypatch, cards, width):
    """``model=width`` through the real follower path: the leader (this
    process) spawns ``cli.main follower`` ranks; on a host with one card
    both ranks share it (gloo on CUDA tensors), on a host with as many
    cards as ranks each has its own (NCCL). K1 on the leader's kv-head
    shard (debug:small's 8 q / 4 kv heads over the ranks) equals its
    plain version on the inputs of a served decode step; the greedy
    streams equal one card's; each follower's stop report has K1 = L x
    its decode steps and the leader's token digest."""
    _card()
    n = torch.cuda.device_count()
    if (n == 1) != (cards == 1) or n < cards:
        pytest.skip(f"for a host with {cards} card(s); this one has {n}")
    from localai_tpu_torch.parallel import multihost as mh

    models = _tp_models(tmp_path)
    # model=1: one card, where more than one would auto-mesh the model
    one, _sm, mgr = _tp_streams(models, {"model": 1})
    mgr.shutdown()
    before = len(mh.REPORTS)
    streams, sm, mgr = _tp_streams(models, {"model": width})
    try:
        runner = sm.runner
        assert runner.mesh.backend == ("gloo" if cards == 1 else "nccl")
        assert runner.local_cfg.num_heads == 8 // width
        seen = []
        real = tops.paged_decode_attention

        def spy(*args, **kw):
            if not seen:
                seen.append((args, kw))
            return real(*args, **kw)

        monkeypatch.setattr(tops, "paged_decode_attention", spy)
        slot = runner.acquire_slot()
        runner.admit(slot, list(b"a shard of heads"), temperature=0.0)
        runner.step()
        monkeypatch.setattr(tops, "paged_decode_attention", real)
        (q, k, v, tables, pos, *scales), kw = seen[0]
        assert q.shape[1] == 8 // width                # [N, Hkv, bt, hd]
        assert k.shape[1] == 4 // width
        got = real(q, k, v, tables, pos, *scales, **kw)
        want = tops.paged_decode_attention_ref(q.float(), k.float(),
                                               v.float(), tables, pos,
                                               *scales, **kw)
        _slot_check(got, want, torch.float32)
        digest, steps = runner.digest.hexdigest(), runner.decode_steps
    finally:
        mgr.shutdown()
    assert streams == one
    rep = mh.REPORTS[before:]
    assert len(rep) == width - 1
    for r in rep:
        assert r["models"]["s"]["digest"] == digest
        assert r["models"]["s"]["decode_steps"] == steps
        assert r["launches"]["paged_decode_attention"] == 4 * steps


def _seq_pipe_models(tmp_path):
    import json

    models = tmp_path / "sp-models"
    models.mkdir()
    (models / "s.yaml").write_text(json.dumps({
        "name": "s", "model": "debug:small", "seed": 3,
        "context_size": 512, "engine": {
            "dtype": "float32", "kv_dtype": "float32", "max_slots": 4,
            "kv_block_tokens": 16, "sp_prefill_threshold": 8}}))
    return models


@pytest.mark.cuda
@pytest.mark.parametrize("cards,axis", [(1, "seq"), (1, "pipe"),
                                        (2, "seq"), (2, "pipe")],
                         ids=["one-card-gloo-seq", "one-card-gloo-pipe",
                              "two-cards-nccl-seq", "two-cards-nccl-pipe"])
def test_cuda_seq_and_pipe_group(tmp_path, cards, axis):
    """``seq=2`` and ``pipe=2`` through the real follower path: on a host
    with one card both ranks share it (gloo on CUDA tensors, the ring
    hops and stage hand-offs through pinned host memory), on a host with
    two cards each has its own (NCCL). The greedy streams equal one
    card's; at ``seq=2`` every prompt (past a threshold of 8) takes the
    ring prefill into the paged pool and K1 runs L x steps on each rank;
    at ``pipe=2`` each stage holds 2 of debug:small's 4 layers on the
    contiguous layout and runs K2 2 x steps and K3 2 x prefills; each
    follower's report has the leader's digest."""
    _card()
    n = torch.cuda.device_count()
    if (n == 1) != (cards == 1) or n < cards:
        pytest.skip(f"for a host with {cards} card(s); this one has {n}")
    from localai_tpu_torch.parallel import multihost as mh

    models = _seq_pipe_models(tmp_path)
    one, _sm, mgr = _tp_streams(models, {"model": 1})
    mgr.shutdown()
    before = len(mh.REPORTS)
    streams, sm, mgr = _tp_streams(models, {axis: 2})
    try:
        runner = sm.runner
        assert runner.mesh.backend == ("gloo" if cards == 1 else "nccl")
        if axis == "seq":
            assert runner.paged and runner.sp_prefills == 3
            assert runner.last_prefill_path == "paged_sp"
        else:
            assert not runner.paged and runner.local_cfg.num_layers == 2
            for k in ("handoff_sent", "handoff_waited"):
                t = runner.transfers[k]
                assert t.calls > 0 and t.seconds > 0
        digest, steps = runner.digest.hexdigest(), runner.decode_steps
        prefills = runner.fresh_prefills
    finally:
        mgr.shutdown()
    assert streams == one
    rep = mh.REPORTS[before:]
    assert len(rep) == 1
    rm, fl = rep[0]["models"]["s"], rep[0]["launches"]
    assert (rm["digest"], rm["decode_steps"]) == (digest, steps)
    if axis == "seq":
        assert rm["sp_prefills"] == 3
        assert fl["paged_decode_attention"] == 4 * steps
        assert fl["prefill_attention"] == 0
    else:
        assert fl["decode_attention"] == 2 * steps
        assert fl["prefill_attention"] == 2 * prefills
