"""The row plan of the port's bf16 prefill kernel (K3), on the CPU.

A bf16 K3 CUDA block of 4 warps takes 128 query rows (32 a warp), whose
shared-memory K/V fragments each feed twice the tensor-core work of a
64-row block's (16 a warp), unless 128-row blocks would number fewer than
two per SM (two fit an SM at once); then it takes 64.
The plan reads shapes and the SM count only. On the CPU the wrapper runs
its plain version whatever rows are asked for; the kernel at both sizes is
held against that plain version on the card (tests/test_torch_cuda.py).
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu_torch.ops import attention as tatt  # noqa: E402


def test_plan_reads_shapes_only():
    params = list(inspect.signature(tatt.prefill_block_rows).parameters)
    assert params == ["T", "Hq", "Hkv", "sms"]


@pytest.mark.parametrize("T,Hq,Hkv,sms,rows", [
    # Llama-3-8B widths on 132 SMs: 1024 positions give 256 blocks of 128
    # rows (fewer than two a SM), so 64; from 1025 positions on, 128
    (4096, 32, 8, 132, 128), (2048, 32, 8, 132, 128), (1025, 32, 8, 132, 128),
    (1024, 32, 8, 132, 64), (512, 32, 8, 132, 64), (1, 32, 8, 132, 64),
    # a GQA group of 8 with one kv head: 16 positions a block
    (8192, 8, 1, 132, 128), (4096, 8, 1, 132, 64),
    # a small card takes 128 rows sooner
    (512, 32, 8, 16, 128)])
def test_plan_rows(T, Hq, Hkv, sms, rows):
    assert tatt.prefill_block_rows(T, Hq, Hkv, sms) == rows


@pytest.mark.parametrize("T", [1, 64, 65, 511, 512, 513, 1023, 4096, 8192])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_plan_is_a_compiled_size_that_fills_the_card(T, G):
    """The plan gives a compiled size, and 128 exactly when 128-row blocks
    put two on every SM."""
    rows = tatt.prefill_block_rows(T, 8 * G, 8, 132)
    assert rows in tatt.PREFILL_ROWS
    assert (rows == 128) == (8 * -(-T * G // 128) >= 2 * 132)


def test_plan_refuses_bad_shapes():
    for bad in ((0, 32, 8, 132), (64, 32, 0, 132), (64, 30, 8, 132),
                (64, 32, 8, 0)):
        with pytest.raises(ValueError):
            tatt.prefill_block_rows(*bad)


@pytest.mark.parametrize("rows", [None, 64, 128])
def test_cpu_tensors_take_the_plain_version(rows):
    """On CPU tensors the wrapper is the plain version at any block size
    and counts no launch."""
    rng = np.random.default_rng(3)
    q, k, v = [torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               for shp in ((40, 8, 16), (2, 40, 16), (2, 40, 16))]
    before = tatt.prefill_attention.launches
    got = tatt.prefill_attention(q, k, v, 30, sliding_window=12,
                                 block_rows=rows)
    assert tatt.prefill_attention.launches == before
    want = tatt.prefill_attention_ref(q, k, v, 30, sliding_window=12)
    assert torch.equal(got, want)
