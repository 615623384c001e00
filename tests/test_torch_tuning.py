"""The port's tuning table, its consumers and its sweep against the JAX
package's (``ops/tuning.py``, ``engine/runner.py``, ``tools/autotune.py``).

Every case of ``tests/test_tuning.py`` runs on both packages where the
port has the same behaviour; where the port's card path differs (one
attention path per device: a tuned impl is read and moves nothing; K1's
shared-memory gate drops a block size the kernel cannot take), the case
pins the port's rule. Files written by either package load equal in the
other and ``save`` writes the same bytes; a paged runner on
``debug:tiny`` picks the same block size from the same table on both,
with one lookup receipt, and decodes the same greedy tokens.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from localai_tpu import ops as jops  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.obs.metrics import REGISTRY as JREG  # noqa: E402
from localai_tpu.ops import tuning as jtuning  # noqa: E402
from localai_tpu_torch import ops as tops  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.obs.metrics import REGISTRY as TREG  # noqa: E402
from localai_tpu_torch.ops import tuning as ttuning  # noqa: E402
from localai_tpu_torch.tools import autotune as tautotune  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_runner import _greedy, _model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jtuning, JREG), "port": (ttuning, TREG)}


@pytest.fixture(autouse=True)
def _fresh_table(monkeypatch, tmp_path):
    """Each test gets its own cache path and cleared singletons."""
    path = tmp_path / "tuning.json"
    monkeypatch.setenv(jtuning.ENV_CACHE, str(path))
    monkeypatch.delenv("LOCALAI_KV_BLOCK_TOKENS", raising=False)
    monkeypatch.delenv("LOCALAI_PAGED_NUM_BUFFERS", raising=False)
    jtuning.reset()
    ttuning.reset()
    yield path
    jtuning.reset()
    ttuning.reset()


def _write_table(path, key, **entry):
    path.write_text(json.dumps({key: entry}))
    jtuning.reset()
    ttuning.reset()


def _lookups(reg, result=None):
    s = reg.autotune_lookups._series  # noqa: SLF001
    if result is None:
        return sum(s.values())
    return s.get((("result", result),), 0.0)


# -- the cases of tests/test_tuning.py, on both packages -------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_table_roundtrip(_fresh_table, pkg):
    tuning, _ = PACKAGES[pkg]
    t = tuning.TuningTable(path=str(_fresh_table))
    key = tuning.shape_key(128, 8, "int8", 2)
    assert key == "hd128_kv8_int8_tp2"
    t.put(key, tuning.TuneEntry(impl="pallas", block_tokens=64,
                                num_buffers=3, us=412.5))
    t.save()
    back = tuning.TuningTable.load(str(_fresh_table))
    e = back.lookup(key)
    assert e == tuning.TuneEntry(impl="pallas", block_tokens=64,
                                 num_buffers=3, us=412.5)
    assert tuning.lookup(128, 8, "int8", 2) == e
    assert tuning.lookup(128, 8, "int4", 2) is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_corrupt_file_falls_back_to_defaults(_fresh_table, pkg, caplog):
    tuning, _ = PACKAGES[pkg]
    _fresh_table.write_text("{ not json !!!")
    with caplog.at_level(logging.WARNING):
        t = tuning.TuningTable.load(str(_fresh_table))
    assert t.entries == {}
    assert sum("unreadable" in m for m in caplog.messages) == 1
    assert tuning.lookup(128, 8, "int8", 1) is None
    _fresh_table.write_text(json.dumps({
        "hd128_kv8_int8_tp1": {"impl": "pallas", "block_tokens": 64},
        "bad1": {"impl": "warp-drive"},
        "bad2": {"block_tokens": "lots"},
        "bad3": [1, 2, 3],
        "bad4": {"num_buffers": -1},
    }))
    tuning.reset()
    t = tuning.TuningTable.load(str(_fresh_table))
    assert set(t.entries) == {"hd128_kv8_int8_tp1"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_missing_and_disabled_paths(_fresh_table, monkeypatch, pkg):
    tuning, _ = PACKAGES[pkg]
    assert tuning.TuningTable.load(str(_fresh_table)).entries == {}
    monkeypatch.setenv(tuning.ENV_CACHE, "0")
    tuning.reset()
    assert tuning.cache_path() == ""
    assert tuning.lookup(128, 8, "int8", 1) is None
    monkeypatch.delenv(tuning.ENV_CACHE)
    assert tuning.cache_path() == os.path.expanduser(
        "~/.cache/localai_tpu/tuning.json")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_lookup_metric_receipts(_fresh_table, pkg):
    tuning, reg = PACKAGES[pkg]
    _write_table(_fresh_table, tuning.shape_key(64, 8, "int8", 1),
                 impl="xla", block_tokens=64)
    h0, m0 = _lookups(reg, "hit"), _lookups(reg, "miss")
    assert tuning.lookup(64, 8, "int8", 1) is not None
    assert tuning.lookup(64, 8, "int4", 1) is None
    assert _lookups(reg, "hit") == h0 + 1
    assert _lookups(reg, "miss") == m0 + 1
    # the entries gauge follows the loaded table
    assert reg.autotune_entries._series[()] == 1.0  # noqa: SLF001


def test_select_reads_a_tuned_impl_and_keeps_one_path(_fresh_table,
                                                       caplog):
    """The JAX package moves to its XLA path on a tuned "xla"; the port's
    runner reads it, names it in one log line and keeps the device's one
    attention path (the kernel on the card, the plain version on the
    CPU). The port's selector never looks the table up itself: the
    runner's one receipt is the only one."""
    shape = dict(num_heads=32, num_kv_heads=8, head_dim=128,
                 block_tokens=64, kv_dtype=torch.bfloat16,
                 dtype=torch.bfloat16)
    n0 = _lookups(TREG)
    for dev, want in (("cuda", "kernel"), ("cpu", "torch")):
        assert tops.select_paged_attn_impl(device=dev, **shape)[0] == want
    assert _lookups(TREG) == n0
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    key = ttuning.shape_key(cfg_t.hd, cfg_t.num_kv_heads, "float32", 1)
    for impl, noted in (("xla", 1), ("pallas", 0)):
        _write_table(_fresh_table, key, impl=impl)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            tr = ModelRunner(cfg_t, params_t, paged=True, device="cpu",
                             num_slots=2, max_ctx=128, prefill_buckets=[64],
                             kv_dtype="float32")
        assert tr.paged_attn_impl == "torch"
        assert sum("tuned impl 'xla'" in m
                   for m in caplog.messages) == noted
    # the JAX package's: a tuned "xla" overrides the TPU default
    impl, _, _ = jops.select_paged_attn_impl(
        "auto", num_heads=32, num_kv_heads=8, head_dim=128,
        block_tokens=64, kv_dtype="bfloat16", backend="tpu",
        tuned=jtuning.TuneEntry(impl="xla"))
    assert impl == "xla"


@pytest.mark.parametrize("entry,shape,why", [
    # f32 at hd 128, bt 128: 4 * 128 * 512 B of tiles
    ({"block_tokens": 128}, (32, 8, 128, "float32"), "shared memory"),
    ({"block_tokens": 64}, (32, 8, 128, "float32"), ""),
    ({"block_tokens": 128}, (32, 8, 128, "bfloat16"), ""),
    ({"block_tokens": 128}, (32, 8, 128, "int8"), ""),
    # a quantized pool's blocks are a multiple of 4
    ({"block_tokens": 30}, (32, 8, 128, "int4"), "multiple of 4"),
    ({"block_tokens": 16}, (16, 4, 100, "bfloat16"), "head_dim 100"),
    ({"impl": "xla"}, (32, 8, 128, "float32"), ""),   # no block: nothing
], ids=["f32-bt128", "f32-bt64", "bf16-bt128", "int8-bt128",
        "int4-bt30", "hd100", "no-block"])
def test_tuned_block_gate_is_a_pure_function(entry, shape, why):
    """Whether K1 takes a table entry's block size: (entry, shape, dtype)
    in, the kernel gate's reason out (``ops.paged_gate``, which the
    runner asks on the card) — no card needed. An entry without a block
    size is not gated: the runner keeps the default, which K1 takes."""
    hq, hkv, hd, kv = shape
    pool = kv if kv in ("int8", "int4") else getattr(torch, kv)
    dtype = torch.bfloat16 if kv in ("int8", "int4") else pool
    bt = ttuning.TuneEntry(**entry).block_tokens
    got = tops.paged_gate(num_heads=hq, num_kv_heads=hkv, head_dim=hd,
                          block_tokens=bt or 64, kv_dtype=pool, dtype=dtype)
    assert (why in got) if why else got == ""
    if why:
        with pytest.raises(ValueError, match=why):
            tops.select_paged_attn_impl(
                device="cuda", num_heads=hq, num_kv_heads=hkv,
                head_dim=hd, block_tokens=bt, kv_dtype=pool, dtype=dtype)


# -- files across the packages ----------------------------------------------


ENTRIES = {
    "hd128_kv8_int8_tp1": dict(impl="pallas", block_tokens=64,
                               num_buffers=3, us=412.5),
    "hd64_kv8_bfloat16_tp2": dict(impl="xla", block_tokens=32),
    "hd16_kv2_float32_tp1": dict(block_tokens=8, us=0.1),
    "hd128_kv8_int4_tp1": dict(),
}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_files_cross_load_and_save_the_same_bytes(tmp_path, writer,
                                                  reader):
    wt, _ = PACKAGES[writer]
    rt, _ = PACKAGES[reader]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    table = wt.TuningTable(path=str(a))
    for k, e in ENTRIES.items():
        table.put(k, wt.TuneEntry(**e))
    table.save()
    back = rt.TuningTable.load(str(a))
    assert {k: e.to_dict() for k, e in back.entries.items()} == {
        k: e.to_dict() for k, e in table.entries.items()}
    back.save(str(b))
    assert a.read_bytes() == b.read_bytes()


# -- the runner's block choice ----------------------------------------------


def _runners(cfg_j, params_j, cfg_t, params_t, **kw):
    kw = dict(num_slots=2, max_ctx=128, prefill_buckets=[64],
              kv_dtype="float32", **kw)
    return (JaxRunner(cfg_j, params_j, paged=True, attn_impl="xla", **kw),
            ModelRunner(cfg_t, params_t, paged=True, device="cpu", **kw))


def test_runner_picks_the_tuned_block_on_both(_fresh_table):
    """debug:tiny under one table: the same block size and buffer depth
    on both runners, one lookup receipt each, equal greedy tokens."""
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    _write_table(_fresh_table,
                 ttuning.shape_key(cfg_t.hd, cfg_t.num_kv_heads, "float32",
                                   1),
                 impl="xla", block_tokens=32, num_buffers=3)
    j0, t0 = _lookups(JREG, "hit"), _lookups(TREG, "hit")
    jn, tn = _lookups(JREG), _lookups(TREG)
    jr, tr = _runners(cfg_j, params_j, cfg_t, params_t)
    assert jr.block_tokens == tr.block_tokens == 32
    assert jr.paged_num_buffers == tr.paged_num_buffers == 3
    assert (_lookups(JREG, "hit") - j0, _lookups(TREG, "hit") - t0) == (1, 1)
    assert (_lookups(JREG) - jn, _lookups(TREG) - tn) == (1, 1)
    prompts = [list(b"a tuned block of thirty-two rows, crossed twice over"),
               list(b"hi")]
    assert _greedy(tr, prompts, steps=12)[1] == \
        _greedy(jr, prompts, steps=12)[1]


@pytest.mark.parametrize("kwarg,env,table,want", [
    (16, "64", 32, 16),        # the explicit kwarg first
    (None, "64", 32, 64),      # then LOCALAI_KV_BLOCK_TOKENS
    (None, "", 32, 32),        # then the table
    (None, "", None, 64),      # then the built-in default
    (None, "bogus", 32, 32),   # an unreadable env value is ignored
])
def test_block_precedence_on_both(_fresh_table, monkeypatch, kwarg, env,
                                  table, want):
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    if table is not None:
        _write_table(_fresh_table,
                     ttuning.shape_key(cfg_t.hd, cfg_t.num_kv_heads,
                                       "float32", 1),
                     block_tokens=table)
    if env:
        monkeypatch.setenv("LOCALAI_KV_BLOCK_TOKENS", env)
    kw = {"kv_block_tokens": kwarg} if kwarg else {}
    jr, tr = _runners(cfg_j, params_j, cfg_t, params_t, **kw)
    assert jr.block_tokens == tr.block_tokens == want


def test_num_buffers_env_is_read_and_moves_nothing(_fresh_table,
                                                   monkeypatch, caplog):
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    monkeypatch.setenv("LOCALAI_PAGED_NUM_BUFFERS", "4")
    with caplog.at_level(logging.INFO):
        jr, tr = _runners(cfg_j, params_j, cfg_t, params_t)
    assert jr.paged_num_buffers == tr.paged_num_buffers == 4
    assert sum("two stages" in m for m in caplog.messages) == 1


# -- the sweep --------------------------------------------------------------


def test_measure_point_draws_the_jax_inputs():
    """``point_inputs`` draws what the JAX sweep's ``measure_point``
    draws (np.random.default_rng(0), same order and shapes)."""
    import numpy as np

    inp = tautotune.point_inputs(16, 2, "float32", block_tokens=8, ctx=32)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 8, 16)).astype(np.float32)
    k = rng.normal(size=(17, 2, 8, 16)).astype(np.float32)
    v = rng.normal(size=(17, 2, 8, 16)).astype(np.float32)
    assert np.array_equal(inp["q"].numpy(), q)
    assert np.array_equal(inp["k"].numpy(), k)
    assert np.array_equal(inp["v"].numpy(), v)
    assert inp["tables"].tolist() == np.arange(1, 17).reshape(4, 4).tolist()
    assert inp["positions"].tolist() == [30] * 4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_autotune_smoke_cli(tmp_path, monkeypatch, pkg):
    """The CI smoke path end to end on either package: a tiny sweep makes
    a loadable table; on the CPU the port's kernel points fail naming the
    card and the plain point is installed."""
    import tools.autotune as jat

    main = jat.main if pkg == "jax" else tautotune.main
    tuning, _ = PACKAGES[pkg]
    out = tmp_path / "table.json"
    monkeypatch.setenv(tuning.ENV_CACHE, str(out))
    tuning.reset()
    rc = main(["--preset", "tiny", "--kv-dtypes", "float32", "--tp", "1",
               "--blocks", "8", "--buffers", "2", "--ctx", "32", "--out",
               str(out)])
    assert rc == 0
    table = tuning.TuningTable.load(str(out))
    entry = table.lookup(tuning.shape_key(16, 2, "float32", 1))
    assert entry is not None and entry.block_tokens == 8
    assert entry.impl in ("xla", "pallas")


def test_port_sweep_smoke_writes_a_table_the_jax_package_reads(tmp_path):
    """The port's sweep module run as ``python -m <module> --smoke`` in a
    fresh interpreter: JSON lines, kernel points failing on the CPU with the
    card named, a summary, and a table JAX's ``TuningTable.load`` reads
    with every key the JAX smoke would write."""
    out = tmp_path / "smoke.json"
    res = subprocess.run(
        [sys.executable, "-m", tautotune.__name__, "--smoke", "--out",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert "interpreter" in lines[0]["note"]
    errors = [r for r in lines if "error" in r]
    assert errors and all("CUDA card" in r["error"] for r in errors)
    summary = lines[-1]
    assert summary["entries"] == 4 and summary["points_measured"] == 8
    table = jtuning.TuningTable.load(str(out))
    assert set(table.entries) == {jtuning.shape_key(16, 2, dt, tp)
                                  for dt in ("float32", "int4")
                                  for tp in (1, 2)}
    assert all(e.impl == "xla" and e.block_tokens in (8, 16)
               for e in table.entries.values())


def test_sweep_installs_the_fastest_kernel_point(monkeypatch):
    """A key's winner is its fastest kernel point when one was measured
    (the card), else its fastest plain point (the CPU)."""
    times = {("xla", 8): 5.0, ("xla", 16): 1.0, ("pallas", 8): 3.0,
             ("pallas", 16): 4.0}
    monkeypatch.setattr(tautotune, "measure_point",
                        lambda *a, impl, block_tokens, **k:
                        times[(impl, block_tokens)])
    table = ttuning.TuningTable()
    tautotune.sweep([(16, 2)], ["float32"], [1], block_candidates=[8, 16],
                    buffer_candidates=[2], impls=["xla", "pallas"], ctx=64,
                    interpret=False, table=table)
    e = table.lookup("hd16_kv2_float32_tp1")
    assert (e.impl, e.block_tokens, e.us) == ("pallas", 8, 3.0)
    table = ttuning.TuningTable()
    tautotune.sweep([(16, 2)], ["float32"], [1], block_candidates=[8, 16],
                    buffer_candidates=[2], impls=["xla"], ctx=64,
                    interpret=False, table=table)
    e = table.lookup("hd16_kv2_float32_tp1")
    assert (e.impl, e.block_tokens) == ("xla", 16)
    seconds = {dict(k)["key"] for k in
               TREG.autotune_sweep_seconds._series}  # noqa: SLF001
    assert "hd16_kv2_float32_tp1" in seconds


def _fake_points(times, spreads=None):
    """A ``measure_point`` stand-in: ``times[(impl, bt)]`` microseconds,
    with runs spread ``spreads[(impl, bt)]`` apart."""
    spreads = spreads or {}

    def measure(*a, impl, block_tokens, runs=None, **k):
        us = times[(impl, block_tokens)]
        if isinstance(us, Exception):
            raise us
        if runs is not None:
            runs.extend([us, us + spreads.get((impl, block_tokens), 0.0)])
        return us
    return measure


def test_card_sweep_skips_gated_blocks_and_raises_on_kernel_errors(
        monkeypatch, capsys):
    """On the card a kernel point fails only where the kernel's gate
    refuses its block (f32 at hd 128, bt 128: over the shared memory);
    any other kernel error raises, and a key left with no kernel point
    raises, rather than installing the plain version."""
    kw = dict(buffer_candidates=[2, 3], ctx=512, interpret=False,
              device="cuda")
    monkeypatch.setattr(tautotune, "measure_point", _fake_points(
        {("pallas", 64): 7.0, ("pallas", 128): 1.0, ("xla", 64): 2.0,
         ("xla", 128): 1.0}))
    table = ttuning.TuningTable()
    recs = tautotune.sweep([(128, 8)], ["float32"], [1],
                           block_candidates=[64, 128],
                           impls=["xla", "pallas"], table=table, **kw)
    (bad,) = [r for r in recs if "error" in r]
    assert (bad["impl"], bad["block_tokens"]) == ("pallas", 128)
    assert "shared memory" in bad["error"]
    # one buffer depth on the card: it moves nothing on K1
    assert [r["num_buffers"] for r in recs if r["impl"] == "pallas"] == [2, 2]
    e = table.lookup("hd128_kv8_float32_tp1")
    assert (e.impl, e.block_tokens, e.num_buffers) == ("pallas", 64, 2)
    # only gated kernel blocks: the key has no kernel point
    with pytest.raises(RuntimeError, match="no kernel point"):
        tautotune.sweep([(128, 8)], ["float32"], [1],
                        block_candidates=[128], impls=["xla", "pallas"],
                        table=ttuning.TuningTable(), **kw)
    # a kernel that fails to build or launch raises
    monkeypatch.setattr(tautotune, "measure_point", _fake_points(
        {("pallas", 64): RuntimeError("launch failed (code 98)"),
         ("xla", 64): 2.0}))
    table = ttuning.TuningTable()
    with pytest.raises(RuntimeError, match="code 98"):
        tautotune.sweep([(128, 8)], ["bfloat16"], [1],
                        block_candidates=[64], impls=["xla", "pallas"],
                        table=table, **kw)
    assert table.entries == {}
    # the same error on the CPU is a failed point, as the JAX sweep has it
    table = ttuning.TuningTable()
    recs = tautotune.sweep([(128, 8)], ["bfloat16"], [1],
                           block_candidates=[64], impls=["xla", "pallas"],
                           table=table, **{**kw, "device": "cpu"})
    assert [r["error"] for r in recs if "error" in r] == [
        "RuntimeError: launch failed (code 98)"] * 2
    assert table.lookup("hd128_kv8_bfloat16_tp1").impl == "xla"


@pytest.mark.parametrize("spread,want", [(0.0, 32), (0.5, 32), (3.0, 64)],
                         ids=["no-spread", "beats-spread", "within-spread"])
def test_sweep_keeps_the_default_block_within_the_spread(monkeypatch,
                                                         spread, want):
    """The fastest kernel block is installed only where it beats the
    default block's point by more than the spread of the two points'
    runs; else the default block (64) is."""
    monkeypatch.setattr(tautotune, "measure_point", _fake_points(
        {("pallas", 32): 10.0, ("pallas", 64): 12.0},
        {("pallas", 32): spread}))
    table = ttuning.TuningTable()
    recs = tautotune.sweep([(128, 8)], ["bfloat16"], [1],
                           block_candidates=[32, 64], buffer_candidates=[2],
                           impls=["pallas"], ctx=512, interpret=False,
                           table=table, device="cuda")
    assert [r["spread_us"] for r in recs] == [spread, 0.0]
    assert table.lookup("hd128_kv8_bfloat16_tp1").block_tokens == want


def test_timeit_returns_one_time_per_run():
    calls = []
    runs = tautotune._timeit(lambda: calls.append(1), n=4, warmup=1,
                             reps=3, cuda=False)
    assert len(runs) == 3 and all(t >= 0 for t in runs)
    assert len(calls) == 1 + 3 * 4
