"""The disk prompt KV cache of the PyTorch port against the JAX package.

The cases of tests/test_promptcache.py run on the port's scheduler and
runner (cold-start reuse, ``prompt_cache_all``, read-only, scaled int8
round trip, a KV-dtype mismatch falling back, the bf16 bit view,
eviction), on the contiguous layout and on the paged one (with int8 and
int4 pools, whose exports keep the scales and the nibble packing). The
RoPE-flavour guard keeps a self-extend export out of a roped runner and
the reverse. The directory format is the JAX package's: a directory
written by the JAX package's scheduler is served by the port with the
greedy tokens of a cold serve, and the other way round (float32 weights
carried across, so the greedy tokens of the two packages are equal). A
snapshot is a copy: reusing its slot before the writer reads it changes
nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu.engine.promptcache import PromptKVCache as JaxCache  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxBytes  # noqa: E402
from localai_tpu_torch.engine.promptcache import PromptKVCache  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_runner import _model  # noqa: E402

PROMPT = list(b"the shared system prompt that should be cached once")
LAYOUTS = [("contiguous", "float32"), ("paged", "float32"),
           ("paged", "int8"), ("paged", "int4")]


def _mk(paged=False, kv="float32", **kw):
    _, _, cfg_t, params_t = _model("small")
    if paged:
        kw.setdefault("kv_block_tokens", 16)
        kw.setdefault("prefill_chunk", 32)
    return ModelRunner(cfg_t, params_t, num_slots=2, max_ctx=128,
                       prefill_buckets=[32, 64], kv_dtype=kv, paged=paged,
                       device="cpu", **kw)


def _sched(cache, paged=False, kv="float32", **kw):
    return Scheduler(_mk(paged, kv), ByteTokenizer(), multi_step=4,
                     prompt_cache=cache, **kw)


def _run(sched, n=8, prompt=PROMPT):
    try:
        return sched.generate(GenRequest(prompt=list(prompt),
                                         max_new_tokens=n, temperature=0.0,
                                         ignore_eos=True),
                              timeout=120).token_ids
    finally:
        sched.shutdown()


@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_cold_start_reuses_disk_cache(tmp_path, layout, kv):
    """A new runner and scheduler on the same directory reuse the stored
    prefix and give the greedy tokens of the first serve."""
    paged = layout == "paged"
    cache = PromptKVCache(tmp_path / "pc")
    ref = _run(_sched(cache, paged, kv))
    assert cache.stores == 1
    cache2 = PromptKVCache(tmp_path / "pc")
    s2 = _sched(cache2, paged, kv)
    got = _run(s2)
    assert cache2.hits == 1
    assert s2.runner.total_prefix_reused >= len(PROMPT) - 1
    assert s2.metrics()["prompt_cache"]["hits"] == 1
    assert got == ref


def test_prompt_cache_all_stores_generation(tmp_path):
    cache = PromptKVCache(tmp_path / "pc")
    _run(_sched(cache, prompt_cache_all=True))
    stored = cache._index[next(iter(cache._index))]
    # prompt + generated tokens (minus the last, unfed one) are cached
    assert len(stored) == len(PROMPT) + 8 - 1


def test_read_only_cache_never_writes(tmp_path):
    cache = PromptKVCache(tmp_path / "pc", read_only=True)
    s = _sched(cache)
    assert s._pc_thread is None
    _run(s, 4)
    assert cache.stores == 0
    assert not (tmp_path / "pc").exists() or not list(
        (tmp_path / "pc").glob("*.npz"))


@pytest.mark.parametrize("paged", [False, True])
def test_dtype_mismatch_falls_back(tmp_path, paged):
    """An int8 entry does not load into a float32 cache: a full prefill."""
    cache = PromptKVCache(tmp_path / "pc")
    _run(_sched(cache, paged, "int8"), 4)
    s2 = _sched(PromptKVCache(tmp_path / "pc"), paged)
    assert len(_run(s2, 4)) == 4
    assert s2.runner.total_prefix_reused == 0


@pytest.mark.parametrize("layout,kv", LAYOUTS + [("contiguous", "int8")])
def test_export_round_trip_is_bit_exact(tmp_path, layout, kv):
    """Exported rows (bf16 as uint16 bits, int8 with scales, int4 packed)
    load into a fresh runner and export again byte for byte."""
    paged = layout == "paged"
    _, _, cfg_t, _ = _model("small")
    r1 = _mk(paged, kv)
    s = r1.acquire_slot()
    r1.admit(s, PROMPT, temperature=0.0)
    blob = r1.export_prefix(s, len(PROMPT))
    hd = cfg_t.hd // 2 if kv == "int4" else cfg_t.hd
    assert blob["k"].shape == (cfg_t.num_layers, cfg_t.num_kv_heads,
                               len(PROMPT), hd)
    assert ("k_scale" in blob) == (kv in ("int8", "int4"))
    cache = PromptKVCache(tmp_path / "pc")
    cache.store(PROMPT, blob)
    hit = cache.lookup(PROMPT + [5])
    assert hit is not None and hit.n == len(PROMPT)
    r2 = _mk(paged, kv)
    s2 = r2.acquire_slot()
    assert r2.load_prefix(s2, hit.arrays, hit.n)
    again = r2.export_prefix(s2, hit.n)
    for name in blob:
        np.testing.assert_array_equal(again[name], blob[name])


def test_bf16_kv_roundtrip_bitview(tmp_path):
    """bfloat16 rows survive the uint16 bit-view serialization."""
    _, _, cfg_t, params_t = _model("small")
    cfg = type(cfg_t)(**{**cfg_t.__dict__, "dtype": "bfloat16"})
    params = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in params_t.items()}

    def mk():
        return ModelRunner(cfg, params, num_slots=2, max_ctx=128,
                           prefill_buckets=[64], paged=False, device="cpu")

    r1 = mk()
    s = r1.acquire_slot()
    r1.admit(s, PROMPT, temperature=0.0)
    blob = r1.export_prefix(s)
    assert blob["k"].dtype == np.uint16 and "k_bf16" in blob
    cache = PromptKVCache(tmp_path / "pc")
    cache.store(PROMPT, blob)
    hit = cache.lookup(PROMPT + [5])
    r2 = mk()
    s2 = r2.acquire_slot()
    assert r2.load_prefix(s2, hit.arrays, hit.n)
    assert torch.equal(r1.kv.k[:, s, :, :hit.n], r2.kv.k[:, s2, :, :hit.n])


def test_eviction_caps_entries(tmp_path):
    cache = PromptKVCache(tmp_path / "pc", max_entries=2, min_prefix=4)
    r = _mk()
    s = r.acquire_slot()
    for i in range(4):
        prompt = [10 + i] * 8
        r.admit(s, prompt, temperature=0.0)
        cache.store(prompt, r.export_prefix(s, 8))
        r.release(s)
        s = r.acquire_slot()
    assert len(cache._index) == 2
    assert len(list((tmp_path / "pc").glob("*.npz"))) == 2


def test_rope_flavour_guard():
    """A self-extend (unroped) export never loads into a roped runner,
    nor the reverse; each loads into its own kind."""
    _, _, cfg_t, params_t = _model("small")
    kw = dict(num_slots=2, max_ctx=128, prefill_buckets=[64],
              kv_dtype="float32", paged=False, device="cpu")
    se_r = ModelRunner(cfg_t, params_t, ga_n=2, ga_w=64, **kw)
    s = se_r.acquire_slot()
    se_r.admit(s, PROMPT, temperature=0.0)
    raw = se_r.export_prefix(s)
    assert str(raw["kv_rope"]) == "raw"
    plain = ModelRunner(cfg_t, params_t, **kw)
    assert not plain.load_prefix(0, raw, len(PROMPT))
    plain.admit(0, PROMPT, temperature=0.0)
    roped = plain.export_prefix(0)
    assert str(roped["kv_rope"]) == "roped"
    se2 = ModelRunner(cfg_t, params_t, ga_n=2, ga_w=64, **kw)
    assert not se2.load_prefix(0, roped, len(PROMPT))
    assert se2.load_prefix(0, raw, len(PROMPT))
    assert plain.load_prefix(1, roped, len(PROMPT))


@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_is_a_copy(paged):
    """A snapshot taken at release keeps its rows while the slot is
    reused before the writer packs it (a view would show the new
    prompt's rows)."""
    r = _mk(paged)
    s = r.acquire_slot()
    r.admit(s, PROMPT, temperature=0.0)
    for _ in range(3):
        r.step()
    want = {k: np.array(v) for k, v in
            r.export_prefix(s, len(PROMPT)).items()}
    snap = r.snapshot_prefix(s, len(PROMPT))
    r.release(s)
    s2 = r.acquire_slot(s)
    assert s2 == s
    r.admit(s2, list(b"an unrelated prompt that overwrites the rows"),
            temperature=0.0)
    for _ in range(3):
        r.step()
    got = r.pack_prefix(snap)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def _jax_sched(cache, kv):
    cfg_j, params_j, _, _ = _model("small")
    runner = JaxRunner(cfg_j, params_j, num_slots=2, max_ctx=128,
                       prefill_buckets=[32, 64], kv_dtype=kv)
    return JaxScheduler(runner, JaxBytes(), multi_step=4, prompt_cache=cache)


def _jax_run(sched, n=8):
    try:
        return sched.generate(JaxRequest(prompt=list(PROMPT),
                                         max_new_tokens=n, temperature=0.0,
                                         ignore_eos=True),
                              timeout=120).token_ids
    finally:
        sched.shutdown()


@pytest.mark.parametrize("layout,kv", [("contiguous", "float32"),
                                       ("paged", "float32"),
                                       ("contiguous", "int8"),
                                       ("paged", "int8")])
def test_directory_is_shared_with_the_jax_package(tmp_path, layout, kv):
    """A directory written by the JAX package's scheduler is served by the
    port (a hit, the greedy tokens of the JAX cold serve), and one
    written by the port is served by the JAX package alike."""
    paged = layout == "paged"
    jdir, tdir = tmp_path / "from-jax", tmp_path / "from-port"
    jcache = JaxCache(jdir)
    cold = _jax_run(_jax_sched(jcache, kv))
    assert jcache.stores == 1
    tcache = PromptKVCache(jdir)
    s = _sched(tcache, paged, kv)
    assert _run(s) == cold
    assert tcache.hits == 1 and s.runner.total_prefix_reused > 0

    tcache = PromptKVCache(tdir)
    assert _run(_sched(tcache, paged, kv)) == cold
    assert tcache.stores == 1
    assert sorted(p.name for p in tdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())
    jcache = JaxCache(tdir)
    js = _jax_sched(jcache, kv)
    assert _jax_run(js) == cold
    assert jcache.hits == 1 and js.runner.total_prefix_reused > 0
