"""The host KV tier of the PyTorch port against the JAX package, on the CPU.

The port's paged runner reads ``LOCALAI_KV_TIER_MB`` at every init and
reinit, as the JAX package's does, and attaches a host tier under the
prefix pool (``fleet.kveconomy.tiering``). Held here:

  * ``HostTier`` alike: hypothesis-drawn put / take / discard sequences
    give equal results and ``stats()`` on both packages;
  * the allocator with its tier: hypothesis-drawn allocate / register /
    release / match sequences give equal shared counts, tables, spills,
    reloads, ``tier_stats()`` and clean invariants on both packages, and
    the tier-residency audit flags the same violations;
  * ``pack_block`` / ``load_block`` round trips bit for bit on float32,
    bfloat16, int8 and int4 pools, with payload bytes equal to the JAX
    package's (bf16 2 B, int4 nibble-packed, scales f32);
  * a tiered paged runner (the variable set, nothing attached by hand)
    spills and reloads a prefix and decodes the same greedy ids as the
    tier-off runner and as the JAX package's tiered runner, with equal
    counters; ``reinit`` starts the tier cold;
  * ``Scheduler.metrics()`` has the JAX package's ``kv_tier_*`` keys and
    values on the same requests.

The debug preset's weights are drawn by ``jax.random.key(0)`` in float32
and carried across with ``models.llama.params_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.engine.paged import BlockAllocator as JaxAllocator  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.fleet.kveconomy import tiering as jtier  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.obs.engine import EngineTelemetry as JaxTelemetry  # noqa: E402
from localai_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402
from localai_tpu.obs.slo import SLOTracker as JaxSLO  # noqa: E402
from localai_tpu.obs.trace import TraceStore as JaxStore  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch.engine.paged import BlockAllocator  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.fleet.kveconomy import tiering  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.obs.engine import EngineTelemetry  # noqa: E402
from localai_tpu_torch.obs.metrics import Registry  # noqa: E402
from localai_tpu_torch.obs.slo import SLOTracker  # noqa: E402
from localai_tpu_torch.obs.trace import TraceStore  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TIERS = {"port": tiering, "jax": jtier}
ALLOCS = {"port": BlockAllocator, "jax": JaxAllocator}
_MODEL: dict = {}


def _model():
    """(JAX cfg, JAX params, port cfg, port params) of debug:tiny in
    float32, made from jax.random.key(0)."""
    if not _MODEL:
        cfg_j = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
        params_j = jl.init_params(jax.random.key(0), cfg_j)
        cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
        params_t = tl.params_from_numpy(
            jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
        _MODEL.update(j=(cfg_j, params_j), t=(cfg_t, params_t))
    return _MODEL


RUNNER_KW = dict(num_slots=2, max_ctx=96, prefill_buckets=[16, 32],
                 paged=True, kv_block_tokens=16, prefill_chunk=16,
                 kv_num_blocks=12)


def _runner(pkg: str, kv_dtype: str = "float32", **kw):
    kw = {**RUNNER_KW, "kv_dtype": kv_dtype, **kw}
    if pkg == "port":
        cfg, params = _model()["t"]
        return ModelRunner(cfg, params, device="cpu", **kw)
    cfg, params = _model()["j"]
    return JaxRunner(cfg, params, attn_impl="xla", **kw)


def _payload(n=64):
    a = np.arange(n, dtype=np.float32)
    return {"k": a, "v": a + 1.0}


# -- the host tier alone ---------------------------------------------------

_TIER_OPS = st.lists(st.tuples(st.sampled_from(["put", "take", "discard"]),
                               st.sampled_from("abcdef"),
                               st.integers(1, 40)),
                     min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_TIER_OPS, budget=st.sampled_from([100, 400, 1000]))
def test_host_tier_equals_the_jax_package(ops, budget):
    """Put / take / discard with the LRU byte budget, oversize rejects and
    budget drops: the same answers and stats on both packages."""
    tiers = {p: m.HostTier(budget) for p, m in TIERS.items()}
    for op, key, n in ops:
        got = {}
        for p, tier in tiers.items():
            if op == "put":
                got[p] = tier.put(key, _payload(n))
            elif op == "take":
                hit = tier.take(key)
                got[p] = None if hit is None else hit["k"].tolist()
            else:
                got[p] = tier.discard(key)
        assert got["port"] == got["jax"], (op, key, n)
        assert tiers["port"].stats() == tiers["jax"].stats()
        assert tiers["port"].keys() == tiers["jax"].keys()


@pytest.mark.parametrize("raw,budget", [
    (None, None), ("", None), ("0", None), ("2", 2 << 20), ("0.5", 1 << 19),
    ("not-a-number", None), ("-3", None)])
def test_tier_from_env_reads_the_variable_alike(monkeypatch, raw, budget):
    if raw is None:
        monkeypatch.delenv("LOCALAI_KV_TIER_MB", raising=False)
    else:
        monkeypatch.setenv("LOCALAI_KV_TIER_MB", raw)
    for m in TIERS.values():
        t = m.tier_from_env()
        assert (None if t is None else t.budget_bytes) == budget
    with pytest.raises(ValueError):
        tiering.HostTier(0)


def test_payload_bytes_count_numpy_and_torch_alike():
    a = np.zeros((2, 3, 4), np.float32)
    t = torch.zeros((2, 3, 4), dtype=torch.bfloat16)
    assert tiering.payload_nbytes({"k": a, "v": t}) == 96 + 48
    assert jtier.payload_nbytes({"k": a}) == 96


# -- the allocator with its tier -------------------------------------------

_FAMILIES = [[(f * 31 + i) % 251 for i in range(80)] for f in range(5)]


def _fake_callbacks(log: list):
    """pack: a payload naming the block; load: records what it got."""
    def pack(bid):
        return {"k": np.full((2, 3), bid, np.float32),
                "v": np.full((2, 3), -bid, np.float32)}

    def load(bid, payload):
        log.append((int(bid), float(payload["k"][0, 0])))
    return pack, load


_ALLOC_OPS = st.lists(
    st.tuples(st.sampled_from(["alloc", "release", "match"]),
              st.integers(0, 3),                 # seq
              st.integers(0, len(_FAMILIES) - 1),  # prompt family
              st.integers(17, 80)),              # prompt length
    min_size=1, max_size=30)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=_ALLOC_OPS, budget=st.sampled_from([48, 100, 400, 4096]))
def test_allocator_with_tier_equals_the_jax_package(ops, budget):
    """Pool pressure evicts prefix blocks into the tier, chain walks
    re-onboard them: shared counts, tables, spills, reloads, the loaded
    payloads, tier_stats() and the invariants equal the JAX package's."""
    state = {}
    for p in ("port", "jax"):
        alloc = ALLOCS[p](num_blocks=10, block_tokens=16,
                          max_blocks_per_seq=6)
        log: list = []
        pack, load = _fake_callbacks(log)
        alloc.attach_tier(TIERS[p].HostTier(budget), pack=pack, load=load)
        state[p] = (alloc, log)
    for op, seq, fam, n in ops:
        prompt = _FAMILIES[fam][:n]
        got = {}
        for p, (alloc, _) in state.items():
            if op == "alloc":
                if seq in alloc.tables:
                    alloc.release(seq)
                r = alloc.allocate(seq, n + 8, prompt=prompt)
                if r is not None:
                    alloc.register_prefix(seq, prompt)
                got[p] = r
            elif op == "release":
                got[p] = alloc.release(seq)
            else:
                got[p] = alloc.match_prefix(prompt)
        assert got["port"] == got["jax"], (op, seq, fam, n)
        a, b = state["port"][0], state["jax"][0]
        assert a.tables == b.tables
        assert (a.spills_total, a.reloads_total) == (b.spills_total,
                                                    b.reloads_total)
        assert a.tier_stats() == b.tier_stats()
        assert a.check_invariants() == b.check_invariants() == []
    assert state["port"][1] == state["jax"][1]


def test_tier_residency_audit_flags_alike():
    """A chain in the pool AND the tier, and a tier over its budget, are
    flagged with the JAX package's messages."""
    problems = {}
    for p in ("port", "jax"):
        alloc = ALLOCS[p](num_blocks=8, block_tokens=16,
                          max_blocks_per_seq=4)
        pack, load = _fake_callbacks([])
        tier = TIERS[p].HostTier(1 << 20)
        alloc.attach_tier(tier, pack=pack, load=load)
        prompt = _FAMILIES[0][:40]
        alloc.allocate(0, 48, prompt=prompt)
        alloc.register_prefix(0, prompt)
        assert alloc.check_invariants() == []
        key = next(iter(alloc._prefix))
        tier.put(key, _payload())
        out = alloc.check_invariants()
        tier.take(key)
        tier._bytes = tier.budget_bytes + 1
        out += alloc.check_invariants()
        tier._bytes = 0
        problems[p] = out
    assert problems["port"] == problems["jax"]
    assert any("AND spilled" in m for m in problems["port"])
    assert any("over budget" in m for m in problems["port"])


def test_allocator_without_tier_reports_none():
    alloc = BlockAllocator(num_blocks=4, block_tokens=16,
                           max_blocks_per_seq=2)
    assert alloc.tier_stats() is None
    assert (alloc.spills_total, alloc.reloads_total) == (0, 0)


# -- pack / load on the runner's pools -------------------------------------

def _fill(t: torch.Tensor, g: torch.Generator) -> None:
    """Random bits into a pool tensor, whatever its dtype."""
    if t.dtype == torch.float32:
        t.copy_(torch.randn(t.shape, generator=g))
    elif t.dtype == torch.bfloat16:
        t.copy_(torch.randn(t.shape, generator=g).to(torch.bfloat16))
    else:
        t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                              dtype=torch.int8))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_pack_load_round_trip_is_bit_exact(kv_dtype, monkeypatch):
    """pack_block → zero the block → load_block restores every byte of
    the block and touches no other; the payload keeps the pool dtype and
    its bytes equal the JAX package's pack_block of the same pool."""
    monkeypatch.delenv("LOCALAI_KV_TIER_MB", raising=False)
    r = _runner("port", kv_dtype)
    g = torch.Generator().manual_seed(7)
    pool = r._pool_tensors()
    for t in pool.values():
        _fill(t, g)
    before = {n: t.clone() for n, t in pool.items()}
    payload = r.pack_block(5).wait()
    assert set(payload) == set(pool)
    for n, t in pool.items():
        assert payload[n].dtype == t.dtype
        t[:, 5].zero_()
    r.load_block(5, payload)
    for n, t in pool.items():
        assert torch.equal(t.view(torch.uint8) if t.dtype != torch.float32
                           else t.view(torch.int32),
                           before[n].view(torch.uint8)
                           if t.dtype != torch.float32
                           else before[n].view(torch.int32)), n
    jr = _runner("jax", kv_dtype)
    assert tiering.payload_nbytes(payload) == jtier.payload_nbytes(
        jr.pack_block(5))


def test_load_block_refuses_a_payload_of_another_pool():
    """A payload of another shape or dtype is refused (the allocator then
    treats the spill as a miss and prefills)."""
    r = _runner("port", "float32")
    with pytest.raises(ValueError):
        r.load_block(2, {n: torch.zeros(3) for n in r._pool_tensors()})
    good = r.pack_block(2)
    with pytest.raises(ValueError):
        r.load_block(2, {n: a.to(torch.bfloat16) for n, a in good.items()})


# -- a tiered paged runner --------------------------------------------------

def _generate(r, prompt, steps=5):
    s = r.acquire_slot()
    out = [int(r.admit(s, list(prompt), temperature=0.0))]
    out += [int(r.step()[s]) for _ in range(steps)]
    r.release(s)
    return out


def _spill_and_reload(r):
    """The JAX package's spill → reload drill: a reference chain, cold
    fillers until it spills, the reference again. Returns (first, again,
    fillers run)."""
    prompt = list(b"spill me to host ram and bring me back intact")
    ref = _generate(r, prompt)
    filler = 0
    alloc = r.allocator
    while getattr(alloc, "spills_total", 0) < 1 and filler < 12:
        _generate(r, [60 + filler] * 33, steps=2)
        filler += 1
    return ref, _generate(r, prompt), filler


@pytest.mark.parametrize("kv_dtype", ["float32", "int4"])
def test_tiered_runner_reloads_and_decodes_as_the_jax_package(kv_dtype,
                                                              monkeypatch):
    """LOCALAI_KV_TIER_MB attaches the tier at init: the evicted
    reference chain spills, the next hit reloads it, and the greedy ids
    equal the first run, the tier-off runner's and the JAX package's
    tiered runner's, with equal spill / reload counts and tier stats."""
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    runs = {p: _spill_and_reload(_runner(p, kv_dtype)) for p in
            ("port", "jax")}
    monkeypatch.delenv("LOCALAI_KV_TIER_MB")
    plain = _runner("port", kv_dtype)
    off = _spill_and_reload(plain)
    assert plain.allocator.tier_stats() is None
    assert off == (runs["port"][0], runs["port"][0], 12)
    assert runs["port"][:2] == runs["jax"][:2]
    assert runs["port"][0] == runs["port"][1]


def test_tiered_runner_counters_equal_the_jax_package(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    runners = {p: _runner(p) for p in ("port", "jax")}
    for r in runners.values():
        _spill_and_reload(r)
    a, b = runners["port"].allocator, runners["jax"].allocator
    assert a.spills_total >= 1 and a.reloads_total >= 1
    assert a.tier_stats() == b.tier_stats()
    assert a.check_invariants() == b.check_invariants() == []
    # reinit rebuilds the allocator with a cold tier, as the JAX package's
    runners["port"].reinit()
    runners["jax"].reinit()
    a, b = runners["port"].allocator, runners["jax"].allocator
    assert a.tier_stats() == b.tier_stats()
    assert a.tier_stats()["entries"] == 0 and a.spills_total == 0


def test_contiguous_runner_attaches_no_tier(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    r = _runner("port", paged=False, kv_num_blocks=None)
    assert r.allocator is None and r.pack_block(1) is None


# -- the scheduler's kv_tier_* metrics ----------------------------------------

def _engine(pkg: str):
    if pkg == "port":
        reg = Registry()
        return Scheduler(
            _runner(pkg), ByteTokenizer(),
            telemetry=EngineTelemetry(model="t", registry=reg,
                                      store=TraceStore(),
                                      slo=SLOTracker(registry=reg,
                                                     targets={})))
    reg = JaxRegistry()
    return JaxScheduler(
        _runner(pkg), JaxByteTokenizer(),
        telemetry=JaxTelemetry(model="t", registry=reg, store=JaxStore(),
                               slo=JaxSLO(registry=reg, targets={})))


def test_scheduler_metrics_report_the_tier_as_the_jax_package(monkeypatch):
    monkeypatch.setenv("LOCALAI_KV_TIER_MB", "8")
    texts = ["spill me to host ram and bring me back intact"]
    texts += [chr(65 + i) * 33 for i in range(10)]
    texts += [texts[0]]
    got = {}
    for pkg, Req in (("port", GenRequest), ("jax", JaxGenRequest)):
        sched = _engine(pkg)
        try:
            ids = []
            for text in texts:
                h = sched.submit(Req(prompt=list(text.encode()),
                                     max_new_tokens=4, temperature=0.0))
                h.result(timeout=60)
                ids.append(list(h.token_ids))
            m = sched.metrics()
        finally:
            sched.shutdown()
        got[pkg] = (ids, {k: v for k, v in m.items()
                          if k.startswith("kv_tier_")})
    assert got["port"] == got["jax"]
    tier = got["port"][1]
    assert set(tier) == {"kv_tier_blocks", "kv_tier_bytes",
                         "kv_tier_budget_bytes", "kv_tier_spills",
                         "kv_tier_reloads"}
    assert tier["kv_tier_spills"] >= 1 and tier["kv_tier_reloads"] >= 1


def test_scheduler_without_tier_reports_no_tier_keys(monkeypatch):
    monkeypatch.delenv("LOCALAI_KV_TIER_MB", raising=False)
    sched = _engine("port")
    try:
        assert not [k for k in sched.metrics() if k.startswith("kv_tier_")]
    finally:
        sched.shutdown()
