"""Speculative decoding of the PyTorch port against the JAX package.

The port's spec lane (n-gram and draft-model drafters, the verify forward
and its accept scan, the allocator's speculation reservation, the
scheduler's window lane) gets the same seed-made weights as the JAX
package (``debug:tiny`` / ``debug:small`` in float32, carried across with
``params_from_numpy``) and the same prompts, on the CPU. Greedy tokens
with speculation on must equal the tokens with it off and the JAX
package's, byte for byte; the accept scan's emitted rows must equal the
JAX scan's on the same logits and proposals; a seeded stream with
speculation must equal the port's own seeded stream without it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.engine.speculative import SpecDecoder as JaxSpecDecoder  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.spec import NGramDrafter as JaxNGram  # noqa: E402
from localai_tpu.spec import SpecEngine as JaxSpecEngine  # noqa: E402
from localai_tpu_torch.engine.paged import BlockAllocator  # noqa: E402
from localai_tpu_torch.engine.runner import (  # noqa: E402
    NAN_TOKEN,
    SKIP,
    ModelRunner,
)
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.engine.speculative import SpecDecoder  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from localai_tpu_torch.spec import (  # noqa: E402
    ModelDrafter,
    NGramDrafter,
    SpecEngine,
    build_spec_engine,
)
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

REPEAT = list(b"abcabcabcabcabcabc")
RUNNER_KW = dict(num_slots=2, max_ctx=128, prefill_buckets=[32],
                 kv_dtype="float32")
_MODELS: dict = {}


def _model(preset, weights=""):
    """(JAX cfg, JAX params, port cfg, port params) of a float32 preset
    made from jax.random.key(0), its weights quantized by each package
    when ``weights`` is int8/int4."""
    key = (preset, weights)
    if key not in _MODELS:
        if (preset, "") not in _MODELS:
            cfg_j = dataclasses.replace(J_PRESETS[preset], dtype="float32")
            params_j = jl.init_params(jax.random.key(0), cfg_j)
            cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
            params_t = tl.params_from_numpy(
                jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
            _MODELS[preset, ""] = (cfg_j, params_j, cfg_t, params_t)
        cfg_j, params_j, cfg_t, params_t = _MODELS[preset, ""]
        if weights:
            _MODELS[key] = (cfg_j, jq.quantize_params(params_j, weights),
                            cfg_t, tq.quantize_params(params_t, weights,
                                                      device="cpu"))
    return _MODELS[key]


def _port(preset, weights="", *, paged=True, **kw):
    _, _, cfg_t, params_t = _model(preset, weights)
    kw = {**RUNNER_KW, **kw}
    if paged:
        kw.setdefault("kv_block_tokens", 16)
    return ModelRunner(cfg_t, params_t, paged=paged, device="cpu", **kw)


def _jax(preset, weights="", *, paged=True, **kw):
    cfg_j, params_j, _, _ = _model(preset, weights)
    kw = {**RUNNER_KW, **kw}
    if paged:
        kw.setdefault("kv_block_tokens", 16)
    return JaxRunner(cfg_j, params_j, paged=paged, attn_impl="xla", **kw)


def _plain_tokens(runner, prompt, n, **sampling):
    sampling.setdefault("temperature", 0.0)
    s = runner.acquire_slot()
    out = [runner.admit(s, prompt, **sampling)]
    for _ in range(n):
        out.append(int(runner.step()[s]))
    return out


def _spec_tokens(eng, prompt, n, max_windows=60, **sampling):
    """Drive an engine as the scheduler does: a window when the drafter
    proposes, a plain decode step when it declines."""
    sampling.setdefault("temperature", 0.0)
    slot = eng.acquire_slot()
    out = [eng.admit(slot, prompt, **sampling)]
    windows = 0
    while len(out) <= n and windows < max_windows:
        windows += 1
        rows = eng.step_spec_async()
        if rows is None:  # declined: plain fallback
            tok = int(eng.target.step()[slot])
            out.append(tok)
            eng.drafter.observe(slot, [tok])
            continue
        host = np.asarray(rows)
        eng.observe_window(host)
        out.extend(int(x) for x in host[:, slot] if x != SKIP)
    return out[:n + 1]


class PlannedDrafter:
    """Deterministic drafter: proposes scripted windows for slot 0 (the
    JAX package's test drafter, on the port's protocol)."""

    name = "planned"
    device_proposals = False

    def __init__(self, num_slots, gamma, windows):
        self.num_slots = num_slots
        self.gamma = gamma
        self.windows = list(windows)

    def propose(self, tokens, positions):
        if not self.windows:
            return None
        props = np.zeros((self.num_slots, self.gamma), np.int32)
        props[0] = self.windows.pop(0)
        return props

    def admit(self, slot, prompt, first, positions):
        pass

    def observe(self, slot, emitted):
        pass

    def resync(self, slot, resident, positions):
        pass

    def release(self, slot):
        pass

    def reinit(self):
        self.windows.clear()

    def stats(self):
        return {"drafter": self.name}


# ---------------------------------------------------------------------------
# the n-gram drafter (host numpy on both packages)
# ---------------------------------------------------------------------------


def _ngram_lookup(cls):
    d = cls(num_slots=2, gamma=3)
    d.admit(0, [1, 2, 3, 4, 1, 2], 3, None)
    props = d.propose(None, None)
    return props.tolist(), d.last_hits.tolist()


def _ngram_decline(cls):
    d = cls(num_slots=1, gamma=3)
    d.admit(0, [5, 9, 2, 7], 11, None)
    return d.propose(None, None), d.stats()["lookup_misses"]


def _ngram_resync(cls):
    d = cls(num_slots=1, gamma=2)
    d.admit(0, [1, 2], 3, None)
    d.resync(0, [7, 8, 7, 8], None)
    props = d.propose(None, None).tolist()
    d.release(0)
    return props, d.propose(None, None)


@pytest.mark.parametrize("case", [_ngram_lookup, _ngram_decline,
                                  _ngram_resync])
def test_ngram_lookup_decline_and_resync_match_jax(case):
    """The lookup proposes the trigram's continuation ([4, 1, 2]) with a
    zero filler row for a slot without history; a history with no
    repeated n-gram declines; a resync replaces the history and a release
    drops it."""
    got = case(NGramDrafter)
    assert got == case(JaxNGram)
    if case is _ngram_lookup:
        assert got == ([[4, 1, 2], [0, 0, 0]], [True, False])
    elif case is _ngram_decline:
        assert got[0] is None and got[1] > 0
    else:
        assert got[0][0][0] == 7 and got[1] is None


def test_ngram_has_candidate_matches_propose():
    """The scheduler's pre-gate peeks at resident records with the same
    lookup a resync + propose would run."""
    d = NGramDrafter(num_slots=2, gamma=3)
    assert d.has_candidate({0: [1, 2, 3, 1, 2], 1: None})
    assert not d.has_candidate({0: [5, 9, 2, 7], 1: []})
    j = JaxNGram(num_slots=2, gamma=3)
    assert j.has_candidate({0: [1, 2, 3, 1, 2], 1: None})


# ---------------------------------------------------------------------------
# the accept scan
# ---------------------------------------------------------------------------


def _scan_inputs(seed=3, S=4, T=5, V=512):
    """Logits [S, T, V] and proposals [S, T-1] where slot 0 matches the
    greedy choice throughout (full accept + bonus), slot 1 matches two
    positions then misses (partial accept), slot 2 misses at once, slot 3
    stays inactive; one non-finite row ends slot 1's window early when
    ``nan`` is set."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(S, T, V)).astype(np.float32)
    greedy = logits.argmax(-1).astype(np.int32)
    props = greedy[:, :T - 1].copy()
    props[1, 2] = (props[1, 2] + 1) % V
    props[2, 0] = (props[2, 0] + 7) % V
    return logits, props


@pytest.mark.parametrize("nan", [False, True])
def test_accept_scan_rows_match_jax(nan):
    logits, props = _scan_inputs()
    if nan:
        logits[1, 1, 11] = np.nan
    jr = _jax("tiny", num_slots=4)
    tr = _port("tiny", num_slots=4)
    for r in (jr, tr):
        for p in (REPEAT, list(b"hello"), list(b"xyz")):
            r.admit(r.acquire_slot(), p, temperature=0.0)
    pos0 = tr.slot_positions().copy()
    assert (pos0 == np.asarray(jr.slot_positions())).all()
    jstate, jrows = jr._accept_scan(jr.state, jnp.asarray(logits),
                                    jnp.asarray(props))
    trows = tr._accept_scan(torch.from_numpy(logits),
                            torch.from_numpy(props))
    trows = trows.numpy()
    assert (trows == np.asarray(jrows)).all()
    n = (trows >= 0).sum(axis=0)
    assert n[3] == 0 and (trows[:, 3] == SKIP).all()   # inactive slot
    assert n[0] == 5 and n[2] == 1
    if nan:
        assert trows[1, 1] == NAN_TOKEN and (trows[2:, 1] == SKIP).all()
    else:
        assert n[1] == 3 and (trows[3:, 1] == SKIP).all()
    assert (tr.state.positions.numpy() == np.asarray(jstate.positions)).all()
    assert (tr.state.tokens.numpy() == np.asarray(jstate.tokens)).all()
    assert (tr.state.counts.numpy() == np.asarray(jstate.counts)).all()
    # positions advance by the emitted count (NAN_TOKEN included, as in
    # the JAX package: the scheduler fails that slot's request)
    emitted = (trows != SKIP).sum(axis=0)
    assert (tr.slot_positions() == pos0 + emitted).all()


def _planned_windows(ref, v):
    return [
        [(ref[1] + 1) % v] * 3,             # all wrong: emit 1
        [ref[2], (ref[3] + 1) % v, 0],      # 1 accepted + correction
        [ref[4], ref[5], (ref[6] + 1) % v],  # 2 accepted + correction
    ]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_rollback_after_partial_accept_block_accounting(pkg):
    """Scripted windows (full reject, then partial accepts): the emitted
    stream equals plain decode and the JAX package's, the frontier moves
    by exactly the emitted count, and the speculation reservation
    conserves blocks throughout and after release."""
    mk = _port if pkg == "port" else _jax
    ref = _plain_tokens(mk("tiny"), REPEAT, 8)
    assert ref == _plain_tokens(_jax("tiny"), REPEAT, 8)
    target = mk("tiny")
    v = target.cfg.vocab_size
    eng_cls = SpecEngine if pkg == "port" else JaxSpecEngine
    eng = eng_cls(target, PlannedDrafter(2, 3, _planned_windows(ref, v)),
                  gamma=3)
    slot = eng.acquire_slot()
    out = [eng.admit(slot, REPEAT, temperature=0.0,
                     reserve_tokens=len(REPEAT) + 32)]
    p0 = len(REPEAT)
    for want in (1, 2, 3):
        rows = eng.step_spec()
        col = rows[:, slot]
        assert int((col != SKIP).sum()) == want
        out.extend(int(x) for x in col[col != SKIP])
        p0 += want
        assert eng.slot_position(slot) == p0
        assert not target.allocator.check_invariants()
    assert out == ref[:len(out)]
    eng.release(slot)
    st = target.allocator.stats()
    assert st.free + st.cached == st.total
    assert st.spec_reserved == 0
    assert eng.total_accepted == 3 and eng.total_emitted == 6


# ---------------------------------------------------------------------------
# greedy parity: spec on == spec off == the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
def test_paged_ngram_greedy_matches_plain_and_jax(kv):
    ref = _plain_tokens(_port("tiny", kv_dtype=kv), REPEAT, 24)
    eng = SpecEngine(_port("tiny", kv_dtype=kv), NGramDrafter(2, gamma=4),
                     gamma=4)
    got = _spec_tokens(eng, REPEAT, 24)
    assert got == ref
    jeng = JaxSpecEngine(_jax("tiny", kv_dtype=kv), JaxNGram(2, gamma=4),
                         gamma=4)
    assert _spec_tokens(jeng, REPEAT, 24) == got
    assert eng.target.verify_windows == eng.total_windows > 0
    assert eng.total_accepted > 0 and eng.tokens_per_dispatch > 1.0
    assert eng.stats()["windows"] == jeng.stats()["windows"]
    assert eng.total_accepted == jeng.total_accepted
    assert not eng.target.allocator.check_invariants()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_verify_windows_match_plain_and_jax(mode):
    """int8 / int4 weights over the same pool kind (debug:small's widths
    make every verify projection and the lm_head eligible for the w8/w4
    wrappers at M = 2 slots x 5 rows, which take their plain versions on
    the CPU). A bias on three ids makes the stream repeat, so the lookup
    hits."""
    bias = np.zeros(512, np.float32)
    bias[[97, 98, 99]] = 30.0
    ref = _plain_tokens(_port("small", mode, kv_dtype=mode), REPEAT, 20,
                        bias_row=bias)
    target = _port("small", mode, kv_dtype=mode)
    eng = SpecEngine(target, NGramDrafter(2, gamma=4), gamma=4)
    got = _spec_tokens(eng, REPEAT, 20, bias_row=bias)
    assert got == ref
    jeng = JaxSpecEngine(_jax("small", mode, kv_dtype=mode),
                         JaxNGram(2, gamma=4), gamma=4)
    assert _spec_tokens(jeng, REPEAT, 20, bias_row=bias) == got
    assert eng.total_windows > 0 and eng.total_accepted > 0
    layers = target.params["layers"]
    w = layers["wq" if mode == "int8" else "w_up"]
    lead = (2 * 5, target.cfg.hidden_size)
    if mode == "int8":
        assert tqm.eligible(lead, w.q[0], w.scale[0], transpose_w=False)
    else:
        assert tqm.w4_eligible(lead, w.q[0], w.scale[0])


def test_seeded_stream_with_spec_equals_without():
    """Sampling at temperature 0.7 with a seed: a self-drafting model
    drafter (draft = target weights) gets most windows partly accepted,
    and each slot's generator advances once per emitted token, so the
    stream is the port's seeded stream without speculation."""
    sampling = dict(temperature=0.7, top_k=40, seed=1234)
    ref = _plain_tokens(_port("tiny"), REPEAT, 30, **sampling)
    eng = SpecEngine(_port("tiny"),
                     ModelDrafter(_port("tiny", paged=False), gamma=3),
                     gamma=3)
    got = _spec_tokens(eng, REPEAT, 30, **sampling)
    assert got == ref
    assert eng.total_accepted > 0
    assert eng.total_accepted < eng.total_proposed  # some rejections


@pytest.mark.parametrize("paged", [True, False])
def test_model_drafter_equals_plain_on_both_packages(paged):
    """debug:small target, debug:tiny draft (different weights: imperfect
    proposals), through the historical SpecDecoder shim: emitted tokens
    come from the target's sampler on both packages."""
    ref = _plain_tokens(_port("small", paged=paged), REPEAT, 16)
    spec = SpecDecoder(_port("small", paged=paged),
                       _port("tiny", paged=False), gamma=3)
    got = _spec_tokens(spec, REPEAT, 16)
    assert got == ref
    jspec = JaxSpecDecoder(_jax("small", paged=paged),
                           _jax("tiny", paged=False), gamma=3)
    assert _spec_tokens(jspec, REPEAT, 16) == got
    assert spec.total_windows == spec.draft.decode_steps // 4 > 0
    assert spec.draft.fresh_prefills >= 1
    if paged:
        assert not spec.target.allocator.check_invariants()


def test_spec_decoder_refuses_a_bad_pair():
    with pytest.raises(ValueError, match="vocab"):
        bad = dataclasses.replace(_model("tiny")[2], vocab_size=256)
        SpecDecoder(_port("tiny"),
                    ModelRunner(bad, None, paged=False, device="cpu",
                                **RUNNER_KW), gamma=2)
    with pytest.raises(ValueError, match="contiguous"):
        SpecDecoder(_port("tiny"), _port("tiny"), gamma=2)


# ---------------------------------------------------------------------------
# block accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_spec_reservation_accounting(pkg):
    """begin_admit(spec_tokens=) records speculation blocks apart and
    check_invariants audits them on both packages."""
    r = _port("tiny") if pkg == "port" else _jax("tiny")
    adm = r.begin_admit(0, list(range(1, 20)), reserve_tokens=33,
                        spec_tokens=16, temperature=0.0)
    while adm.step_chunk() is None:
        pass
    alloc = r.allocator
    # 33 base rows → 3 blocks of 16; +16 spec rows → 1 more block
    assert alloc.spec_blocks[0] == 1
    assert alloc.stats().spec_reserved == 1
    assert not alloc.check_invariants()
    alloc.spec_blocks[0] = len(alloc.tables[0]) + 7
    assert any("speculation" in p for p in alloc.check_invariants())
    alloc.spec_blocks[0] = 1
    r.release(0)
    assert alloc.stats().spec_reserved == 0
    assert not alloc.check_invariants()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pool_exhaustion_with_spec_reservation(pkg):
    """Remaining blocks that cover the base reservation but not base +
    lookahead hold the admission (None, no leak); without the lookahead
    it fits; a reservation that can never fit raises."""
    mk = _port if pkg == "port" else _jax
    r = mk("tiny", kv_num_blocks=10)           # 9 allocatable blocks
    adm = r.begin_admit(0, list(range(1, 30)), reserve_tokens=65,
                        spec_tokens=16, temperature=0.0)
    while adm.step_chunk() is None:
        pass
    assert r.allocator.stats().spec_reserved == 1
    p2 = list(range(100, 129))
    assert r.begin_admit(1, p2, reserve_tokens=33, spec_tokens=16,
                         temperature=0.0) is None
    assert 1 not in r.allocator.tables
    assert r.begin_admit(1, p2, reserve_tokens=33,
                         temperature=0.0) is not None
    r.release(1)
    r.release(0)
    st = r.allocator.stats()
    assert st.free + st.cached == st.total and st.spec_reserved == 0
    assert not r.allocator.check_invariants()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_reservation_that_can_never_fit_raises(pkg):
    """Base + lookahead beyond the whole pool raises at admission (holding
    it would block the queue forever); the base alone is admitted."""
    r = (_port if pkg == "port" else _jax)("tiny", kv_num_blocks=6)
    with pytest.raises(ValueError, match="exceeds the block pool"):
        r.begin_admit(0, REPEAT, reserve_tokens=65, spec_tokens=16,
                      temperature=0.0)
    assert 0 not in r.allocator.tables
    assert r.begin_admit(0, REPEAT, reserve_tokens=65,
                         temperature=0.0) is not None


def test_spec_tokens_are_clamped_to_the_context():
    """The lookahead never reserves rows past max_ctx."""
    r = _port("tiny")
    adm = r.begin_admit(0, REPEAT, reserve_tokens=128, spec_tokens=16,
                        temperature=0.0)
    assert adm is not None
    assert len(r.allocator.tables[0]) == 8
    assert 0 not in r.allocator.spec_blocks


def test_extend_spec_accounting_matches_jax():
    from localai_tpu.engine.paged import BlockAllocator as JaxAllocator

    def run(cls):
        alloc = cls(num_blocks=10, block_tokens=16, max_blocks_per_seq=8)
        out = [alloc.allocate(0, 33), alloc.extend(0, 33, spec_tokens=16),
               dict(alloc.spec_blocks), alloc.check_invariants()]
        out += [alloc.extend(0, 17, spec_tokens=16), dict(alloc.spec_blocks),
                alloc.allocate(1, 65), alloc.extend(0, 129, spec_tokens=16),
                dict(alloc.spec_blocks), alloc.stats().spec_reserved,
                alloc.check_invariants()]
        return out

    got = run(BlockAllocator)
    assert got == run(JaxAllocator)
    assert got == [0, True, {0: 1}, [], True, {}, 0, False, {}, 0, []]


def test_verify_rows_past_the_context_go_to_the_trash_block():
    """A window at the context edge (max_ctx 32 = two 16-row blocks)
    writes its rows past max_ctx into the trash block: clamped to the
    last block they would land on the slot's own rows 16..21."""
    from localai_tpu_torch.ops.attention import gather_blocks

    r = _port("tiny", max_ctx=32)
    slot = r.acquire_slot()
    r.admit(slot, list(range(1, 31)), temperature=0.0)   # frontier 30
    table = torch.tensor([r.allocator.tables[slot]], dtype=torch.long)

    def rows():  # [L, H, 32, hd]: the slot's logical rows
        return torch.stack([gather_blocks(r.kv.k[i], table)[0]
                            for i in range(r.cfg.num_layers)])

    before = rows()
    np.asarray(r.verify_async(np.full((2, 7), 5, np.int32)))  # rows 30..37
    after = rows()
    assert torch.equal(after[:, :, :30], before[:, :, :30])
    assert not torch.equal(after[:, :, 30:], before[:, :, 30:])
    assert r.slot_position(slot) == 31          # capped at max_ctx - 1
    assert not r.allocator.check_invariants()


# ---------------------------------------------------------------------------
# the NaN guard inside a window
# ---------------------------------------------------------------------------


def test_nan_guard_ends_only_its_own_slots_window():
    """A non-finite logits row emits NAN_TOKEN and ends its slot's window;
    the other slot's window is untouched and sentinels never count as
    emitted tokens."""
    target = _port("tiny")
    eng = SpecEngine(target, PlannedDrafter(2, 3, [[1, 2, 3]]), gamma=3)
    a, b = eng.acquire_slot(), eng.acquire_slot()
    eng.admit(a, REPEAT, temperature=0.0)
    eng.admit(b, REPEAT, temperature=0.0)
    eng.set_bias(a, np.full(target.cfg.vocab_size, np.nan, np.float32))
    rows = eng.step_spec()
    assert rows[0, a] == NAN_TOKEN and (rows[1:, a] < 0).all()
    assert (rows[:, b] >= 0).sum() >= 1 and NAN_TOKEN not in rows[:, b]
    assert eng.total_emitted == int((rows[:, b] >= 0).sum())


def test_scheduler_nan_in_a_window_fails_only_its_request():
    tok = ByteTokenizer()
    target = _port("tiny")
    sched = Scheduler(target, tok, multi_step=4,
                      spec=SpecEngine(target, NGramDrafter(2, gamma=4)))
    try:
        good = sched.submit(GenRequest(prompt=REPEAT, max_new_tokens=24,
                                       temperature=0.0,
                                       logit_bias={97: 1e4}))
        bad = sched.submit(GenRequest(prompt=REPEAT, max_new_tokens=24,
                                      temperature=0.0,
                                      logit_bias={97: 1e4, 5: np.nan}))
        assert bad.result(120).finish_reason == "error"
        assert good.result(120).finish_reason == "length"
        assert good.token_ids == [97] * 24
        assert sched.metrics()["spec_windows"] > 0
        assert not target.allocator.check_invariants()
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# the scheduler lane
# ---------------------------------------------------------------------------

# a huge bias on one id forces a cycle at once, so the n-gram lookup hits
CYCLIC = dict(logit_bias={97: 1e4}, max_new_tokens=24, temperature=0.0)


def test_scheduler_spec_lane_matches_plain_and_jax():
    tok = ByteTokenizer()
    req = dict(prompt=REPEAT, max_new_tokens=24, temperature=0.0)
    plain = Scheduler(_port("tiny"), tok, multi_step=4)
    try:
        ref = plain.generate(GenRequest(**req), timeout=120)
        ref_cyc = plain.generate(GenRequest(prompt=REPEAT, **CYCLIC),
                                 timeout=120)
        assert "spec_windows" not in plain.metrics()
    finally:
        plain.shutdown()
    target = _port("tiny")
    sched = Scheduler(target, tok, multi_step=4,
                      spec=SpecEngine(target, NGramDrafter(2, gamma=4),
                                      gamma=4))
    try:
        got = sched.generate(GenRequest(**req), timeout=120)
        assert got.token_ids == ref.token_ids and got.text == ref.text
        got_cyc = sched.generate(GenRequest(prompt=REPEAT, **CYCLIC),
                                 timeout=120)
        assert got_cyc.token_ids == ref_cyc.token_ids
        m = sched.metrics()
        assert m["spec_windows"] > 0
        assert m["spec_draft_tokens"] > 0
        assert m["spec_accepted_tokens"] > 0
        assert m["spec_accept_rate"] > 0.0
        assert m["spec_tokens_per_dispatch"] > 1.0
        assert m["spec_drafter"] == "ngram" and m["spec_gamma"] == 4
        assert m["spec_suppressed"] == 0
        assert m["kv_blocks_spec_reserved"] == 0
        assert target.verify_windows == m["spec_windows"]
        assert not target.allocator.check_invariants()
    finally:
        sched.shutdown()
    from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer

    jt = _jax("tiny")
    jsched = JaxScheduler(jt, JaxByteTokenizer(), multi_step=4,
                          spec=JaxSpecEngine(jt, JaxNGram(2, gamma=4),
                                             gamma=4))
    try:
        want = jsched.generate(JaxGenRequest(prompt=REPEAT, **CYCLIC,
                                             ignore_eos=True), timeout=120)
        assert want.token_ids == got_cyc.token_ids
    finally:
        jsched.shutdown()


def test_scheduler_model_drafter_on_a_contiguous_engine():
    """A contiguous target with a draft model (the shim's shape): the
    windows run, drafts resync after plain dispatches, the stream equals
    plain contiguous decode."""
    tok = ByteTokenizer()
    req = dict(prompt=list(b"speculation target"), max_new_tokens=20,
               temperature=0.0)
    plain = Scheduler(_port("small", paged=False), tok, multi_step=4)
    try:
        ref = plain.generate(GenRequest(**req), timeout=120)
    finally:
        plain.shutdown()
    spec = SpecDecoder(_port("small", paged=False),
                       _port("small", paged=False), gamma=3)
    sched = Scheduler(spec.target, tok, multi_step=4, spec=spec)
    try:
        got = sched.generate(GenRequest(**req), timeout=120)
        assert got.token_ids == ref.token_ids
        m = sched.metrics()
        assert m["spec_windows"] > 0 and m["spec_drafter"] == "model"
        assert m["spec_accepted_tokens"] > 0
    finally:
        sched.shutdown()


def test_acceptance_backoff_suppresses_windows():
    """A drafter whose proposals are never accepted trips the acceptance
    floor: windows pause for the cooldown, and the stream stays the plain
    greedy stream."""

    class AlwaysWrong(PlannedDrafter):
        def propose(self, tokens, positions):
            return np.full((self.num_slots, self.gamma), 511, np.int32)

    target = _port("tiny")
    eng = SpecEngine(target, AlwaysWrong(2, 3, []), gamma=3,
                     min_accept=0.5, cooldown=10)
    slot = eng.acquire_slot()
    out = [eng.admit(slot, REPEAT, temperature=0.0)]
    suppressed = 0
    for _ in range(40):
        rows = eng.step_spec_async()
        if rows is None:
            suppressed += 1
            out.append(int(target.step()[slot]))
            continue
        host = np.asarray(rows)
        eng.observe_window(host)
        out.extend(int(x) for x in host[:, slot] if x != SKIP)
    assert eng.total_suppressed == suppressed > 0
    assert out == _plain_tokens(_port("tiny"), REPEAT, len(out) - 1)


def test_build_spec_engine_knobs(monkeypatch):
    monkeypatch.setenv("LOCALAI_SPEC_GAMMA", "6")
    monkeypatch.setenv("LOCALAI_SPEC_NGRAM_MAX", "3")
    eng = build_spec_engine(_port("tiny"), drafter="ngram")
    assert eng.gamma == 6 and eng.drafter.name == "ngram"
    assert eng.drafter.max_n == 3 and eng.drafter.min_n == 2
    assert build_spec_engine(_port("tiny"), gamma=2).gamma == 2
    with pytest.raises(ValueError, match="draft_model"):
        build_spec_engine(_port("tiny"), drafter="model")
    with pytest.raises(ValueError, match="unknown drafter"):
        build_spec_engine(_port("tiny"), drafter="bogus")
    eng = build_spec_engine(_port("tiny", kv_dtype="int4"),
                            draft_ref="debug:tiny", gamma=3)
    r = eng.drafter.runner
    assert eng.drafter.name == "model" and not r.paged
    assert r.kv_dtype == "int8" and r.device.type == "cpu"
