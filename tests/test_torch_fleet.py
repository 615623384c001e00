"""In-process fleets of the PyTorch port against the JAX package's, on the
CPU.

  * ``affinity_key`` and the consistent-hash ring equal the JAX package's
    (hypothesis over prompts, block sizes and replica ids), and so do the
    router's placements and reasons over stub replicas (affinity,
    directory, least-loaded, failover, queue override, route-around);
  * the prefix chunk codec: bytes packed by either package assemble in
    the other (bf16 rows as their uint16 bits), and broken streams are
    refused alike; ``PrefixCache`` answers as the JAX package's;
  * the request options: ``PredictOptions`` carries the proto's fields,
    and ``predict_options`` / ``gen_request_from_options`` round trip as
    the JAX package's (a constraint crosses as its source regex);
  * two fleets (2 decode + 1 prefill replicas each), built by each
    package's manager through ``_load_fleet`` from one checkpoint, serve
    the same requests with byte-equal greedy texts and the same routed
    reasons for affinity, disaggregation, failover and migration, equal
    directory hits and drops, and ``/v1/fleet`` payloads with the same
    keys; the port's HTTP server answers ``/v1/fleet`` and the swap route.

The checkpoint is debug:tiny's weights written once in float32, so both
packages load the same ones.
"""

import gc
import json
import threading
import time
import urllib.request
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.config.app_config import AppConfig as JaxApp  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.fleet import prefix as jprefix  # noqa: E402
from localai_tpu.fleet import router as jrouter  # noqa: E402
from localai_tpu.fleet.kveconomy import PrefixDirectory as JaxDirectory  # noqa: E402
from localai_tpu.functions.constraint import constraint_for_regex as j_regex  # noqa: E402
from localai_tpu.models.manager import ModelManager as JaxManager  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu.worker import backend_pb2 as pb  # noqa: E402
from localai_tpu.worker import serving as jserving  # noqa: E402
from localai_tpu.worker.server import gen_request_from_options as j_from_opts  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.fleet import prefix  # noqa: E402
from localai_tpu_torch.fleet import router  # noqa: E402
from localai_tpu_torch.fleet.kveconomy import PrefixDirectory  # noqa: E402
from localai_tpu_torch.functions.constraint import constraint_for_regex  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from localai_tpu_torch.worker import serving  # noqa: E402
from localai_tpu_torch.worker.server import gen_request_from_options  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

WAIT = 120.0


# -- affinity keys and the ring ---------------------------------------------

@settings(max_examples=80, deadline=None)
@given(prompt=st.lists(st.integers(0, 200_000), max_size=300),
       bt=st.sampled_from([0, 8, 16, 64]),
       blocks=st.integers(1, 6))
def test_affinity_key_equals_the_jax_package(prompt, bt, blocks):
    assert router.affinity_key(prompt, block_tokens=bt, blocks=blocks) \
        == jrouter.affinity_key(prompt, block_tokens=bt, blocks=blocks)


@settings(max_examples=40, deadline=None)
@given(ids=st.lists(st.text("abcr/0123456789", min_size=1, max_size=8),
                    min_size=1, max_size=6, unique=True),
       key=st.integers(0, (1 << 64) - 1))
def test_ring_order_equals_the_jax_package(ids, key):
    assert router._Ring(ids).ordered(key) == jrouter._Ring(ids).ordered(key)


class _Stub:
    def __init__(self, rid, inflight=0, queue=0):
        self.id, self.role, self.state = rid, "decode", "healthy"
        self.inflight, self.queue_depth = inflight, queue

    @property
    def load(self):
        return (self.inflight, 0)


class _Pool:
    def __init__(self, reps):
        self.reps = reps

    def healthy(self, role="decode"):
        return [r for r in self.reps if r.state == "healthy"]


class _Slo:
    def __init__(self, shed):
        self.shed = shed

    def shedding(self, rid):
        return rid in self.shed


def _routes(mod, dirmod, shed, override, steps):
    """The reasons and targets of one routing script on one package."""
    reps = [_Stub(f"m/r{i}", inflight=i % 2, queue=3 * i) for i in range(4)]
    directory = dirmod()
    rt = mod.Router(_Pool(reps), _Slo(shed), block_tokens=16,
                    queue_override=override, directory=directory)
    out = []
    for prompt, exclude, failover, note in steps:
        try:
            r, reason = rt.route(prompt, exclude=set(exclude),
                                 failover=failover)
            out.append((r.id, reason))
            if note:
                directory.note(mod.affinity_key(prompt, block_tokens=16),
                               reps[(len(prompt) + 1) % 4].id)
        except mod.FleetUnavailable as e:
            out.append(("unavailable", str(e)))
    return out, rt.snapshot(), directory.stats()


@settings(max_examples=40, deadline=None)
@given(steps=st.lists(st.tuples(
    st.lists(st.integers(0, 50), max_size=80),
    st.lists(st.sampled_from(["m/r0", "m/r1", "m/r2", "m/r3"]), max_size=4),
    st.booleans(), st.booleans()), min_size=1, max_size=12),
    shed=st.sets(st.sampled_from(["m/r0", "m/r1", "m/r2", "m/r3"])),
    override=st.sampled_from([0, 2, 5]))
def test_router_places_as_the_jax_package(steps, shed, override):
    assert _routes(router, PrefixDirectory, shed, override, steps) == \
        _routes(jrouter, JaxDirectory, shed, override, steps)


# -- the chunk codec and the prefix cache -------------------------------------

def _arrays(n=24, bf16=False, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, 2, n, 8)).astype(np.float32)
    out = {"kv_dtype": np.asarray("bfloat16" if bf16 else "float32"),
           "kv_rope": np.asarray("roped")}
    if bf16:
        out["k"] = (k.view(np.uint32) >> 16).astype(np.uint16)
        out["v"] = out["k"][::-1].copy()
        out["k_bf16"] = out["v_bf16"] = np.asarray(1)
    else:
        out["k"], out["v"] = k, -k
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("chunk", [64, 1 << 20])
def test_chunks_cross_read_both_ways(bf16, chunk):
    toks = list(range(40))
    arrays = _arrays(bf16=bf16)
    for pack, assemble in ((prefix.pack_chunks, jprefix.assemble_chunks),
                           (jprefix.pack_chunks, prefix.assemble_chunks)):
        chunks = list(pack(toks, arrays, chunk_bytes=chunk,
                           transfer_id="t"))
        assert [c["seq"] for c in chunks] == list(range(len(chunks)))
        got_toks, got = assemble(iter(chunks))
        assert got_toks == toks and set(got) == set(arrays)
        for name, a in arrays.items():
            np.testing.assert_array_equal(got[name], a)
    mine = list(prefix.pack_chunks(toks, arrays, chunk_bytes=chunk,
                                   transfer_id="t"))
    theirs = list(jprefix.pack_chunks(toks, arrays, chunk_bytes=chunk,
                                      transfer_id="t"))
    assert mine == theirs


def _refusal(assemble, chunks):
    try:
        assemble(iter(chunks))
    except ValueError as e:
        return str(e).split(":")[0]
    return "accepted"


def test_broken_streams_are_refused_alike():
    good = list(prefix.pack_chunks([1, 2, 3], _arrays(), chunk_bytes=256))
    bad = {
        "empty": [],
        "unordered": good[1:] + good[:1],
        "truncated": good[:-1],
        "no identity": [{**good[0], "tokens": []}, *good[1:]],
        "corrupt": [{**c, "data": b"x" * len(c["data"])} for c in good],
    }
    for name, chunks in bad.items():
        assert _refusal(prefix.assemble_chunks, chunks) == \
            _refusal(jprefix.assemble_chunks, chunks) != "accepted", name


def _cache_script(mod):
    cache = mod.PrefixCache(max_entries=2, min_prefix=4, max_bytes=5000)
    out = []
    for toks, n in (([1, 2, 3, 4, 5, 6], 6), ([1, 2, 3, 9, 9, 9, 9], 7),
                    ([7] * 10, 10), ([1, 2, 3, 4, 5, 6, 7, 8], 2),
                    ([5] * 40, 40)):
        cache.store(toks, {"k": np.zeros((1, 1, n, 4), np.float32)})
        out.append(cache.stats())
    for prompt in ([1, 2, 3, 4, 5, 6, 0], [7] * 12, [5] * 41, [9, 9]):
        hit = cache.lookup(prompt)
        out.append(None if hit is None else (hit.tokens, hit.n))
    out.append(cache.wait_for([5] * 40, timeout=0.1) is not None)
    out.append(cache.wait_for([4, 4], timeout=0.05))
    out.append(cache.stats())
    return out


def test_prefix_cache_answers_as_the_jax_package():
    assert _cache_script(prefix) == _cache_script(jprefix)


def test_prefix_cache_fronts_a_disk_cache(tmp_path):
    from localai_tpu_torch.engine.promptcache import PromptKVCache

    disk = PromptKVCache(tmp_path / "pc", min_prefix=4)
    cache = prefix.PrefixCache(min_prefix=4, fallthrough=disk)
    cache.store(list(range(10)), {"k": np.zeros((1, 1, 10, 4), np.float32)})
    assert disk.stats()["stores"] == 1
    fresh = prefix.PrefixCache(min_prefix=4, fallthrough=disk)
    hit = fresh.lookup(list(range(12)))
    assert hit is not None and hit.n == 10


# -- request options ----------------------------------------------------------

def _opts_dict(o):
    if isinstance(o, serving.PredictOptions):
        import dataclasses

        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in dataclasses.asdict(o).items()}
    out = {}
    for f in o.DESCRIPTOR.fields:
        v = getattr(o, f.name)
        if f.message_type is not None:
            v = dict(v)
        elif f.is_repeated:
            v = list(v)
        elif f.has_presence and not o.HasField(f.name):
            v = None
        out[f.name] = v
    return out


def test_predict_options_has_the_proto_fields():
    """The dataclass's fields are the proto message's, in order, and an
    empty one reads as an empty message (unset optionals are None)."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(serving.PredictOptions)]
    assert names == [f.name for f in pb.PredictOptions.DESCRIPTOR.fields]
    assert _opts_dict(serving.PredictOptions()) == \
        _opts_dict(pb.PredictOptions())


_REQ_FIELDS = dict(prompt=[5, 6, 7, 8], max_new_tokens=9, temperature=0.5,
                   top_k=4, seed=11, stop=("x", "yz"), ignore_eos=True,
                   logit_bias={3: -1.5}, correlation_id="c-9", stream=True)


@pytest.mark.parametrize("fields", [
    {}, _REQ_FIELDS, {"top_p": 0.25, "min_p": 0.5, "repeat_penalty": 1.5,
                      "presence_penalty": 0.5, "frequency_penalty": 0.25}])
@pytest.mark.parametrize("regex", [None, "(yes|no)"])
def test_options_round_trip_as_the_jax_package(fields, regex):
    req = GenRequest(**{"prompt": [1, 2], **fields})
    jreq = JaxGenRequest(**{"prompt": [1, 2], **fields})
    if regex:
        req.constraint = constraint_for_regex(regex, ByteTokenizer())
        jreq.constraint = j_regex(regex, JaxByteTokenizer())
    opts = serving.predict_options(req)
    jopts = jserving.predict_options(jreq)
    got, want = _opts_dict(opts), _opts_dict(jopts)
    # the proto stores floats as float32
    for k in ("temperature", "top_p", "min_p", "repeat_penalty",
              "presence_penalty", "frequency_penalty"):
        if got[k] is not None:
            got[k] = float(np.float32(got[k]))
    assert got == want

    class _SM:
        tokenizer = ByteTokenizer()

    class _JSM:
        tokenizer = JaxByteTokenizer()

    back = gen_request_from_options(opts, _SM(), trace_id="t")
    jback = j_from_opts(jopts, _JSM(), trace_id="t")
    for f in ("prompt", "max_new_tokens", "top_k", "seed", "stop",
              "ignore_eos", "correlation_id", "trace_id", "tenant",
              "stream", "logit_bias"):
        assert getattr(back, f) == getattr(jback, f), f
    assert (back.constraint is None) == (jback.constraint is None)
    if regex:
        assert back.constraint.source_regex == regex


def test_constraint_without_a_regex_warns_and_crosses_unconstrained(caplog):
    class _C:
        pass

    req = GenRequest(prompt=[1], constraint=_C())
    with caplog.at_level("WARNING"):
        opts = serving.predict_options(req)
    assert opts.constraint_regex == "" and "unconstrained" in caplog.text


# -- fleets built by both managers ---------------------------------------------

def _yaml(name: str, ckpt: str) -> str:
    return (f"name: {name}\nmodel: {ckpt}\ncontext_size: 256\n"
            "parameters:\n  temperature: 0.0\n  max_tokens: 8\n"
            "engine:\n  max_slots: 2\n  prefill_buckets: [16, 32, 64, 128]\n"
            "  dtype: float32\n  kv_dtype: float32\n  kv_block_tokens: 16\n")


FLEET_APP = dict(fleet_replicas=2, fleet_prefill_replicas=1,
                 fleet_backend="inprocess", fleet_disagg_threshold=64)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """(port manager, port fleet, JAX manager, JAX fleet) over one
    checkpoint, each built by its manager's ``_load_fleet``."""
    root = tmp_path_factory.mktemp("fleet")
    models = root / "models"
    models.mkdir()
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    ckpt = write_llama_checkpoint(root / "tiny", tiny.cfg, tiny.params)
    (models / "tiny.yaml").write_text(_yaml("tiny", str(ckpt)))
    loader = ConfigLoader(str(models))
    loader.load_from_path(context_size=256)
    mgr = ModelManager(AppConfig(model_path=str(models), device="cpu",
                                 **FLEET_APP), loader)
    jloader = JaxLoader(str(models))
    jloader.load_from_path(context_size=256)
    jmgr = JaxManager(JaxApp(model_path=str(models), **FLEET_APP), jloader)
    fm, jfm = mgr.get("tiny"), jmgr.get("tiny")
    for f in (fm, jfm):
        _gate_sweeps(f.pool)
    yield mgr, fm, jmgr, jfm
    mgr.shutdown()
    jmgr.shutdown_all()


def _gate_sweeps(pool):
    """Put the pool's health sweeps behind ``pool.sweep_gate``: while a
    drill holds the gate no sweep runs, and taking it waits for a sweep in
    progress to end. The pool's own monitor thread calls ``poll_once``
    through the instance, so it takes the gate too."""
    pool.sweep_gate = threading.Lock()
    sweep = pool.poll_once

    def gated():
        with pool.sweep_gate:
            sweep()

    pool.poll_once = gated


def _gen(fm, Req, text, max_new=6, **kw):
    h = fm.scheduler.submit(Req(prompt=list(text.encode()),
                                max_new_tokens=max_new, temperature=0.0,
                                **kw))
    h.result(timeout=WAIT)
    return h


def _both(fleets, text, **kw):
    _, fm, _, jfm = fleets
    return (_gen(fm, GenRequest, text, **kw),
            _gen(jfm, JaxGenRequest, text, **kw))


def test_managers_build_fleets_alike(fleets):
    _, fm, _, jfm = fleets
    assert type(fm).__name__ == type(jfm).__name__ == "FleetServingModel"
    ids = sorted(r.id for r in fm.pool.members())
    assert ids == sorted(r.id for r in jfm.pool.members()) == [
        "tiny/p0", "tiny/r0", "tiny/r1"]
    assert fm.pool.states() == jfm.pool.states() == {"healthy": 3}
    # each replica engine runs under its replica id
    assert {r.sm.name for r in fm.pool.members()} == set(ids)


def _routed(fm):
    return dict(fm.router.snapshot()["routed"])


def test_affinity_then_directory_keep_one_replica(fleets):
    _, fm, _, jfm = fleets
    text = "the same shared prompt prefix, ask"   # 2 blocks, < 64
    texts = []
    for _ in range(3):
        h, jh = _both(fleets, text)
        assert h.finish_reason == jh.finish_reason
        assert h.text == jh.text
        texts.append(h.text)
    assert len(set(texts)) == 1
    for f in (fm, jfm):
        served = [r.id for r in f.pool.members()
                  if r.role == "decode" and r.dispatched > 0]
        assert len(served) == 1
    assert _routed(fm) == _routed(jfm)
    assert _routed(fm)["affinity"] + _routed(fm)["directory"] >= 3
    assert fm.directory.stats() == jfm.directory.stats()


def test_disaggregated_prefill_moves_equal_bytes(fleets):
    _, fm, _, jfm = fleets
    text = "disaggregate this long prompt please, " * 3   # >= 64 tokens
    before = (fm.scheduler.prefix_transfers, jfm.scheduler.prefix_transfers)
    b_bytes = (fm.scheduler.prefix_transfer_bytes,
               jfm.scheduler.prefix_transfer_bytes)
    h, jh = _both(fleets, text, max_new=8)
    assert h.text == jh.text and h.finish_reason == jh.finish_reason
    assert fm.scheduler.prefix_transfers == before[0] + 1
    assert jfm.scheduler.prefix_transfers == before[1] + 1
    moved = (fm.scheduler.prefix_transfer_bytes - b_bytes[0],
             jfm.scheduler.prefix_transfer_bytes - b_bytes[1])
    assert moved[0] == moved[1] > 0
    # the decode replica resumed past the transferred rows
    dec = [r for r in fm.pool.members() if r.role == "decode"
           and r.sm.scheduler.metrics()["prompt_cache"]["hits"] > 0]
    assert dec
    assert _routed(fm) == _routed(jfm)


def test_failover_reroutes_and_the_replica_respawns(fleets):
    _, fm, _, jfm = fleets
    text = "failover probe prompt, one block"
    targets = []
    # both pools' health sweeps are held for the drill: a sweep between a
    # kill and its request would mark the replica dead first, and that
    # request would be routed around it and count no failover. Held, each
    # package's request meets its killed replica and fails over, whatever
    # the machine's speed; the respawn starts from that failover
    with fm.pool.sweep_gate, jfm.pool.sweep_gate:
        for f in (fm, jfm):
            target, _ = f.router.route(list(text.encode()))
            target.kill()
            targets.append(target)
        # the killed engine, once its replica is stopped, is freed
        killed = weakref.ref(targets[0].sm.runner)
        h, jh = _both(fleets, text)
    assert h.text == jh.text and h.finish_reason in ("stop", "length")
    assert fm.scheduler.failovers == jfm.scheduler.failovers >= 1
    assert _routed(fm)["failover"] == _routed(jfm)["failover"] >= 1
    deadline = time.monotonic() + WAIT
    while (any(t.state != "healthy" for t in targets)
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert [t.state for t in targets] == ["healthy", "healthy"]
    assert targets[0].sm is not None and targets[0].sm.scheduler.alive()
    gc.collect()
    assert killed() is None
    # the death dropped every directory entry naming the replica, alike
    assert fm.directory.stats() == jfm.directory.stats()
    for f in (fm, jfm):
        f.slo.reset()


MIGRATED_TOKENS = 160
# a live migration drops the bytes of a multi-byte character that the
# donor's detokenizer holds at the boundary, on both packages (the
# continuation's detokenizer starts after them); the drill keeps the
# byte tokenizer's output ASCII, so the text must be equal byte for byte
ASCII_ONLY = {i: -100.0 for i in range(128, 256)}


def _migrated(f, Req, text):
    """A streamed request moved to the other decode replica after its
    first delta: (migrate_inflight's answer, the handle)."""
    h = f.scheduler.submit(Req(prompt=list(text.encode()),
                               max_new_tokens=MIGRATED_TOKENS,
                               temperature=0.0, ignore_eos=True,
                               stream=True, logit_bias=dict(ASCII_ONLY)))
    res, th, n = {}, None, 0
    for item in h:
        if item.delta:
            n += 1
            if n == 1:
                th = threading.Thread(target=lambda: res.setdefault(
                    "ok", f.scheduler.migrate_inflight(h, timeout=60)))
                th.start()
        if item.finish_reason:
            break
    th.join(WAIT)
    return res.get("ok"), h


def test_live_migration_continues_the_text(fleets):
    _, fm, _, jfm = fleets
    text = "migrate this stream across replicas"
    ref, jref = _both(fleets, text, max_new=MIGRATED_TOKENS,
                      ignore_eos=True, logit_bias=dict(ASCII_ONLY))
    assert ref.text == jref.text
    before = (fm.scheduler.migrations, jfm.scheduler.migrations)
    ok, h = _migrated(fm, GenRequest, text)
    jok, jh = _migrated(jfm, JaxGenRequest, text)
    assert ok is True and jok is True
    assert h.text == ref.text == jh.text
    assert h.completion_tokens == jh.completion_tokens == MIGRATED_TOKENS
    assert fm.scheduler.migrations == before[0] + 1
    assert jfm.scheduler.migrations == before[1] + 1
    assert fm.scheduler.migration_fallbacks == \
        jfm.scheduler.migration_fallbacks


def _raise_evicted(*a, **kw):
    raise RuntimeError("blocks evicted")


def test_sibling_fetch_then_a_stale_entry_costs_one_fetch(fleets):
    """Placement away from the warm KV pulls the prefix from the holder
    (a sibling transfer); once the holder lost it, the fetch fails once,
    the stale entry is dropped and the request re-prefills: on both
    packages, with equal counters and the same text."""
    _, fm, _, jfm = fleets
    head = "directory churn prefix family head " * 2   # > 4 blocks
    out = {}
    for f, Req, rmod in ((fm, GenRequest, router),
                         (jfm, JaxGenRequest, jrouter)):
        _gen(f, Req, head + " warm")
        req = Req(prompt=list((head + " again").encode()),
                  max_new_tokens=6, temperature=0.0)
        key = rmod.affinity_key(req.prompt,
                                block_tokens=f.router.block_tokens,
                                blocks=f.router.affinity_blocks)
        ids = [r.id for r in f.pool.members()]
        holder = f.pool.get(f.scheduler.directory.holder(key, ids))
        other = next(r for r in f.pool.members()
                     if r.role == "decode" and r.id != holder.id)
        fetched = f.scheduler._sibling_fetch(req, other, None)
        holder.export_cached = _raise_evicted
        holder.prefill_prefix = _raise_evicted
        f.scheduler.directory.drop(key, other.id)
        stale = f.scheduler._sibling_fetch(req, other, None)
        del holder.export_cached, holder.prefill_prefix
        gone = f.scheduler.directory.holder(key, [holder.id]) is None
        h = f.scheduler.submit(req)
        h.result(WAIT)
        out[f is fm] = (fetched, stale, gone, h.text, h.finish_reason,
                        f.scheduler.sibling_transfers,
                        f.scheduler.sibling_fallbacks,
                        f.directory.stats())
    assert out[True] == out[False]
    assert out[True][:3] == (True, False, True)


def test_constrained_request_through_the_fleet(fleets):
    _, fm, _, jfm = fleets
    h = fm.scheduler.submit(GenRequest(
        prompt=list(b"answer yes or no please"), max_new_tokens=8,
        temperature=0.0,
        constraint=constraint_for_regex("(yes|no)", ByteTokenizer())))
    jh = jfm.scheduler.submit(JaxGenRequest(
        prompt=list(b"answer yes or no please"), max_new_tokens=8,
        temperature=0.0,
        constraint=j_regex("(yes|no)", JaxByteTokenizer())))
    h.result(WAIT)
    jh.result(WAIT)
    assert h.text == jh.text and h.text in ("yes", "no")


TOOLS_BODY = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "weather in Paris?"}],
    "tools": [{"type": "function", "function": {
        "name": "get_weather", "description": "the weather of a city",
        "parameters": {"type": "object",
                       "properties": {"city": {"type": "string"}},
                       "required": ["city"]}}}],
    "tool_choice": "required"}


def test_tools_request_through_the_fleet(fleets):
    """A tools request's constraint crosses the fleet as its source regex
    and is rebuilt in the replica: the grammar and the constrained greedy
    text equal the JAX fleet's."""
    from localai_tpu.api import inference as jinf
    from localai_tpu.api.schema import OpenAIRequest
    from localai_tpu_torch.api import inference as inf

    _, fm, _, jfm = fleets
    tctx = inf.prepare_tools(fm, dict(TOOLS_BODY))
    jtctx = jinf.prepare_tools(jfm, jfm.config,
                               OpenAIRequest.model_validate(TOOLS_BODY))
    assert tctx.constraint.source_regex == jtctx.constraint.source_regex
    prompt = list(b"weather in Paris? call a tool")
    h = fm.scheduler.submit(GenRequest(prompt=prompt, max_new_tokens=48,
                                       temperature=0.0,
                                       constraint=tctx.constraint))
    jh = jfm.scheduler.submit(JaxGenRequest(prompt=prompt,
                                            max_new_tokens=48,
                                            temperature=0.0,
                                            constraint=jtctx.constraint))
    h.result(WAIT)
    jh.result(WAIT)
    assert h.finish_reason == jh.finish_reason
    assert h.text == jh.text and h.text


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_fleet_status_and_metrics_have_the_jax_keys(fleets):
    _, fm, _, jfm = fleets
    st, jst = fm.fleet_status(), jfm.fleet_status()
    assert set(st) == set(jst)
    assert _keys(st["router"]) == _keys(jst["router"])
    assert [set(r) for r in st["replicas"]] == [set(r) for r in
                                                jst["replicas"]]
    assert st["directory"].keys() == jst["directory"].keys()
    m, jm = fm.scheduler.metrics(), jfm.scheduler.metrics()
    assert set(m) == set(jm)
    assert set(m["fleet"]) == set(jm["fleet"])
    for k in ("failovers", "prefix_transfers", "prefix_transfer_bytes",
              "migrations", "routed"):
        assert m["fleet"][k] == jm["fleet"][k], k


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def http(fleets):
    """The port's HTTP server over the fleets' manager (its shutdown stops
    the manager's models too, so it lives as long as the fleets)."""
    srv = APIServer(fleets[0], "127.0.0.1", 0).start()
    yield srv
    srv.shutdown()


def test_http_fleet_routes(fleets, http):
    _, _, _, jfm = fleets
    status, body = _get(http.url + "/v1/fleet")
    assert status == 200
    assert set(body) == {"configured_replicas",
                         "configured_prefill_replicas", "backend", "models"}
    assert body["backend"] == "inprocess"
    assert body["models"]["tiny"]["fleet"] is True
    assert set(body["models"]["tiny"]) == {"fleet", *jfm.fleet_status()}
    assert _post(http.url + "/v1/fleet/nope/swap", {})[0] == 404
    assert _post(http.url + "/v1/fleet/tiny/swap",
                 {"checkpoint": 3})[0] == 400
    # the scrape carries the fleet families for the model
    with urllib.request.urlopen(http.url + "/metrics", timeout=WAIT) as r:
        text = r.read().decode()
    assert 'localai_fleet_replicas{model="tiny",state="healthy"} 3' in text
    assert "localai_fleet_routed_total" in text


def test_hot_swap_replaces_the_generation(fleets, http):
    """POST /v1/fleet/{model}/swap boots fresh replicas, drains and
    retires the old ones; ids only ever advance, as on the JAX package;
    the retired engines are stopped."""
    mgr, fm, _, jfm = fleets
    old = {r.id: r for r in fm.pool.members()}
    status, body = _post(http.url + "/v1/fleet/tiny/swap", {})
    jres = jfm.swap()
    assert status == 200 and body["ok"] and jres["ok"], body
    assert body["new"] == jres["new"] and body["old"] == jres["old"]
    assert all(old[rid].sm is None for rid in body["old"])
    assert sorted(r.id for r in fm.pool.members()) == sorted(body["new"])
    h, jh = _both(fleets, "after the swap, one block prompt")
    assert h.text == jh.text, (h.finish_reason, jh.finish_reason)


class _FakeEngine:
    """A serving model whose scheduler only records its lifecycle."""

    def __init__(self):
        self.runner = type("R", (), {"prefix_reuse_min": 16})()
        self.scheduler = self
        self.prompt_cache = None
        self.down = False

    def attach_prompt_cache(self, cache, *, layer=False):
        self.prompt_cache = cache

    def alive(self):
        return not self.down

    def shutdown(self, timeout=10.0):
        self.down = True


def test_a_booting_replica_is_alive_and_its_engine_never_orphaned():
    """While an in-process replica builds its engine, the pool's monitor
    sees a live process (dials fail, nothing declares it dead and starts
    a second engine beside it), and a stop() that races the boot waits
    for it and shuts down what it built."""
    from localai_tpu_torch.fleet.replica import InProcessReplica

    gate, built = threading.Event(), []

    def factory():
        gate.wait(30)
        built.append(_FakeEngine())
        return built[-1]

    r = InProcessReplica("m/r9", "decode", factory)
    boot = threading.Thread(target=r.start)
    boot.start()
    while not r._starting:
        time.sleep(0.01)
    assert r.process_alive() and not r.dial()
    stopper = threading.Thread(target=r.stop)
    stopper.start()
    time.sleep(0.1)
    assert stopper.is_alive()            # waits for the boot
    gate.set()
    boot.join(30)
    stopper.join(30)
    assert len(built) == 1 and built[0].down and r.sm is None
    assert not r.process_alive()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_respawn_backoff_grows_caps_and_resets(pkg):
    """A replica whose respawn keeps failing is retried on jittered
    exponential backoff (growing across the first doublings, never past
    the cap, skipped until the hold expires); a rejoin resets the clock
    and zeroes the gauge: on both packages' pools."""
    if pkg == "port":
        from localai_tpu_torch.fleet.pool import ReplicaPool
        from localai_tpu_torch.fleet.replica import BaseReplica
        from localai_tpu_torch.obs.metrics import REGISTRY
    else:
        from localai_tpu.fleet.pool import ReplicaPool
        from localai_tpu.fleet.replica import BaseReplica
        from localai_tpu.obs.metrics import REGISTRY

    class _Flaky(BaseReplica):
        def __init__(self, rid, role="decode"):
            super().__init__(rid, role)
            self.fail_starts = 0
            self.up = True

        def start(self):
            if self.fail_starts > 0:
                self.fail_starts -= 1
                raise RuntimeError("boot refused")
            self.up = True

        def _dial(self, timeout):
            return self.up

        def process_alive(self):
            return self.up

        def metrics(self):
            return {}

        def stop(self):
            pass

    pool = ReplicaPool(f"backoff-{pkg}", lambda rid, role: _Flaky(rid, role),
                       replicas=1, health_interval=3600.0)
    pool.respawn_backoff_base = 0.05
    pool.respawn_backoff_cap = 0.15
    pool.start()
    try:
        r = pool.replicas[0]
        r.fail_starts = 3
        r.up = False
        pool.note_failure(r)
        backoffs = []
        deadline = time.monotonic() + 30
        while len(backoffs) < 3 and time.monotonic() < deadline:
            pool.poll_once()
            b = pool.respawn_backoff_s.get(r.id)
            if b is not None and (not backoffs or b != backoffs[-1]):
                backoffs.append(b)
            time.sleep(0.01)
        assert len(backoffs) == 3, backoffs
        assert backoffs[1] > backoffs[0], backoffs
        assert all(b <= pool.respawn_backoff_cap for b in backoffs)
        deadline = time.monotonic() + 30
        while r.state != "healthy" and time.monotonic() < deadline:
            pool.poll_once()
            time.sleep(0.01)
        assert r.state == "healthy" and pool.respawns == 1
        assert r.id not in pool.respawn_backoff_s
        snap = pool.snapshot()
        assert snap["respawn_backoff_s"] == {}
        assert set(snap) == {"model", "states", "respawns", "evictions",
                             "redials", "adoptions", "respawn_backoff_s",
                             "redial_backoff_s", "health_interval_s",
                             "failure_threshold", "replicas"}
        assert ('localai_fleet_respawn_backoff_s'
                f'{{model="backoff-{pkg}",replica="backoff-{pkg}/r0"}} 0.0'
                ) in REGISTRY.render()
    finally:
        pool.shutdown()
