"""Constrained decoding on the port against the JAX package, on the CPU.

* ``ModelRunner.step_frozen_n`` (f32 ``debug:tiny``, weights made from a
  seed and carried across with ``params_from_numpy``) on paged pools of
  f32, int8 and int4 and on contiguous f32 and int8 caches, with bias
  rows set and freeze masks of one, some and all-but-one slots: the
  sampled rows equal the JAX runner's byte for byte, and so do the
  decode state (tokens, positions, counts); the KV caches, from which
  every later logit is computed, agree within 1e-5 (float storage; a
  quantized cache within 1e-5 plus one quantum of its row's scale).
* A frozen slot writes the K/V of its pending token at its unadvanced
  position; the next dispatch writes the same row again, identically.
* A seeded sampled slot's stream (its own generator: the bits are not
  threefry's) is the same under frozen dispatches and under single steps.
* The scheduler with a constrained request beside unconstrained ones, on
  a spec-off engine and on a speculating paged engine: the constrained
  texts equal the JAX scheduler's, the neighbours equal their texts when
  run alone, no verify window runs while a constrained slot is live, and
  windows resume after it.
* Both HTTP servers on one YAML with a ``function:`` section and a tiny
  checkpoint written here: tools under ``auto``, ``required`` and a named
  function, legacy ``functions``, ``json_object``, ``json_schema``, and
  streaming, answer the same content and ``tool_calls`` (ids aside) with
  the same ``finish_reason``; ``required`` with a schema that cannot be
  built is a 400 on both; a request ``grammar`` stays refused on the
  port.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu import functions as jfx  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch import functions as tfx  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.spec import NGramDrafter, SpecEngine  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

RUNNER_KW = dict(num_slots=4, max_ctx=128, prefill_buckets=[32])
PROMPTS = [list(b"constrain me"), list(b"the free one"), list(b"hello"),
           list(b"abcabcabcabc")]
_MODELS: dict = {}


def _model(weights=""):
    """(JAX cfg, JAX params, port cfg, port params) of f32 debug:tiny made
    from jax.random.key(0), quantized by each package when ``weights``."""
    if weights not in _MODELS:
        if "" not in _MODELS:
            cfg_j = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
            params_j = jl.init_params(jax.random.key(0), cfg_j)
            cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
            _MODELS[""] = (cfg_j, params_j, cfg_t, tl.params_from_numpy(
                jax.tree.map(np.asarray, params_j), cfg_t, device="cpu"))
        cfg_j, params_j, cfg_t, params_t = _MODELS[""]
    if weights not in _MODELS:
        _MODELS[weights] = (cfg_j, jq.quantize_params(params_j, weights),
                            cfg_t, tq.quantize_params(params_t, weights,
                                                      device="cpu"))
    return _MODELS[weights]


def _runners(paged: bool, kv: str):
    """(port runner, JAX runner) with the same weights and settings; a
    quantized KV cache runs beside weights of the same kind."""
    weights = kv if kv in ("int8", "int4") else ""
    cfg_j, params_j, cfg_t, params_t = _model(weights)
    kw = dict(RUNNER_KW, kv_dtype=kv, paged=paged)
    if paged:
        kw["kv_block_tokens"] = 16
    return (ModelRunner(cfg_t, params_t, device="cpu", **kw),
            JaxRunner(cfg_j, params_j, attn_impl="xla", **kw))


def _band(vocab: int, lo: int, hi: int) -> np.ndarray:
    """A bias row allowing ids [lo, hi) only: -1e30 over the rest."""
    row = np.full(vocab, -1e30, np.float32)
    row[lo:hi] = 0.0
    return row


def _admit_all(r, vocab):
    """Four greedy slots; slot 0 behind a band row, as a constraint sets
    it. Returns the first tokens."""
    firsts = []
    for i, p in enumerate(PROMPTS):
        s = r.acquire_slot()
        assert s == i
        firsts.append(int(r.admit(s, p, temperature=0.0,
                                  bias_row=_band(vocab, 97, 123)
                                  if i == 0 else None)))
    return firsts


def _freeze(*slots):
    f = np.zeros(RUNNER_KW["num_slots"], bool)
    f[list(slots)] = True
    return f


def _kv_float(kv) -> list[np.ndarray]:
    """The cache as float arrays: (k, v) for float storage; scaled
    storage dequantized (int4 unpacked first), and its scales."""
    k, v = (torch.as_tensor(np.asarray(kv.k)),
            torch.as_tensor(np.asarray(kv.v)))
    if kv.k_scale is None:
        return [k.numpy(), v.numpy()]
    ks, vs = (torch.as_tensor(np.asarray(kv.k_scale)),
              torch.as_tensor(np.asarray(kv.v_scale)))
    if k.shape[-1] * 2 == _model()[2].hd:
        k, v = tq.unpack_int4_lastdim(k), tq.unpack_int4_lastdim(v)
    return [(k.float() * ks[..., None]).numpy(),
            (v.float() * vs[..., None]).numpy(), ks.numpy(), vs.numpy()]


def _assert_same_state(port, ref):
    st, js = port.state, ref.state
    for f in ("tokens", "positions", "active", "counts"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(st.bias.numpy(), np.asarray(js.bias))
    ours, want = _kv_float(port.kv), _kv_float(ref.kv)
    for i, (a, b) in enumerate(zip(ours, want)):
        tol = 1e-5
        if len(ours) == 4 and i < 2:  # one quantum of the row's scale
            tol += float(ours[2 + i].max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("paged,kv", [
    (True, "float32"), (True, "int8"), (True, "int4"),
    (False, "float32"), (False, "int8")],
    ids=["paged-f32", "paged-int8", "paged-int4", "contiguous-f32",
         "contiguous-int8"])
def test_step_frozen_n_matches_jax(paged, kv):
    port, ref = _runners(paged, kv)
    V = port.cfg.vocab_size
    assert _admit_all(port, V) == _admit_all(ref, V)
    # one dispatch size: each size is one more JAX compile
    plan = [("frozen", _freeze(0), 3), ("bias", 0, (48, 58)),
            ("frozen", _freeze(0, 2), 3), ("step", None, None),
            ("frozen", _freeze(1, 2, 3), 3), ("frozen", _freeze(), 3)]
    for op, arg, n in plan:
        if op == "bias":
            for r in (port, ref):
                r.set_bias(arg, _band(V, *n))
            continue
        if op == "step":
            got, want = port.step()[None], np.asarray(ref.step())[None]
        else:
            got = port.step_frozen_n(arg, n)
            want = np.asarray(ref.step_frozen_n(arg, n))
            assert got.shape == (n, RUNNER_KW["num_slots"])
        np.testing.assert_array_equal(got, want)
    # a banded slot only ever emitted ids inside its band
    assert all(97 <= t < 123 or 48 <= t < 58
               for t in port.state.tokens[:1].tolist())
    _assert_same_state(port, ref)
    assert port.frozen_dispatches == 4
    assert port.decode_steps == 3 + 3 + 1 + 3 + 3


def _slot_rows(r, slot: int, upto: int) -> list[torch.Tensor]:
    """The K/V rows [0, upto) of ``slot`` in every cache tensor, through
    the block table on a paged runner."""
    out = []
    for t in r.kv.stacked():
        if r.paged:
            blocks = r.block_tables[slot].long()
            rows = t[:, blocks].transpose(2, 3)  # [L, MB, bt, H, ...]
            rows = rows.reshape(t.shape[0], -1, *rows.shape[3:])
        else:
            rows = t[:, slot].transpose(1, 2)    # [L, C, H, ...]
        out.append(rows[:, :upto].clone())
    return out


@pytest.mark.parametrize("paged,kv", [
    (True, "float32"), (True, "int8"), (True, "int4"), (False, "int8")],
    ids=["paged-f32", "paged-int8", "paged-int4", "contiguous-int8"])
def test_frozen_slot_kv_rows_are_written_twice_identically(paged, kv):
    """Slot 0 frozen for 4 steps: on steps 1-3 it writes its pending
    token's K/V at its unadvanced row P+1; the next step writes that row
    again, bit for bit, and leaves rows [0, P+1) alone. A runner that took
    one plain step instead holds the same rows after its next step."""
    a, _ = _runners(paged, kv)
    b, _ = _runners(paged, kv)
    V = a.cfg.vocab_size
    assert _admit_all(a, V) == _admit_all(b, V)
    P = len(PROMPTS[0])
    rows_a = a.step_frozen_n(_freeze(0), 4)
    rows_b = b.step()
    assert rows_a[0, 0] == rows_b[0]
    assert int(a.state.positions[0]) == int(b.state.positions[0]) == P + 1
    before = _slot_rows(a, 0, P + 2)
    tok_a, tok_b = a.step(), b.step()
    assert tok_a[0] == tok_b[0]
    after, plain = _slot_rows(a, 0, P + 2), _slot_rows(b, 0, P + 2)
    for x, y, z in zip(before, after, plain):
        assert torch.equal(x, y)
        assert torch.equal(y, z)


def test_seeded_slot_stream_is_the_same_frozen_or_stepped():
    """A seeded sampled slot (its own generator) under frozen dispatches
    draws exactly what it draws one step at a time: frozen steps do not
    advance its generator."""
    streams = []
    for frozen in (True, False):
        r, _ = _runners(True, "float32")
        V = r.cfg.vocab_size
        first = [int(r.admit(r.acquire_slot(), PROMPTS[0], temperature=1.0,
                             seed=1234, bias_row=_band(V, 60, 90)))]
        for p in PROMPTS[1:3]:
            r.admit(r.acquire_slot(), p, temperature=0.0)
        for _ in range(6):
            rows = (r.step_frozen_n(_freeze(0), 4) if frozen
                    else r.step()[None])
            first.append(int(rows[0, 0]))
        streams.append(first)
    assert streams[0] == streams[1]
    assert all(60 <= t < 90 for t in streams[0][1:])
    assert len(set(streams[0])) > 1  # sampled, not forced


# ---------------------------------------------------------------------------
# the scheduler


SCHEMA = {"type": "object", "properties": {
    "unit": {"enum": ["celsius", "fahrenheit"]}, "ok": {"type": "boolean"},
    "mode": {"enum": ["a", "bb", "ccc"]}}}
FREE = [dict(prompt=list(b"the free one"), max_new_tokens=40,
             temperature=0.0),
        dict(prompt=list(b"abcabcabcabcabc"), max_new_tokens=40,
             temperature=0.0, logit_bias={97: 1e4})]


def _port_engine(spec: bool):
    _, _, cfg_t, params_t = _model()
    r = ModelRunner(cfg_t, params_t, device="cpu", kv_dtype="float32",
                    kv_block_tokens=16, **RUNNER_KW)
    eng = SpecEngine(r, NGramDrafter(4, gamma=4), gamma=4) if spec else None
    return Scheduler(r, ByteTokenizer(), multi_step=4, spec=eng)


def _constrained(fx, tok):
    return fx.constraint_for_schema(SCHEMA, tok)


def _watch_windows(sched):
    """Record, for every verify window the scheduler dispatches, whether a
    constrained slot was live."""
    seen = []
    orig = sched.spec.step_spec_async

    def step_spec_async():
        seen.append(any(c.handle.request.constraint is not None
                        for c in sched._slots.values()))
        return orig()

    sched.spec.step_spec_async = step_spec_async
    return seen


@pytest.mark.parametrize("spec", [False, True], ids=["spec-off", "spec-on"])
def test_scheduler_mixed_batch_matches_jax_and_solo_runs(spec):
    tok = ByteTokenizer()
    solo = _port_engine(False)
    try:
        alone = [solo.generate(GenRequest(**f), timeout=120).token_ids
                 for f in FREE]
    finally:
        solo.shutdown()
    sched = _port_engine(spec)
    seen = _watch_windows(sched) if spec else []
    try:
        free = [sched.submit(GenRequest(**f)) for f in FREE]
        con = sched.submit(GenRequest(prompt=list(b"emit json"),
                                      max_new_tokens=90, temperature=0.0,
                                      constraint=_constrained(tfx, tok)))
        con.result(120)
        windows_at_con_end = sched.metrics().get("spec_windows", 0)
        assert [h.result(120).token_ids for h in free] == alone
        m = sched.metrics()
        assert m["frozen_dispatches"] > 0
        assert m["constrained_tokens"] == con.completion_tokens
        if spec:
            # windows resume once no constrained slot is live
            again = sched.generate(GenRequest(**FREE[1]), timeout=120)
            assert again.token_ids == alone[1]
            assert sched.metrics()["spec_windows"] > windows_at_con_end
            assert seen and not any(seen), \
                "a window ran beside a constrained slot"
    finally:
        sched.shutdown()
    assert con.finish_reason == "stop"
    assert jfx.compile_dfa(jfx.schema_to_regex(SCHEMA)).matches(con.text)
    cfg_j, params_j, _, _ = _model()
    jr = JaxRunner(cfg_j, params_j, attn_impl="xla", kv_dtype="float32",
                   kv_block_tokens=16, **RUNNER_KW)
    jsched = JaxScheduler(jr, JaxByteTokenizer(), multi_step=4)
    try:
        want = jsched.generate(JaxGenRequest(
            prompt=list(b"emit json"), max_new_tokens=90, temperature=0.0,
            constraint=_constrained(jfx, JaxByteTokenizer())), timeout=120)
    finally:
        jsched.shutdown()
    assert con.token_ids == want.token_ids and con.text == want.text
    assert con.finish_reason == want.finish_reason


def test_seeded_constrained_request_is_the_same_alone_or_frozen():
    """A seeded, sampled constrained request draws the same tokens alone
    (single steps) and beside unconstrained requests (frozen dispatches):
    its generator advances once per token it emits."""
    band = r"[a-z]{12}"

    def run(noise: bool):
        sched = _port_engine(False)
        try:
            others = [sched.submit(GenRequest(
                prompt=list(f"noise {i}".encode()), max_new_tokens=100,
                temperature=0.0)) for i in range(2)] if noise else []
            h = sched.generate(GenRequest(
                prompt=list(b"seeded"), max_new_tokens=20, temperature=1.0,
                seed=1234, constraint=tfx.constraint_for_regex(
                    band, ByteTokenizer())), timeout=120)
            for o in others:
                o.cancel()
            for o in others:
                o.result(120)
            return h.token_ids, sched.metrics()["frozen_dispatches"]
        finally:
            sched.shutdown()

    solo, frozen_solo = run(False)
    mixed, frozen_mixed = run(True)
    assert frozen_solo == 0 and frozen_mixed > 0
    assert mixed == solo and len(solo) == 12
    assert tfx.compile_dfa(band).matches(bytes(solo))


def test_constraint_mask_reaches_the_first_token_and_padded_ids():
    """The first token, sampled by the prefill, is already constrained;
    debug:tiny pads the 258-id tokenizer to a 512-id vocab, and the
    padded ids stay at -1e30 under every mask."""
    sched = _port_engine(False)
    try:
        only = tfx.constraint_for_regex(r"zq", ByteTokenizer())
        h = sched.generate(GenRequest(prompt=list(b"x"), max_new_tokens=8,
                                      temperature=0.0, constraint=only),
                           timeout=120)
        assert h.text == "zq" and h.finish_reason == "stop"
        assert only.done and only.allowed_mask() is None
        V = sched.runner.cfg.vocab_size
        fresh = tfx.constraint_for_regex(r"zq", ByteTokenizer())
        row = sched._compose_bias(None, fresh.allowed_mask())
        assert row.shape == (V,) and (row[258:] == -1e30).all()
        base = sched._padded_vocab_ban()
        base[5] = 2.0
        row = sched._compose_bias(base, np.zeros(258, np.float32))
        assert row[5] == 2.0 and (row[258:] <= -1e30).all()
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# both HTTP servers


ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)
FUNCTION = {"no_action_function_name": "reply",
            "replace_llm_results": [{"key": "ZZZ", "value": ""}]}
GET_WEATHER = {"name": "get_weather", "description": "weather of a place",
               "parameters": {"type": "object", "properties": {
                   "unit": {"enum": ["c", "f"]}, "ok": {"type": "boolean"}}}}
SET_MODE = {"name": "set_mode", "parameters": {"type": "object",
                                               "properties": {
    "mode": {"enum": ["on", "off"]}}}}
TOOLS = [{"type": "function", "function": f} for f in (GET_WEATHER, SET_MODE)]
RECURSIVE = {"name": "loop", "parameters": {
    "type": "object", "properties": {"next": {"$ref": "#/$defs/n"}},
    "$defs": {"n": {"type": "object", "properties": {
        "next": {"$ref": "#/$defs/n"}}}}}}


@pytest.fixture(scope="module")
def two_servers(tmp_path_factory):
    """The port's and the JAX package's HTTP servers over one models dir
    holding one YAML with a ``function:`` section, on a tiny random
    checkpoint."""
    root = tmp_path_factory.mktemp("tools")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(5), cfg))
    models = root / "models"
    models.mkdir()
    (models / "f.yaml").write_text(yaml.safe_dump({
        "name": "f", "model": str(ckpt), "context_size": 256,
        "engine": ENGINE, "function": FUNCTION}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    assert loader.get("f").function.no_action_function_name == "reply"
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield port.url, ref.base
    ref.stop()
    port.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if body.get("stream"):
            return [json.loads(line[6:]) for line in r.read().splitlines()
                    if line.startswith(b"data: {")]
        return json.loads(r.read())


def _without_ids(out):
    """A response with the random parts (ids, timestamps) taken out."""
    out = json.loads(json.dumps(out))
    frames = out if isinstance(out, list) else [out]
    for f in frames:
        f.pop("id", None)
        f.pop("created", None)
        for c in f.get("choices", []):
            part = c.get("message") or c.get("delta") or {}
            for tc in part.get("tool_calls") or []:
                tc.pop("id", None)
    return out


CHAT_CASES = {
    "tools-auto": {"tools": TOOLS, "tool_choice": "auto"},
    "tools-required": {"tools": TOOLS, "tool_choice": "required"},
    "tools-named": {"tools": TOOLS, "tool_choice": {
        "type": "function", "function": {"name": "set_mode"}}},
    "tools-none": {"tools": TOOLS, "tool_choice": "none"},
    "legacy-functions": {"functions": [GET_WEATHER, SET_MODE],
                         "function_call": {"name": "get_weather"}},
    "json-object": {"response_format": {"type": "json_object"}},
    "json-schema": {"response_format": {"type": "json_schema",
                                        "json_schema": {"schema": {
                                            "type": "object",
                                            "properties": {
                                                "ok": {"type": "boolean"},
                                                "n": {"enum": [1, 22]}}}}}},
    "tools-required-stream": {"tools": TOOLS, "tool_choice": "required",
                              "stream": True},
    "json-schema-stream": {"response_format": {
        "type": "json_schema", "json_schema": {"schema": {
            "type": "object", "properties": {"ok": {"type": "boolean"}}}}},
        "stream": True},
}


@pytest.mark.parametrize("name", list(CHAT_CASES))
def test_chat_with_constraints_answers_as_the_jax_server(two_servers, name):
    body = {"model": "f", "max_tokens": 120, "temperature": 0,
            "messages": [{"role": "user", "content": "weather in Nice?"}],
            **CHAT_CASES[name]}
    got = [_without_ids(_post(url + "/v1/chat/completions", body))
           for url in two_servers]
    assert got[0] == got[1]
    if name.endswith("stream"):
        finish = got[0][-1]["choices"][0]["finish_reason"]
    else:
        finish = got[0]["choices"][0]["finish_reason"]
        msg = got[0]["choices"][0]["message"]
        if name == "json-schema":
            json.loads(msg["content"])  # a constrained JSON answer parses
    if name in ("tools-required", "tools-named", "legacy-functions",
                "tools-required-stream"):
        assert finish == "tool_calls"


@pytest.mark.parametrize("choice", ["required", "auto"])
def test_tool_grammar_that_cannot_be_built(two_servers, choice):
    """A recursive schema has no regular grammar: under ``required`` both
    servers answer 400; under ``auto`` both decode unconstrained."""
    body = {"model": "f", "max_tokens": 8, "temperature": 0,
            "tools": [{"type": "function", "function": RECURSIVE}],
            "tool_choice": choice,
            "messages": [{"role": "user", "content": "hi"}]}
    if choice == "auto":
        got = [_without_ids(_post(url + "/v1/chat/completions", body))
               for url in two_servers]
        assert got[0] == got[1]
        return
    for url in two_servers:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/chat/completions", body)
        assert e.value.code == 400


@pytest.mark.parametrize("body", [
    {"grammar": "root ::= \"x\""},
    {"n": 2, "tools": TOOLS}])
def test_chat_still_refuses_grammar_and_n(two_servers, body):
    """A raw grammar is refused; ``n: 2`` with tools is served since
    templates landed: two tool-call choices, each with its own
    constraint, equal to the JAX server's."""
    req = {"model": "f", "max_tokens": 120, "temperature": 0,
           "messages": [{"role": "user", "content": "hi"}], **body}
    if "n" in body:
        got = [_without_ids(_post(url + "/v1/chat/completions",
                                  dict(req, tool_choice="required")))
               for url in two_servers]
        assert got[0] == got[1]
        assert [c["index"] for c in got[0]["choices"]] == [0, 1]
        assert all(c["finish_reason"] == "tool_calls"
                   for c in got[0]["choices"])
        return
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(two_servers[0] + "/v1/chat/completions", req)
    assert e.value.code == 400
