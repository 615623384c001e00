"""The port's host side of constrained decoding against the JAX package.

The same patterns, schemas, tools, tokenizers and model outputs go
through the JAX package's ``functions`` modules and the port's copies on
the CPU: DFAs (transitions, classes, accepting states) and their
matches, the JSON-schema regexes, every mask row of a greedy walk over
the byte tokenizer, the tool regexes and constraints, every parse helper,
``token_bytes_table`` and the trie of a small BPE tokenizer built here,
and the native trie walk of ``native/fsm_walk.c`` against its numpy
version. Everything is compared exactly: the modules do no float
arithmetic beyond writing 0 and -1e30.
"""

import dataclasses
import json
import logging
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from localai_tpu import functions as jfx  # noqa: E402
from localai_tpu.config.model_config import FunctionsConfig as JaxFunctionsConfig  # noqa: E402
from localai_tpu.functions import constraint as jcst  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu.utils.tokenizer import HFTokenizer as JaxHFTokenizer  # noqa: E402
from localai_tpu_torch import functions as tfx  # noqa: E402
from localai_tpu_torch import native  # noqa: E402
from localai_tpu_torch.config.model_config import FunctionsConfig  # noqa: E402
from localai_tpu_torch.functions import constraint as tcst  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer, HFTokenizer  # noqa: E402

# ---------------------------------------------------------------------------
# fsm


DFA_CASES = [
    (r"abc", "abc", True),
    (r"abc", "abx", False),
    (r"a(b|c)*d", "abcbcd", True),
    (r"a(b|c)*d", "ad", True),
    (r"[0-9]{2,4}", "123", True),
    (r"[0-9]{2,4}", "1", False),
    (r"[0-9]{2,4}", "12345", False),
    (r"[^abc]+", "xyz", True),
    (r"[^abc]+", "xaz", False),
    (r"\{\}", "{}", True),
    (r".*", "anything at all", True),
    (r"(yes|no)", "no", True),
    (r"ab?", "a", True),
]


def _same_dfa(a, b) -> None:
    assert a.start == b.start
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.accept, b.accept)
    np.testing.assert_array_equal(a.byte_class, b.byte_class)


@pytest.mark.parametrize("pattern,text,expect", DFA_CASES)
def test_dfa_matches_as_the_jax_package(pattern, text, expect):
    ours, ref = tfx.compile_dfa(pattern), jfx.compile_dfa(pattern)
    _same_dfa(ours, ref)
    assert ours.matches(text) is ref.matches(text) is expect
    for s in range(ours.trans.shape[0]):
        assert ours.live(s) == ref.live(s)
        assert ours.forced_end(s) == ref.forced_end(s)


@pytest.mark.parametrize("data", [b"ax", b"ab", b"a", b""])
def test_dfa_dead_state_pruning_as_the_jax_package(data):
    ours, ref = tfx.compile_dfa(r"ab"), jfx.compile_dfa(r"ab")
    s = ours.step_bytes(ours.start, data)
    assert s == ref.step_bytes(ref.start, data)
    if data == b"ax":
        assert s == ours.DEAD == ref.DEAD
    if data == b"ab":
        assert ours.accept[s] and ours.forced_end(s)


# ---------------------------------------------------------------------------
# jsonschema


SCHEMAS = {
    "object": {"type": "object", "properties": {
        "name": {"type": "string"}, "n": {"type": "integer"},
        "ok": {"type": "boolean"}}},
    "optional": {"type": "object", "required": ["a"], "properties": {
        "a": {"type": "integer"}, "b": {"type": "string"}}},
    "enum-const-refs": {"type": "object", "properties": {
        "unit": {"enum": ["celsius", "fahrenheit"]},
        "p": {"$ref": "#/$defs/point"}},
        "$defs": {"point": {"type": "number"}}},
    "array": {"type": "array", "minItems": 1, "items": {
        "type": "object", "properties": {"x": {"type": "integer"}}}},
    "free-form": {},
    "pattern-alternation": {"type": "object", "properties": {
        "s": {"type": "string", "pattern": "yes|no"}}},
    "allOf-siblings": {"allOf": [{"type": "object", "properties": {
        "a": {"type": "integer"}}}],
        "properties": {"b": {"type": "string"}}},
    "bounded-string-oneOf": {"oneOf": [
        {"type": "string", "minLength": 1, "maxLength": 3},
        {"type": "null"}, {"const": 7}]},
    "recursive": {"$ref": "#/$defs/n", "$defs": {"n": {
        "type": "object", "properties": {"next": {"$ref": "#/$defs/n"}}}}},
}


@pytest.mark.parametrize("name", list(SCHEMAS))
@pytest.mark.parametrize("order", [None, ["b", "a"]])
def test_schema_to_regex_as_the_jax_package(name, order):
    schema = SCHEMAS[name]
    if name == "recursive":
        for fx in (tfx, jfx):
            with pytest.raises(ValueError):
                fx.schema_to_regex(schema, prop_order=order)
        return
    ours = tfx.schema_to_regex(schema, prop_order=order)
    assert ours == jfx.schema_to_regex(schema, prop_order=order)
    _same_dfa(tfx.compile_dfa(ours), jfx.compile_dfa(ours))


def test_json_object_regex_and_prop_order_as_the_jax_package():
    from localai_tpu.functions.jsonschema import sort_prop_order as jsort
    from localai_tpu_torch.functions.jsonschema import sort_prop_order

    assert tfx.JSON_OBJECT_REGEX == jfx.JSON_OBJECT_REGEX
    for spec in ("name,arguments", " a , ,b", ""):
        assert sort_prop_order(spec) == jsort(spec)


# ---------------------------------------------------------------------------
# constraint: the mask row of every state a greedy walk visits


def _greedy_rows(constraint, tok, prefer: str, limit: int = 120):
    """Greedy walk over the byte tokenizer: the preferred next byte if
    allowed, else the lowest allowed non-EOS token. Returns the text and
    every mask row met on the way."""
    out, rows = [], []
    want = prefer.encode()
    i = 0
    while len(out) < limit and not constraint.done:
        mask = constraint.allowed_mask()
        if mask is None:
            break
        rows.append(np.array(mask))
        if i < len(want) and mask[want[i]] == 0.0:
            t = int(want[i])
            i += 1
        else:
            non_eos = [a for a in np.nonzero(mask == 0.0)[0]
                       if a not in tok.eos_ids]
            if not non_eos:
                break
            t = int(non_eos[0])
        out.append(t)
        constraint.advance(t)
    return tok.decode(out), rows, constraint.done


WEATHER = {"name": "get_weather", "parameters": {
    "type": "object", "properties": {"city": {"type": "string"}},
    "required": ["city"]}}

WALKS = {
    "yes-no": (lambda fx, tok: fx.constraint_for_regex(r"(yes|no)", tok),
               "yes"),
    "ab?": (lambda fx, tok: fx.constraint_for_regex(r"ab?", tok), "ab"),
    "schema": (lambda fx, tok: fx.constraint_for_schema(
        {"type": "object", "properties": {
            "name": {"const": "get_weather"},
            "arguments": {"type": "object",
                          "properties": {"city": {"type": "string"}}}}},
        tok), '{"name":"get_weather","arguments":{"city":"Kyiv"}}'),
    "json-object": (lambda fx, tok: fx.constraint_for_regex(
        fx.JSON_OBJECT_REGEX, tok), '{"a": [1, true, null]}'),
    "enum-bool": (lambda fx, tok: fx.constraint_for_schema(
        {"type": "object", "properties": {
            "unit": {"enum": ["c", "f"]}, "ok": {"type": "boolean"}}},
        tok), '{"unit":"f","ok":false}'),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_constraint_rows_of_a_greedy_walk_as_the_jax_package(name):
    build, prefer = WALKS[name]
    ours = _greedy_rows(build(tfx, ByteTokenizer()), ByteTokenizer(),
                        prefer)
    ref = _greedy_rows(build(jfx, JaxByteTokenizer()), JaxByteTokenizer(),
                       prefer)
    assert ours[0] == ref[0] and ours[2] == ref[2]
    assert len(ours[1]) == len(ref[1]) > 0
    for a, b in zip(ours[1], ref[1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_constraint_caches_rows_per_state_and_dfa():
    tok = ByteTokenizer()
    c = tfx.constraint_for_regex(r"[ab]*", tok)
    c.advance(ord("a"))
    m1 = c.allowed_mask()
    c.advance(ord("b"))
    assert c.allowed_mask() is m1  # self-loop state → the cached row
    assert tcst.cached_dfa(r"[ab]+") is tcst.cached_dfa(r"[ab]+")
    c1 = tfx.constraint_for_regex(r"xy?z", tok)
    c2 = tfx.constraint_for_regex(r"xy?z", tok)
    assert c2.allowed_mask() is c1.allowed_mask()
    assert c1.source_regex == r"xy?z"


# ---------------------------------------------------------------------------
# tools → regex → constraint


def _cfgs(**kw):
    return FunctionsConfig(**kw), JaxFunctionsConfig(**kw)


TOOL_D1 = {"name": "t1", "parameters": {
    "type": "object", "properties": {"a": {"$ref": "#/$defs/d1"}},
    "$defs": {"d1": {"type": "integer"}}}}
TOOL_D2 = {"name": "t2", "parameters": {
    "type": "object", "properties": {"b": {"$ref": "#/$defs/d2"}},
    "$defs": {"d2": {"type": "boolean"}}}}
HYPHEN = {"name": "get-weather", "parameters": {
    "type": "object", "properties": {"c": {"$ref": "#/$defs/city"}},
    "required": ["c"], "$defs": {"city": {"type": "string"}}}}

TOOL_CASES = {
    "single": ([WEATHER], {}),
    "no-action-off": ([WEATHER], {"disable_no_action": True}),
    "parallel-mixed": ([WEATHER], {"grammar": {"parallel_calls": True,
                                               "mixed_mode": True}}),
    "parallel-no-newlines": ([WEATHER], {"grammar": {
        "parallel_calls": True, "disable_parallel_new_lines": True}}),
    "mixed-no-free-string": ([WEATHER], {"grammar": {
        "mixed_mode": True, "no_mixed_free_string": True}}),
    "prefix-name-key": ([WEATHER], {"function_name_key": "function",
                                    "grammar": {"prefix": "TOOL: "}}),
    "strings-after-json": ([WEATHER], {"grammar": {
        "expect_strings_after_json": True,
        "properties_order": "arguments,name"}}),
    "llama3.1": ([WEATHER, HYPHEN], {"grammar": {"schema_type": "llama3.1"}}),
    "defs-merge": ([TOOL_D1, TOOL_D2], {"disable_no_action": True}),
    "grammar-disabled": ([WEATHER], {"grammar": {"disable": True}}),
}


@pytest.mark.parametrize("name", list(TOOL_CASES))
def test_tool_regex_and_constraint_as_the_jax_package(name):
    tools, kw = TOOL_CASES[name]
    cfg, jcfg = _cfgs(**kw)
    wrapped = [{"type": "function", "function": t} for t in tools]
    fns = tfx.normalize_tools(wrapped)
    assert fns == jfx.normalize_tools(wrapped) == tools
    funcs = tfx.inject_no_action(fns, cfg)
    assert funcs == jfx.inject_no_action(fns, jcfg)
    assert (tfx.select_function(funcs, tools[0]["name"])
            == jfx.select_function(funcs, tools[0]["name"]))
    assert tfx.select_function(funcs, "nope") == funcs
    assert (tfx.functions_to_schema(funcs)
            == jfx.functions_to_schema(funcs))
    ours = tfx.build_tool_regex(funcs, cfg)
    ref = jfx.build_tool_regex(funcs, jcfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    c, built = tfx.build_tool_constraint(funcs, cfg, ByteTokenizer())
    jc, jbuilt = jfx.build_tool_constraint(funcs, jcfg, JaxByteTokenizer())
    assert built.pattern == jbuilt.pattern == ours.pattern
    assert (c is None) == (jc is None) == (name == "grammar-disabled")
    if c is not None:
        _same_dfa(c.dfa, jc.dfa)
        np.testing.assert_array_equal(c.allowed_mask(), jc.allowed_mask())


def test_tool_constraint_decodes_a_call_that_parses():
    cfg, jcfg = _cfgs(disable_no_action=True)
    call = '{"name":"get_weather","arguments":{"city":"Paris"}}'
    texts = []
    for fx, tok, fc in ((tfx, ByteTokenizer(), cfg),
                        (jfx, JaxByteTokenizer(), jcfg)):
        c, _ = fx.build_tool_constraint([WEATHER], fc, tok)
        text, _, done = _greedy_rows(c, tok, call)
        calls = fx.parse_function_call(text, fc)
        assert done and calls[0].name == "get_weather"
        assert json.loads(calls[0].arguments) == {"city": "Paris"}
        texts.append(text)
    assert texts[0] == texts[1]


def test_conflicting_defs_raise_on_both():
    other = {"name": "t3", "parameters": {
        "type": "object", "properties": {"a": {"$ref": "#/$defs/d1"}},
        "$defs": {"d1": {"type": "string"}}}}
    for fx in (tfx, jfx):
        with pytest.raises(ValueError, match="conflicting"):
            fx.functions_to_schema([TOOL_D1, other])


# ---------------------------------------------------------------------------
# parse


PARSE_CASES = {
    "single": ('{"name":"add","arguments":{"x":1,"y":2}}', {}),
    "multiple-garbage": ('noise {"name":"a","arguments":{}} mid '
                         '{"name":"b","arguments":{"k":1}}', {}),
    "top-level-array": ('[{"name":"a","arguments":{}},'
                        '{"name":"b","arguments":{}}]', {}),
    "string-arguments": ('{"name":"s","arguments":"{\\"q\\": 1}"}', {}),
    "custom-keys": ('{"function":"f","args":{"q":"z"}}',
                    {"function_name_key": "function",
                     "function_arguments_key": "args"}),
    "json-regex-match": ('prose ```json\n{"name":"f","arguments":{}}``` more',
                         {"json_regex_match": [r"```json\n?(.*?)```"]}),
    "response-regex": ('call=go args={"a":1}', {"response_regex": [
        r"call=(?P<name>\w+) args=(?P<arguments>\{.*\})"]}),
    "response-regex-optional": ("call=go", {"response_regex": [
        r"call=(?P<name>\w+)( args=(?P<arguments>\{.*\}))?"]}),
    "llama31-tags": ('<function=get_weather>{"city":"Rome"}</function>'
                     '<function=x>not json</function>', {}),
    "replacements": ("{'name':'f','arguments':{}}", {
        "replace_function_results": [{"key": r"'", "value": '"'}]}),
    "no-call": ("just prose, no call", {}),
    "unicode-arguments": ('{"name":"u","arguments":{"w":"Zürich ☀"}}', {}),
}


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_function_call_as_the_jax_package(name):
    text, kw = PARSE_CASES[name]
    cfg, jcfg = _cfgs(**kw)
    ours = [dataclasses.asdict(r) for r in tfx.parse_function_call(text, cfg)]
    ref = [dataclasses.asdict(r) for r in jfx.parse_function_call(text,
                                                                  jcfg)]
    assert ours == ref
    assert (name == "no-call") == (not ours)


@pytest.mark.parametrize("text", [
    '{"a":1} x {"b":2} [{"c":3}]', "no json", '{"broken": ', "[1, 2]",
    '{"a": {"b": [1]}} {"c": "}"}'])
def test_parse_json_objects_as_the_jax_package(text):
    assert tfx.parse_json_objects(text) == jfx.parse_json_objects(text)


@pytest.mark.parametrize("text,kw", [
    ("<think>hmm</think>ok", {"replace_llm_results": [
        {"key": r"<think>.*?</think>", "value": ""}]}),
    ("ab", {"replace_llm_results": [{"value": "X"}]}),
    ("<answer>42</answer>", {"capture_llm_results": [
        r"<answer>(.*?)</answer>"]}),
    ("nothing here", {"capture_llm_results": [r"<answer>(.*?)</answer>"]}),
])
def test_cleanup_and_text_content_as_the_jax_package(text, kw):
    cfg, jcfg = _cfgs(**kw)
    assert (tfx.cleanup_llm_result(text, cfg)
            == jfx.cleanup_llm_result(text, jcfg))
    assert (tfx.parse_text_content(text, cfg)
            == jfx.parse_text_content(text, jcfg))


# ---------------------------------------------------------------------------
# vocabulary table and trie of an HF tokenizer


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A tiny byte-level BPE tokenizer trained here, with an EOS token."""
    tk = pytest.importorskip("tokenizers")
    tok = tk.Tokenizer(tk.models.BPE(unk_token=None))
    tok.pre_tokenizer = tk.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tk.decoders.ByteLevel()
    trainer = tk.trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<eos>"],
        initial_alphabet=tk.pre_tokenizers.ByteLevel.alphabet())
    corpus = ['{"name": "get_weather", "arguments": {"city": "Paris"}}',
              "the quick brown fox jumps over the lazy dog", "true false",
              "Zürich, Kyiv and Nice"] * 20
    tok.train_from_iterator(corpus, trainer)
    d = tmp_path_factory.mktemp("bpe")
    tok.save(str(d / "tokenizer.json"))
    (d / "config.json").write_text(json.dumps({"eos_token_id": 0}))
    return d


def test_token_bytes_table_and_trie_of_a_bpe_tokenizer(bpe_dir):
    ours, ref = HFTokenizer(bpe_dir), JaxHFTokenizer(bpe_dir)
    table = tcst.token_bytes_table(ours)
    assert table == jcst.token_bytes_table(ref)
    assert table[0] is None  # the EOS id is never maskable-in
    assert sum(b is not None and len(b) > 1 for b in table) > 20
    trie, jtrie = (tcst.TokenTrie.for_tokenizer(ours),
                   jcst.TokenTrie.for_tokenizer(ref))
    for k in ("parent", "edge", "leaf_of_token", "token_ok"):
        np.testing.assert_array_equal(getattr(trie, k), getattr(jtrie, k))
    schema = {"type": "object", "properties": {"city": {"type": "string"}}}
    c = tfx.constraint_for_schema(schema, ours)
    jc = jfx.constraint_for_schema(schema, ref)
    for piece in ('{"', "city", '":"', "Paris", '"}'):
        np.testing.assert_array_equal(c.allowed_mask(), jc.allowed_mask())
        ids = ours.encode(piece)
        assert ids == ref.encode(piece)
        for t in ids:
            c.advance(t)
            jc.advance(t)
        assert c.state == jc.state
    assert c.done == jc.done


# ---------------------------------------------------------------------------
# the native trie walk


NATIVE_PATTERNS = [r'\{"name": "[a-z]{1,8}"\}', r'\{"x": [0-9]{1,3}\}',
                   tfx.JSON_OBJECT_REGEX]


@pytest.mark.parametrize("pattern", NATIVE_PATTERNS,
                         ids=["name", "digits", "json-object"])
def test_native_walk_and_rows_equal_the_numpy_versions(pattern):
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler on this machine: the numpy walk serves")
    assert tcst._native_fsm() is not None
    assert native.library_path("fsm_walk").exists()
    dfa, jdfa = tcst.cached_dfa(pattern), jcst.cached_dfa(pattern)
    c = tcst.FSMConstraint(dfa, ByteTokenizer())
    jtrie = jcst.TokenTrie.for_tokenizer(JaxByteTokenizer())
    n = dfa.trans.shape[0]
    # every state of the small DFAs; a spread of the JSON object DFA's
    # ~15k states (all of them take ~10 s)
    for state in range(0, n, 1 if n < 1000 else 61):
        walked = c.trie.walk(dfa, state)
        np.testing.assert_array_equal(walked, c.trie.walk_numpy(dfa, state))
        np.testing.assert_array_equal(c._row(state), c.row_numpy(state))
        # and the JAX package's walk over its own trie
        np.testing.assert_array_equal(walked, jtrie.walk(jdfa, state))


def test_no_compiler_falls_back_to_numpy_with_one_warning(
        monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setenv("LOCALAI_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))  # no cc/gcc/clang here
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.load("fsm_walk") is None
        assert native.load("fsm_walk") is None  # cached: no second try
    assert len([r for r in caplog.records
                if "fsm_walk unavailable" in r.getMessage()]) == 1
    monkeypatch.setattr(tcst, "_native_lib", None)  # the numpy path
    tok = ByteTokenizer()
    c = tfx.constraint_for_regex(r"[ab]{2}", tok)
    jc = jfx.constraint_for_regex(r"[ab]{2}", JaxByteTokenizer())
    np.testing.assert_array_equal(c.allowed_mask(), jc.allowed_mask())
    monkeypatch.setattr(tcst, "_native_lib", tcst._NATIVE_SENTINEL)
