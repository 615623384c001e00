"""The PyTorch port's YAML reader against PyYAML's ``safe_load``.

The machine with the card has no PyYAML, so the port reads model configs
with its own reader (``config/yaml_subset.py``). It must give what
``yaml.safe_load`` gives on what model YAMLs use — handwritten
gallery-style configs, and config-shaped dicts dumped by ``yaml.safe_dump``
in block and in flow style (hypothesis), anchors, aliases and merge keys
as the upstream gallery index writes them — and refuse, naming the line,
what it does not take. The port's ``safe_dump`` (a gallery install's
config) reads back through both readers to the object dumped.
"""

import math
import string

import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu_torch.config.loader import load_config_file  # noqa: E402
from localai_tpu_torch.config.yaml_subset import (  # noqa: E402
    safe_dump,
    safe_load,
)


def _same(a, b) -> bool:
    """Equal values of equal types (nan equal to nan, keys in order)."""
    if isinstance(a, float) and isinstance(b, float) and \
            math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _check(text: str) -> None:
    want = yaml.safe_load(text)
    got = safe_load(text)
    assert _same(got, want), (text, got, want)


LLAMA3_GALLERY = """\
---
# a gallery-style config: Go templates in block scalars
name: llama3-instruct
context_size: 8192
f16: true
backend: jax
mmap: yes
parameters:
  model: Meta-Llama-3-8B-Instruct.Q4_K_M.gguf
  temperature: 0.7
  top_k: 40
  top_p: .95
  seed: -1
stopwords:
- <|im_end|>
- "<|eot_id|>"
- '<dummy32000>'
template:
  chat_message: |
    <|start_header_id|>{{if eq .RoleName "assistant"}}assistant{{else if eq .RoleName "system"}}system{{else if eq .RoleName "tool"}}tool{{else if eq .RoleName "user"}}user{{end}}<|end_header_id|>

    {{ if .FunctionCall -}}
    Function call:
    {{ else if eq .RoleName "tool" -}}
    Function response:
    {{ end -}}
    {{ if .Content -}}
    {{.Content -}}
    {{ else if .FunctionCall -}}
    {{ toJson .FunctionCall -}}
    {{ end -}}
    <|eot_id|>
  chat: |
    <|begin_of_text|>{{.Input }}
    <|start_header_id|>assistant<|end_header_id|>
  completion: |-
    {{.Input}}
  function: >-
    You are a function calling AI model.
    Here are the available tools:
      {{range .Functions}}{{toJson .}}{{end}}

    Use them.
usage: |
    curl http://localhost:8080/v1/chat/completions -d '{"model": "x"}'
"""

HANDWRITTEN = [
    LLAMA3_GALLERY,
    "a: 1\nb: 1.5\nc: 1e3\nd: 1.0e+3\ne: yes\nf: Off\ng: ~\nh:\ni: null\n"
    "j: 0x1F\nk: 017\nl: 1:30\nm: .inf\nn: -.INF\no: 1_000\np: +12\n"
    "q: 0b101\nr: 1.\ns: .5\nt: .nan\nu: 'yes'\nv: \"1e3\"\n",
    "stopwords: [\"<|im_end|>\", '</s>', plain, 3, true, null]\n",
    "k: {a: 1, b: [x, y], c: {}, d: []}\nj: [\n  1,\n  2,\n]\n",
    "t: |+\n  keep\n\n\nnext: 1\n",
    "t: >\n  folded\n  text\n\n  para\n   more\n  back\nx: 2\n",
    "t: >-\n  a\n  b\n",
    "t: |2\n    two extra\n  base\n",
    "t: |-2\n    two extra\n  base\n",
    "- a: 1\n  b: [1, 2]\n- c: {x: 1, y: [a, b]}\n- - n1\n  - n2\n- \n"
    "- plain\n",
    "a:\n  b:\n    c:\n      d: deep\n  e: 1\n",
    "k: \"esc \\t \\n \\x41 \\u00e9 \\U0001F600 \\\\ \\\" \\/ \\0 \\e \\N\"\n",
    "k: 'it''s'\n",
    "k: \"line one\n  line two\n\n  line three\"\n",
    "k: 'a\n\n  b'\n",
    "k: \"a\\\n   b\"\n",
    "k: long plain\n  continued here\n\n  and para\n",
    "# comment\nk: v # trailing\n# end\n",
    "url: http://example.com:8080/x\nk: a:b\nw: x#y\n",
    "a:\n- x\n- y\nb: 1\n",
    "top:\n  - name: n\n    template: |\n      line1\n      line2\n    other: 1\n"
    "  - name: m\n",
    "a: -x\nb: :x\nc: ?x\nd: -1\n",
    "a: b\n...\n",
    "yes: no\n1: 2\n",
    "a: |\n  x\n     \n  y\n",
    "a: >\n\n  folded\n    indented\n  back\n",
    "k: \"\"\nj: ''\n",
    "text: |\n  {{- if .System }}{{ .System }}{{ end }}\n  {{- range .Messages }}\n"
    "  {{ .Role }}: {{ .Content }}\n  {{- end }}\n",
]


@pytest.mark.parametrize("text", HANDWRITTEN,
                         ids=[f"doc{i}" for i in range(len(HANDWRITTEN))])
def test_reader_equals_safe_load_on_handwritten_configs(text):
    _check(text)


def test_gallery_config_loads_into_the_ports_fields(tmp_path):
    p = tmp_path / "llama3.yaml"
    p.write_text(LLAMA3_GALLERY)
    cfg = load_config_file(p)
    want = yaml.safe_load(LLAMA3_GALLERY)
    assert cfg.template.chat_message == want["template"]["chat_message"]
    assert cfg.template.chat == want["template"]["chat"]
    assert cfg.stopwords == ["<|im_end|>", "<|eot_id|>", "<dummy32000>"]
    assert cfg.parameters.temperature == 0.7 and cfg.context_size == 8192


_KEYS = st.text(alphabet=string.ascii_letters + string.digits + "_-",
                min_size=1, max_size=12)
_TEXT = st.text(alphabet=st.characters(
    blacklist_categories=("Cs",),
    blacklist_characters="\x85\u2028\u2029\ufeff"), max_size=60)
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-10**12, 10**12),
    st.floats(allow_nan=False), _TEXT,
    st.sampled_from(["yes", "no", "on", "1e3", "0x1F", "017", "1:30", "~",
                     "null", "", " x ", "a: b", "- x", "#c",
                     "{{ .Input }}", "<|im_end|>", "line1\nline2\n",
                     "  indented\nx\n"]))
_VALUES = st.recursive(_SCALARS, lambda ch: st.one_of(
    st.lists(ch, max_size=4), st.dictionaries(_KEYS, ch, max_size=4)),
    max_leaves=15)


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.dictionaries(_KEYS, _VALUES, max_size=6),
       st.sampled_from([False, True, None]), st.sampled_from([20, 80, 1000]),
       st.booleans(), st.sampled_from([2, 4]))
def test_reader_equals_safe_load_on_dumped_configs(doc, flow, width,
                                                   unicode, indent):
    """Config-shaped dicts through ``yaml.safe_dump`` in block, flow and
    mixed style, narrow and wide, with and without raw unicode."""
    _check(yaml.safe_dump(doc, default_flow_style=flow, width=width,
                          allow_unicode=unicode, indent=indent))


class _LiteralDumper(yaml.SafeDumper):
    pass


_LiteralDumper.add_representer(str, lambda d, s: d.represent_scalar(
    "tag:yaml.org,2002:str", s, style="|" if "\n" in s else None))


class _FoldedDumper(yaml.SafeDumper):
    pass


_FoldedDumper.add_representer(str, lambda d, s: d.represent_scalar(
    "tag:yaml.org,2002:str", s, style=">" if "\n" in s else None))

_LINES = st.lists(st.text(alphabet=string.ascii_letters + " {}.|<>-:#'\"\t",
                          max_size=20), min_size=1, max_size=6)
_BODIES = st.builds(lambda ls, tail: "\n".join(ls) + tail, _LINES,
                    st.sampled_from(["", "\n", "\n\n", "\n\n\n"]))


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.dictionaries(_KEYS, st.recursive(
    st.one_of(_BODIES, st.integers()), lambda ch: st.one_of(
        st.lists(ch, max_size=3), st.dictionaries(_KEYS, ch, max_size=3)),
    max_leaves=8), max_size=4),
    st.sampled_from([_LiteralDumper, _FoldedDumper]), st.sampled_from([2, 4]))
def test_reader_equals_safe_load_on_block_scalars(doc, dumper, indent):
    """Multi-line strings dumped as literal (``|``) and folded (``>``)
    block scalars, with every chomping PyYAML picks."""
    _check(yaml.dump(doc, Dumper=dumper, default_flow_style=False,
                     indent=indent))


@pytest.mark.parametrize("text,line,what", [
    ("name: m\n\nx: !!str 1\n", 3, "tags"),
    ("name: m\nx: !custom\n  a: 1\n", 2, "tags"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("? a\n: b\n", 1, "complex keys"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    ("a: 1\nwhen: 2001-12-14\n", 2, "timestamps"),
], ids=["tag", "tag-on-mapping", "documents", "complex-key", "directive",
        "timestamp"])
def test_reader_refuses_what_it_does_not_take(text, line, what):
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        safe_load(text)


# the upstream gallery index's idiom: an anchored entry, then entries that
# merge it and override a few keys
GALLERY_INDEX = """\
- &llama3
  url: "github:mudler/LocalAI/gallery/llama3-instruct.yaml@master"
  name: "llama3-8b-instruct"
  license: llama3
  description: |
    Meta developed and released the Meta Llama 3 family.
  urls:
    - https://huggingface.co/meta-llama/Meta-Llama-3-8B-Instruct
  tags:
    - llm
    - gguf
  overrides:
    parameters:
      model: Meta-Llama-3-8B-Instruct.Q4_0.gguf
  files:
    - filename: Meta-Llama-3-8B-Instruct.Q4_0.gguf
      sha256: 19ded996fe6c60254dc7544d782276eff41046ed42aa5f2d0005dc457e5c0895
      uri: huggingface://QuantFactory/Meta-Llama-3-8B-Instruct-GGUF/x.gguf
- !!merge <<: *llama3
  name: "llama3-8b-instruct:Q6_K"
  overrides:
    parameters:
      model: Meta-Llama-3-8B-Instruct.Q6_K.gguf
- <<: *llama3
  name: "llama3-8b-instruct-merged-plain"
  tags: [llm]
"""


@pytest.mark.parametrize("text", [
    GALLERY_INDEX,
    "base: &b 1\nx: *b\n",
    "a: &x\n  p: 1\n  q: [1, 2]\nb: *x\nc: [*x, *x]\n",
    "a: &x\nb: *x\n",
    "- &a name: x\n- *a\n",
    "&k key: v\nother: *k\n",
    "a: &s [1, 2]\nb: *s\n",
    "a: &x\n- 1\n- 2\nb: *x\n",
    "a: &x !!merge\n",
    "a: {x: 1, y: 2}\nb:\n  <<: {y: 5, z: 6}\n  x: 0\n",
    "b: &b {p: 1}\nc:\n  <<: [*b, {p: 2, q: 3}]\n  r: 4\n",
    "m: &m {a: 1}\nn:\n  !!merge <<: *m\n  b: 2\n  <<: {c: 3, a: 9}\n",
    "a: &q {x: 1, y: 2}\nb: {<<: *q, y: 5, !!merge <<: {z: 0}}\n",
    "a: &a\n  b: &b\n    c: 1\n  d: *b\ne:\n  <<: *a\n  f: *b\n",
    "'<<': 1\n\"<<\": 2\n",
    "a: &x 1\nb: &y two\nc: [*x, *y]\n",
], ids=["gallery-index", "scalar-alias", "mapping-alias", "empty-anchor",
        "anchored-key", "anchored-first-key", "flow-alias", "indentless-alias",
        "merge-tagged-empty", "merge-mapping", "merge-sequence",
        "merge-twice", "flow-merge", "nested-anchors", "quoted-merge-key",
        "flow-aliases"])
def test_reader_equals_safe_load_on_anchors_aliases_and_merges(text):
    """Anchors, aliases and merge keys (``<<:`` and ``!!merge <<:``, of a
    mapping or a sequence of mappings; explicit keys win) as PyYAML's
    ``SafeLoader`` reads them, key order included."""
    if "a: &x !!merge" in text:
        # a merge tag on a value: PyYAML has no constructor for it, and
        # the port refuses it naming the line
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)
        with pytest.raises(ValueError, match="line 1: .*tags"):
            safe_load(text)
        return
    _check(text)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\nb: &x 2\n", 2),          # an anchor defined twice
    ("a: *nope\n", 1),                   # an undefined alias
    ("a: 1\n<<: 3\n", 2),               # a merge of a scalar
    ("a:\n  <<: [1, {b: 2}]\n", 2),     # a list holding a scalar
    ("a: <<\n", 1),                      # the merge key as a value
    ("a: &x *y\n", 1),                   # an alias with an anchor
], ids=["duplicate", "undefined", "scalar-merge", "list-merge", "merge-value",
        "anchored-alias"])
def test_reader_raises_on_bad_anchors_and_merges(text, line):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match=f"line {line}:"):
        safe_load(text)


def test_gallery_index_lists_the_merged_entries():
    entries = safe_load(GALLERY_INDEX)
    assert [e["name"] for e in entries] == [
        "llama3-8b-instruct", "llama3-8b-instruct:Q6_K",
        "llama3-8b-instruct-merged-plain"]
    assert entries[1]["files"] == entries[0]["files"]
    assert entries[1]["overrides"]["parameters"]["model"].endswith("Q6_K.gguf")
    assert entries[2]["tags"] == ["llm"] and entries[2]["license"] == "llama3"


# -- the writer ---------------------------------------------------------------

_TEMPLATES = st.sampled_from([
    "{{.Input}}\n", "{{- if .System}}\n<|im_start|>system\n{{.System}}"
    "<|im_end|>\n{{- end}}\n", "  leading spaces\nthen text", "\n\nx\n\n",
    "a\n \n\tb", "tab\tinside\nline", "trailing  \nspaces  ",
    "ends\n\n\n", "\n", "é ünïcode\n✓", "carriage\r\nreturn",
    "nul\x00byte\n", "bell\x07", "line\u2028sep\n"])
_DUMP_SCALARS = st.one_of(
    _SCALARS, _TEMPLATES, st.sampled_from([
        "true", "False", "NULL", "~", "", "0o17", "0x1F", "1_000", "+1",
        ".5", "-.inf", ".NaN", "1e3", "1.0e+3", "2001-12-14", "12:30:00",
        "<<", "=", "---", "...", "- a", "? b", "#c", "a #b", "k: v",
        "*alias", "&anchor", "!tag", "%d", "@x", "`x", "[1]", "{a: 1}",
        "|", ">", "'q'", '"q"']))
_DUMP_VALUES = st.recursive(_DUMP_SCALARS, lambda ch: st.one_of(
    st.lists(ch, max_size=4), st.dictionaries(
        st.one_of(_KEYS, st.sampled_from(["1", "yes", "null", "a b", "x:y",
                                          "", "-k"]), st.integers(-5, 5)),
        ch, max_size=4)), max_leaves=15)


@settings(max_examples=400, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_DUMP_VALUES)
def test_safe_dump_reads_back_through_both_readers(doc):
    """The port's ``safe_dump`` of config-shaped values (multi-line Go
    templates, strings that look like numbers, booleans or null, empty
    strings, nested lists and maps) reads back to the object dumped, by
    PyYAML's ``safe_load`` and by the port's own reader."""
    text = safe_dump(doc, sort_keys=False)
    assert _same(yaml.safe_load(text), doc), text
    assert _same(safe_load(text), doc), text


def test_safe_dump_writes_templates_as_literal_blocks():
    text = safe_dump({"name": "m", "template": {"chat": "{{.Input}}\n"},
                      "stopwords": ["<|eot_id|>", "yes"], "f16": True,
                      "temperature": 0.2, "empty": {}, "none": None})
    assert text == (
        "name: m\ntemplate:\n  chat: |\n    {{.Input}}\nstopwords:\n"
        "  - <|eot_id|>\n  - \"yes\"\nf16: true\ntemperature: 0.2\n"
        "empty: {}\nnone: null\n")


@pytest.mark.parametrize("text", ["a: b: c\n", "a: 'x' y\n", "a: [1, 2\n",
                                  "a:\tb\n", "- a\nb: 1\n", "a: \"\\q\"\n"])
def test_reader_raises_where_safe_load_raises(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match="line"):
        safe_load(text)
