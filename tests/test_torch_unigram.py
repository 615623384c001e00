"""The port's Unigram model, SentencePiece ``Precompiled`` normalizer and
grapheme walk against ``tokenizers``, on the CPU.

Unigram models are trained with ``tokenizers.trainers.UnigramTrainer`` on
text in the repo; the ``precompiled_charsmap`` comes from the port's own
writer (``utils/spm.py::charsmap_bytes``): the NFKC mappings of a few
hundred code points (full-width forms, circled and super/subscript
digits, ligatures, compatibility jamo, Roman numerals, spaces) and a
multi-code-point key (``e`` U+0301 → U+00E9). Both forms of T5's
``tokenizer.json`` are held to ``tokenizers`` (ids, decoded text, the
``$A </s>`` post-processor): the older converted file (``Precompiled``
alone, then ``WhitespaceSplit`` and ``Metaspace`` with
``add_prefix_space``) and ``transformers``' current ``T5Converter`` output
(``Precompiled``, ``Strip`` right, runs of spaces to "▁", ``Metaspace``
with a prepend scheme and ``split``). The corpus holds full-width forms,
combining marks, Hangul syllables and jamo, emoji ZWJ and flag sequences,
CR LF, runs of spaces and the empty string; hypothesis draws more from
its characters. The two first-prefix cases of the Rust walk are
reproduced, the writer's blobs are read back by
``tokenizers.normalizers.Precompiled``, and the grapheme clusters whose
break classes this interpreter's Unicode 15.0 tables cannot give (marks
of Unicode 16.0) are recorded by name.
"""

import base64
import json
import unicodedata
from pathlib import Path

import pytest

pytest.importorskip("torch")
tokenizers = pytest.importorskip("tokenizers")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import Tokenizer, models, normalizers  # noqa: E402
from tokenizers import pre_tokenizers, trainers  # noqa: E402

from localai_tpu_torch.utils import spm  # noqa: E402
from localai_tpu_torch.utils.hf_tokenizer import TokenizerJSON  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

CODE_POINTS = (list(range(0xFF01, 0xFF5F)) + list(range(0x2460, 0x2474))
               + list(range(0x2070, 0x209D)) + list(range(0xFB00, 0xFB07))
               + list(range(0x3131, 0x318F)) + list(range(0x2160, 0x2180))
               + [0x00A0, 0x3000, 0x2126, 0x212B, 0x00BD, 0x2026])


def nfkc_table() -> dict:
    table = {}
    for cp in CODE_POINTS:
        c = chr(cp)
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            table[c] = n
    table["é"] = "é"
    return table


TABLE = nfkc_table()
CHARSMAP = base64.b64encode(spm.charsmap_bytes(TABLE)).decode()

CORPUS = [
    "Hello world, this is a test.",
    "ｆｕｌｌ－ｗｉｄｔｈ　ＡＢＣ　１２３！",
    "café näive é́ á̀ Z̧",
    "한국어 가나다 각 각 ㄱㅏ",
    "family 👨‍👩‍👧‍👦 ok 👍🏽 flags 🇫🇷🇩🇪🇺",
    "line one\r\nline two\rthree\nfour",
    "  many    spaces   between  ",
    "",
    " ",
    "tabs\tand no-break　spaces",
    "ﬁne ﬂow Ⅻ ① ² ½ Ω Å…",
    "</s> a tail <pad>",
    "zzqqxx ☃ 漢字 ʘ",
]


@pytest.fixture(scope="module")
def trained():
    """A Unigram model trained on the README with T5's three specials."""
    text = (REPO / "README.md").read_text(encoding="utf-8")[:120_000]
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.train_from_iterator([text] + CORPUS, trainers.UnigramTrainer(
        vocab_size=900, special_tokens=["<pad>", "</s>", "<unk>"],
        unk_token="<unk>"))
    return json.loads(tok.to_str())


def with_pipeline(spec: dict, form: str, scheme: str = "always") -> dict:
    spec = json.loads(json.dumps(spec))
    pre = {"type": "Precompiled", "precompiled_charsmap": CHARSMAP}
    eos = spec["model"]["vocab"].index(["</s>", 0.0]) \
        if ["</s>", 0.0] in spec["model"]["vocab"] else 1
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "</s>", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": "</s>", "type_id": 0}},
                 {"Sequence": {"id": "B", "type_id": 0}},
                 {"SpecialToken": {"id": "</s>", "type_id": 0}}],
        "special_tokens": {"</s>": {"id": "</s>", "ids": [eos],
                                    "tokens": ["</s>"]}}}
    if form == "older":
        meta = {"type": "Metaspace", "replacement": "▁",
                "add_prefix_space": True}
        spec["normalizer"] = pre
        spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"}, meta]}
        spec["decoder"] = dict(meta)
    else:
        meta = {"type": "Metaspace", "replacement": "▁",
                "prepend_scheme": scheme, "split": True}
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            pre, {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": "▁"}]}
        spec["pre_tokenizer"] = meta
        spec["decoder"] = dict(meta)
    return spec


FORMS = [("older", "always"), ("converter", "always"),
         ("converter", "first")]


@pytest.fixture(scope="module", params=FORMS,
                ids=[f"{f}-{s}" for f, s in FORMS])
def pair(request, trained):
    spec = with_pipeline(trained, *request.param)
    return Tokenizer.from_str(json.dumps(spec)), TokenizerJSON(spec)


def same(ref, mine, text):
    want = ref.encode(text, add_special_tokens=False).ids
    assert mine.encode(text) == want, text
    assert mine.decode(want) == ref.decode(want, skip_special_tokens=False)
    assert mine.encode(text, add_special_tokens=True) == \
        ref.encode(text).ids


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_ids_and_text_equal_tokenizers(pair, text):
    same(*pair, text)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet="".join(sorted(set("".join(CORPUS)) | set(TABLE)
                                        - {"́"})) + "́",
               max_size=40))
def test_hypothesis_texts_equal_tokenizers(trained, text):
    for form in FORMS:
        spec = with_pipeline(trained, *form)
        same(Tokenizer.from_str(json.dumps(spec)), TokenizerJSON(spec),
             text)


def test_viterbi_scores_unknowns_and_fuses_them(trained):
    """Characters no piece covers become ``unk_id``, consecutive ones one
    id, scored at the lowest score less 10, as ``tokenizers`` does."""
    spec = with_pipeline(trained, "converter")
    ref, mine = Tokenizer.from_str(json.dumps(spec)), TokenizerJSON(spec)
    text = "qq ⊕⊗⊘ x ⊕ y ⊗⊘"
    ids = mine.encode(text)
    assert ids == ref.encode(text, add_special_tokens=False).ids
    assert ids.count(spec["model"]["unk_id"]) >= 3


def test_byte_fallback_equals_tokenizers(trained):
    """``byte_fallback``: an unknown run becomes its UTF-8 bytes as
    ``<0xXX>`` pieces; the ``ByteFallback`` decoder reads them back."""
    spec = with_pipeline(trained, "converter")
    vocab = spec["model"]["vocab"]
    low = min(s for _, s in vocab) - 1.0
    vocab += [[f"<0x{b:02X}>", low] for b in range(256)]
    spec["model"]["byte_fallback"] = True
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"}, spec["decoder"]]}
    ref, mine = Tokenizer.from_str(json.dumps(spec)), TokenizerJSON(spec)
    for text in ("⊕ café ⊗⊘ 漢", "plain words", "👨‍👩"):
        same(ref, mine, text)


@pytest.mark.parametrize("keys,text,want", [
    ({"e": "E", "é": "é"}, "é", "E"),
    ({"é": "é"}, "é́", "é"),
], ids=["shortest-key-wins", "rest-of-cluster-dropped"])
def test_first_prefix_cases(keys, text, want):
    """A cluster under 6 bytes takes the FIRST (shortest) key that
    prefixes it and drops the rest of the cluster."""
    blob = spm.charsmap_bytes(keys)
    assert normalizers.Precompiled(blob).normalize_str(text) == want
    assert spm.Charsmap(blob).normalize(text) == want
    spec = {"model": {"type": "Unigram", "unk_id": 0,
                      "vocab": [["<unk>", 0.0], ["E", -1.0],
                                ["é", -1.0]]},
            "normalizer": {"type": "Precompiled", "precompiled_charsmap":
                           base64.b64encode(blob).decode()}}
    ref, mine = Tokenizer.from_str(json.dumps(spec)), TokenizerJSON(spec)
    assert mine.encode(text) == ref.encode(text).ids


def test_charsmap_writer_reads_back_in_tokenizers():
    """Every key of the writer's blob, and every corpus text, normalizes
    alike in ``tokenizers``' ``Precompiled`` and the port's reader."""
    blob = spm.charsmap_bytes(TABLE)
    assert len(blob[4:4 + int.from_bytes(blob[:4], "little")]) % 1024 == 0
    ref, mine = normalizers.Precompiled(blob), spm.Charsmap(blob)
    for text in list(TABLE) + CORPUS:
        assert mine.normalize(text) == ref.normalize_str(text), text
    for key, value in TABLE.items():
        assert mine.transform(key) == value


def test_refused_charsmaps():
    with pytest.raises(ValueError, match="shorter"):
        spm.Charsmap(b"\0")
    with pytest.raises(ValueError, match="trie"):
        spm.Charsmap(b"\x08\0\0\0\0")
    with pytest.raises(ValueError, match="empty"):
        spm.charsmap_bytes({"": "x"})


# Unicode 16.0 marks this interpreter's Unicode 15.0 tables leave
# unassigned: ``tokenizers`` keeps each with the letter before it (one
# cluster, looked up whole: the key "a" wins and the mark is dropped),
# the port breaks before it and maps it on its own
GRAPHEME_DIVERGENT = [("aࢗ", "ARABIC PEPET"),
                      ("a\U00010D69", "GARAY VOWEL SIGN E"),
                      ("a\U0001E5EE", "OL ONAL SIGN MU")]


@pytest.mark.parametrize("text,name", GRAPHEME_DIVERGENT,
                         ids=[g[1] for g in GRAPHEME_DIVERGENT])
def test_recorded_grapheme_divergences(text, name):
    table = {c: f"<{c}>" for c in text}
    blob = spm.charsmap_bytes(table)
    assert normalizers.Precompiled(blob).normalize_str(text) == "<a>"
    assert spm.Charsmap(blob).normalize(text) == f"<a><{text[1]}>"
    assert unicodedata.category(text[1]) == "Cn"
    assert spm.graphemes(text) == ["a", text[1]]


@pytest.mark.parametrize("text,clusters", [
    ("a\r\nb", ["a", "\r\n", "b"]),
    ("각각", ["각", "각"]),
    ("👨‍👩‍👧x", ["👨‍👩‍👧", "x"]),
    ("🇫🇷🇩🇪🇺", ["🇫🇷", "🇩🇪", "🇺"]),
    ("👍🏽!", ["👍🏽", "!"]),
    ("é́x", ["é́", "x"]),
    ("؀a", ["؀a"]),
    ("किx", ["कि", "x"]),
    ("", []),
], ids=["crlf", "hangul", "zwj", "flags", "modifier", "marks", "prepend",
        "spacing-mark", "empty"])
def test_grapheme_clusters(text, clusters):
    assert spm.graphemes(text) == clusters
