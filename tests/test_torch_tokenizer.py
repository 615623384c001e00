"""The port's ``tokenizer.json`` reader against ``tokenizers``.

The card's machine has neither ``tokenizers`` nor ``transformers``, so the
port reads a checkpoint's ``tokenizer.json`` itself
(``utils/hf_tokenizer.py``). Here its ``load_tokenizer(dir)`` is held to
the JAX package's (which loads the same file through ``tokenizers``) on
four tokenizers, each trained or built here:

  (a) a Llama-3-style byte-level BPE (Llama-3's split pattern,
      ``ignore_merges``, Llama-3's special added tokens);
  (b) a Qwen2-style one (NFC, single ``\\p{N}`` digits, ChatML tokens);
  (c) a Llama-2/Mistral-style SentencePiece BPE (Prepend/Replace
      normalizer, ``byte_fallback``, the Replace/ByteFallback/Fuse/Strip
      decoder) and a Metaspace variant (pre-tokenizer and decoder);
  (d) the 128256-id file ``chip_smoke.py`` builds for its checkpoint
      serve.

``encode`` (with and without ``add_bos``), ``decode``, ``vocab_size``,
``eos_ids`` and ``bos_id`` are compared over a corpus of mixed scripts,
emoji, digit runs, ``\\r\\n``, U+001C..U+001F, contractions and
added-token strings inside text, and (hypothesis) over arbitrary Unicode
text; streamed deltas of ``IncrementalDetokenizer`` over both decoders
are compared too. Components the reader lacks are refused at load.
"""

import functools
import json
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
tokenizers = pytest.importorskip("tokenizers")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import (  # noqa: E402
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    trainers,
)

from localai_tpu.engine.stream import (  # noqa: E402
    IncrementalDetokenizer as JaxDetok,
)
from localai_tpu.functions.constraint import (  # noqa: E402
    token_bytes_table as jax_token_bytes_table,
)
from localai_tpu.models import registry as jax_registry  # noqa: E402
from localai_tpu.utils import tokenizer as jax_tok  # noqa: E402
from localai_tpu_torch.engine.stream import IncrementalDetokenizer  # noqa: E402
from localai_tpu_torch.functions.constraint import token_bytes_table  # noqa: E402
from localai_tpu_torch.models import registry as port_registry  # noqa: E402
from localai_tpu_torch.utils import hf_tokenizer  # noqa: E402
from localai_tpu_torch.utils import tokenizer as port_tok  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LLAMA3_PATTERN = chip_smoke.LLAMA3_SPLIT_PATTERN
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                 r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                 r"|\s+")

# training text: several scripts, code, digits, contractions
TRAIN = [
    "The quick brown fox jumps over the lazy dog. It's what they'd "
    "said: we'll see, you're right, I'm sure they've gone.",
    "Caches keep the hot set close; a miss goes to memory, 12345 cycles "
    "or 678 ns, 2024-10-17 at 09:30.",
    "def main(argv):\n    return 0 if argv else 1\n\r\n# done\n",
    "Le café est très bon. Über straße naïve résumé Ñandú.",
    "Быстрая коричневая лиса прыгает через ленивую собаку.",
    "東京は日本の首都です。北京是中国的首都。서울은 한국의 수도입니다.",
    "مرحبا بالعالم. שלום עולם. नमस्ते दुनिया. สวัสดีชาวโลก",
    "Emoji 😀🎉👍🏽 and 🇫🇷 flags; math ∑ ∫ √ ≠ ∞; ½ ¾ ² ³ Ⅻ.",
    "   leading spaces, trailing spaces   \t\ttabs\n\n\nnewlines",
]
# held-out text: everything above plus what the training never saw
CORPUS = TRAIN + [
    "",
    " ",
    "a",
    "HELLO WORLD'S END, IT'S DONE; WE'LL GO. I'M HERE, THEY'VE LEFT",
    "numbers 1 12 123 1234 12345 123456 0.5 -3 1e10 ٣٤٥ ๒๓",
    "line one\r\nline two\r\n\r\nline four\n",
    "separators \x1c\x1d\x1e\x1f between\x1cwords\x1f\x1e",
    "ctrl \x00\x01\x07\x0b\x0c\x7f and nel \x85 nbsp\xa0 ideo　space",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nHi!"
    "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n",
    "text<|eot_id|>more <|eot_id|> spaced<|eot_id|>",
    "<|im_start|>system\nYou are helpful.<|im_end|>\n<|im_start|>user\n"
    "2+2?<|im_end|>\n<|im_start|>assistant\n",
    "<s>[INST] Bonjour [/INST] Salut</s><unk> <s>",
    "half a token <|eot_ and |> and <|not_special|>",
    "zero​width‍join é combining ́alone",
    "long " + "a" * 300 + " word",
    "🧑‍🤝‍🧑 family 👩🏾‍💻 coder 🏳️‍🌈",
    "tabs\tand line separators",
    "mixed123abc456 ABC_def-ghi.jkl",
    "ＦＵＬＬＷＩＤＴＨ ｶﾀｶﾅ ﬁ ligature",
]
LLAMA3_SPECIALS = chip_smoke.LLAMA3_SPECIAL_TOKENS

# Code points where ``tokenizers`` 0.22.2 and this interpreter's
# ``unicodedata`` (15.0.0) disagree, found by probing every code point
# against ``tokenizers`` (ROADMAP, intended divergences):
#  - letters and numbers of Unicode 15.1/16.0: Oniguruma's ``\p{L}``/
#    ``\p{N}`` in ``tokenizers`` take them, Python 3.12's tables have them
#    unassigned, so a split pattern cuts words there;
#  - characters whose normalization data (a combining class, a
#    decomposition) came after the tables of ``tokenizers``' normalizer:
#    ``unicodedata`` reorders or decomposes them, ``tokenizers`` leaves
#    them as they are.
NEWER_LETTERS = [
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D40, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x116D0, 0x116E3), (0x11BC0, 0x11BE0),
    (0x11BF0, 0x11BF9), (0x13460, 0x143FA), (0x16100, 0x1611D),
    (0x16130, 0x16139), (0x16D40, 0x16D6C), (0x16D70, 0x16D79),
    (0x18CFF, 0x18CFF), (0x1CCF0, 0x1CCF9), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5FA), (0x2EBF0, 0x2EE5D)]
NEWER_NORMALIZATION = [
    (0x07FD, 0x07FD), (0x0898, 0x089F), (0x08CA, 0x08D3), (0x09FE, 0x09FE),
    (0x0C3C, 0x0C3C), (0x0D3B, 0x0D3C), (0x0EBA, 0x0EBA), (0x1715, 0x1715),
    (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA), (0x32FF, 0x32FF), (0xA7F2, 0xA7F4),
    (0xA82C, 0xA82C), (0xAB69, 0xAB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50),
    (0x10F82, 0x10F85), (0x11070, 0x11070), (0x1133B, 0x1133B),
    (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x11938, 0x11938),
    (0x1193D, 0x1193E), (0x11943, 0x11943), (0x119E0, 0x119E0),
    (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
    (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97),
    (0x11F41, 0x11F42), (0x16FF0, 0x16FF1), (0x1E030, 0x1E06D),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1F16C, 0x1F16C),
    (0x1FBF0, 0x1FBF9)]
# the texts that show each kind: (tokenizer, stage, text)
DIVERGENT = [("llama3", "pre_tokenizer", "x\u1c89y \U0002EBF0\U0002EBF1k"),
             ("smoke", "pre_tokenizer", "word\U00013460\U00013461end"),
             ("qwen2", "normalizer", "a\u07fd\u0338 b"),
             ("qwen2", "normalizer", "x\u0c3c\u0338"),
             ("NFKC", "normalizer", "era \u32ff\ua7f2")]


def _divergent(text: str) -> bool:
    return any(lo <= ord(c) <= hi for c in text
               for lo, hi in NEWER_LETTERS + NEWER_NORMALIZATION)


def _byte_level_bpe(pattern: str, specials: list[str], vocab_size: int,
                    normalizer=None) -> dict:
    tok = Tokenizer(models.BPE())
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TRAIN * 3, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=specials, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return json.loads(tok.to_str())


def _llama3_style() -> dict:
    spec = _byte_level_bpe(LLAMA3_PATTERN, [], 900)
    spec["model"]["ignore_merges"] = True
    n = len(spec["model"]["vocab"])
    spec["added_tokens"] = [
        {"id": n + i, "content": c, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, c in enumerate(LLAMA3_SPECIALS[:12])]
    return spec


def _qwen2_style() -> dict:
    return _byte_level_bpe(QWEN2_PATTERN,
                           ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                           800, normalizer=normalizers.NFC())


def _spm_style(metaspace: bool) -> dict:
    """A SentencePiece BPE as HF converts Llama-2/Mistral: byte tokens
    <0x00>..<0xFF> after <unk> <s> </s>, then the trained pieces."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    if metaspace:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    else:
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.train_from_iterator(TRAIN * 3, trainers.BpeTrainer(
        vocab_size=700, show_progress=False, special_tokens=[]))
    spec = json.loads(tok.to_str())
    specials = ["<unk>", "<s>", "</s>"]
    pieces = [t for t, _ in sorted(spec["model"]["vocab"].items(),
                                   key=lambda kv: kv[1])]
    order = specials + [f"<0x{b:02X}>" for b in range(256)] + [
        p for p in pieces if p not in specials]
    spec["model"]["vocab"] = {t: i for i, t in enumerate(order)}
    spec["added_tokens"] = [
        {"id": i, "content": c, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, c in enumerate(specials)]
    if metaspace:
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Metaspace", "replacement": "▁",
             "prepend_scheme": "first", "split": True},
            {"type": "ByteFallback"}, {"type": "Fuse"}]}
    else:
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    return spec


def _write(dirpath: Path, spec: dict, config: dict, gen: dict = None):
    dirpath.mkdir(parents=True, exist_ok=True)
    (dirpath / "tokenizer.json").write_text(json.dumps(spec))
    (dirpath / "config.json").write_text(json.dumps(config))
    if gen is not None:
        (dirpath / "generation_config.json").write_text(json.dumps(gen))
    return dirpath


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("tokenizers")
    l3 = _llama3_style()
    n = len(l3["model"]["vocab"])
    out = {
        "llama3": _write(root / "llama3", l3,
                         {"model_type": "llama", "bos_token_id": n,
                          "eos_token_id": n + 9},
                         {"eos_token_id": [n + 1, n + 9]}),
        "qwen2": _write(root / "qwen2", _qwen2_style(),
                        {"model_type": "qwen2", "eos_token_id": 2}),
        "llama2": _write(root / "llama2", _spm_style(False),
                         {"model_type": "llama", "bos_token_id": 1,
                          "eos_token_id": 2}),
        "mistral-metaspace": _write(root / "mistral", _spm_style(True),
                                    {"model_type": "mistral",
                                     "bos_token_id": 1, "eos_token_id": 2}),
    }
    smoke = root / "smoke"
    chip_smoke.write_llama3_tokenizer(smoke)
    (smoke / "config.json").write_text(json.dumps(
        {"model_type": "llama", "bos_token_id": 128000,
         "eos_token_id": 128009}))
    (smoke / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [128001, 128009]}))
    out["smoke"] = smoke
    return out


@pytest.fixture(scope="module")
def pairs(tok_dirs) -> dict:
    """name → (port tokenizer, JAX package's tokenizer)."""
    return {k: (port_tok.load_tokenizer(d), jax_tok.load_tokenizer(d))
            for k, d in tok_dirs.items()}


NAMES = ["llama3", "qwen2", "llama2", "mistral-metaspace", "smoke"]


@pytest.mark.parametrize("name", NAMES)
def test_loads_with_the_reference_attributes(pairs, name):
    port, ref = pairs[name]
    assert type(port).__name__ == "HFTokenizer"
    assert port.vocab_size == ref.vocab_size
    assert port.eos_ids == ref.eos_ids
    assert port.bos_id == ref.bos_id


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("k", range(len(CORPUS)))
def test_encode_decode_equal_on_the_corpus(pairs, name, k):
    port, ref = pairs[name]
    text = CORPUS[k]
    for add_bos in (False, True):
        ids = ref.encode(text, add_bos=add_bos)
        assert port.encode(text, add_bos=add_bos) == ids, (text, add_bos)
    assert port.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("name", NAMES)
def test_decode_equal_on_arbitrary_ids(pairs, name):
    """Random id runs (special ids, partial byte sequences, ids past the
    vocabulary) decode alike, U+FFFD included where it falls."""
    port, ref = pairs[name]
    rng = np.random.default_rng(7)
    V = ref.vocab_size
    for _ in range(300):
        ids = [int(i) for i in rng.integers(0, V + 3, rng.integers(1, 12))]
        assert port.decode(ids) == ref.decode(ids), ids
    for i in range(min(V, 3000)):
        assert port.decode([i]) == ref.decode([i]), i


@pytest.mark.parametrize("name", NAMES)
def test_streamed_deltas_equal(pairs, name):
    """``IncrementalDetokenizer`` deltas over the port's decode equal those
    over the reference's, on encoded text and on random ids."""
    port, ref = pairs[name]
    rng = np.random.default_rng(3)
    streams = [ref.encode(t) for t in CORPUS if t] + [
        [int(i) for i in rng.integers(0, ref.vocab_size, 40)]
        for _ in range(20)]
    for ids in streams:
        a, b = IncrementalDetokenizer(port.decode), JaxDetok(ref.decode)
        assert [a.push(i) for i in ids] == [b.push(i) for i in ids], ids


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(st.characters(blacklist_categories=("Cs",)),
                    max_size=40))
def test_encode_equal_on_arbitrary_text(pairs, name, text):
    """Equal ids, except where the text holds a code point of the recorded
    Unicode-version divergences; decode is equal always."""
    port, ref = pairs[name]
    ids = ref.encode(text)
    got = port.encode(text)
    if not _divergent(text):
        assert got == ids
    assert port.decode(ids) == ref.decode(ids)
    assert port.decode(got) == ref.decode(got)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(parts=st.lists(st.one_of(
    st.sampled_from(LLAMA3_SPECIALS[:12] + ["<|eot_", "|>", "\r\n", "'S"]),
    st.text(st.characters(blacklist_categories=("Cs",)), max_size=8)),
    max_size=8))
def test_added_tokens_inside_arbitrary_text(pairs, parts):
    port, ref = pairs["llama3"]
    text = "".join(parts)
    assert port.encode(text) == ref.encode(text)


@pytest.mark.parametrize("name,stage,text", DIVERGENT)
def test_recorded_unicode_divergences(pairs, name, stage, text):
    """The port follows this interpreter's Unicode 15.0 tables where
    ``tokenizers`` has others (newer letters, older normalization data):
    on these texts the stage's output differs, and it is equal once the
    recorded code points are taken out."""
    if name == "NFKC":
        port = hf_tokenizer._normalizer({"type": "NFKC"})
        ref = normalizers.NFKC().normalize_str
    elif stage == "normalizer":
        port = pairs[name][0]._tok.normalize
        ref = pairs[name][1]._tok.normalizer.normalize_str
    else:
        tok = pairs[name][0]._tok
        pre = pairs[name][1]._tok.pre_tokenizer

        def port(t):
            return [w for w, _ in tok.pre_tokenize([(t, True)])]

        def ref(t):
            return [w for w, _ in pre.pre_tokenize_str(t)]
    assert _divergent(text)
    assert port(text) != ref(text)
    plain = "".join(c for c in text if not _divergent(c))
    assert port(plain) == ref(plain)
    if stage == "normalizer":      # Python's tables move or decompose
        form = "NFKC" if name == "NFKC" else "NFC"
        assert port(text) == unicodedata.normalize(form, text)
    else:                          # unassigned here, a letter to Oniguruma
        assert any(unicodedata.category(c) == "Cn" for c in text)


def test_token_bytes_table_equals_the_reference(pairs):
    """The constraint module's byte table (decode([probe, i]) per id) over
    the port's reader equals the JAX package's over ``tokenizers``."""
    port, ref = pairs["llama3"]
    assert token_bytes_table(port) == jax_token_bytes_table(ref)


def test_smoke_tokenizer_shape(tok_dirs):
    """The smoke's file: 128000 regular tokens, Llama-3's 256 special
    tokens at 128000..128255 under their published names, byte-level
    BPE with Llama-3's split pattern and ``ignore_merges``."""
    spec = json.loads((tok_dirs["smoke"] / "tokenizer.json").read_text())
    assert len(spec["model"]["vocab"]) == 128000
    assert spec["model"]["ignore_merges"] is True
    added = {t["id"]: t["content"] for t in spec["added_tokens"]}
    assert sorted(added) == list(range(128000, 128256))
    assert added[128000] == "<|begin_of_text|>"
    assert added[128006] == "<|start_header_id|>"
    assert added[128009] == "<|eot_id|>"
    assert added[128255] == "<|reserved_special_token_250|>"
    assert spec["pre_tokenizer"]["pretokenizers"][0]["pattern"] == {
        "Regex": LLAMA3_PATTERN}


def test_smoke_golden_prompt_ids_are_the_references(pairs):
    """The prompt ids ``chip_smoke.py`` pins for its checkpoint serve are
    what ``tokenizers`` gives for the golden prompt texts."""
    port, ref = pairs["smoke"]
    golden = chip_smoke.CHECKPOINT_GOLDEN
    assert len(golden) == len(chip_smoke.CHECKPOINT_CHATS)
    for text, ids in golden:
        assert ref.encode(text, add_bos=True) == ids
        assert port.encode(text, add_bos=True) == ids


def test_smoke_golden_prompt_texts_are_the_references():
    """``chip_smoke.llama3_prompt`` of each checkpoint chat is the JAX
    package's rendering of the llama3 family chat template, the one a
    checkpoint with Llama-3's ids is given."""
    from localai_tpu.config.guesser import FAMILY_SETTINGS
    from localai_tpu.templates.chat import apply_tokenizer_template

    template = FAMILY_SETTINGS["llama3"]["chat_template"]
    for chat, (text, _) in zip(chip_smoke.CHECKPOINT_CHATS,
                               chip_smoke.CHECKPOINT_GOLDEN):
        assert apply_tokenizer_template(
            jax_tok.ByteTokenizer(), chat["messages"],
            chat_template=template) == text


def test_resolve_tokenizer_reads_no_weights(tok_dirs, tmp_path):
    """``resolve_tokenizer`` finds a checkpoint's tokenizer by path or
    under the models dir, a debug preset's byte tokenizer, and raises
    the reference's error for an unknown ref."""
    d = tok_dirs["llama3"]
    for ref_, path in ((str(d), "models"), (d.name, str(d.parent))):
        port = port_registry.resolve_tokenizer(ref_, path)
        ref = jax_registry.resolve_tokenizer(ref_, path)
        assert port.encode(CORPUS[0]) == ref.encode(CORPUS[0])
    assert type(port_registry.resolve_tokenizer("debug:tiny")).__name__ \
        == "ByteTokenizer"
    with pytest.raises(FileNotFoundError, match="not found"):
        port_registry.resolve_tokenizer("nowhere", tmp_path)
    with pytest.raises(FileNotFoundError, match="not found"):
        jax_registry.resolve_tokenizer("nowhere", tmp_path)


UNSUPPORTED = [
    ("model", {"type": "WordPiece", "vocab": {"a": 0},
               "unk_token": "a"}, "WordPiece"),
    ("normalizer", {"type": "BertNormalizer"}, "BertNormalizer"),
    # Lowercase is read since the CLIP tokenizers need it, Precompiled
    # since FLUX's T5 does; SentencePiece's Nmt normalizer is not
    ("normalizer", {"type": "Nmt"}, "Nmt"),
    ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
    ("pre_tokenizer", {"type": "UnicodeScripts"}, "UnicodeScripts"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Xx}"},
                       "behavior": "Isolated", "invert": False}, "Xx"),
    ("decoder", {"type": "WordPiece"}, "WordPiece"),
]


@pytest.mark.parametrize("section,value,named", UNSUPPORTED,
                         ids=[u[2] for u in UNSUPPORTED])
def test_unknown_component_is_refused_at_load(tmp_path, section, value,
                                              named):
    """A component the reader lacks, or a BERT component without a field
    that ``tokenizers`` requires (these three specs fail in
    ``Tokenizer.from_str`` too), is refused at load, naming it."""
    spec = {"model": {"type": "BPE", "vocab": {"a": 0, "b": 1},
                      "merges": []}, "added_tokens": []}
    spec[section] = value
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=named):
        port_tok.load_tokenizer(tmp_path)


def test_config_only_directory_is_refused_at_load(tmp_path):
    """ROADMAP §C 11, its open BPE half: a checkpoint with
    ``tokenizer_config.json`` and no ``tokenizer.json`` whose
    ``tokenizer.model`` is a SentencePiece BPE model (Llama-2's, Mistral's)
    goes to ``transformers.AutoTokenizer`` in the reference; the port
    refuses it at load, naming the model type and §C 11, instead of
    failing at the first request (its Unigram half, T5's, is read:
    tests/test_torch_spm.py)."""
    (tmp_path / "tokenizer_config.json").write_text(
        '{"tokenizer_class": "LlamaTokenizer"}')
    # a ModelProto: one piece "a", trainer_spec.model_type = 2 (BPE)
    (tmp_path / "tokenizer.model").write_bytes(
        b"\x0a\x03\x0a\x01a\x12\x02\x18\x02")
    with pytest.raises(ValueError, match=r"BPE .*tokenizer\.json.*§C 11"):
        port_tok.load_tokenizer(tmp_path)


def test_merges_in_both_forms_read_alike(tok_dirs):
    """Merges as ``"a b"`` strings and as ``[a, b]`` pairs give one
    model."""
    spec = json.loads((tok_dirs["llama3"] / "tokenizer.json").read_text())
    merges = spec["model"]["merges"]
    as_pairs = [m.split(" ", 1) if isinstance(m, str) else m for m in merges]
    as_strings = [" ".join(p) for p in as_pairs]
    a = hf_tokenizer.TokenizerJSON(
        dict(spec, model=dict(spec["model"], merges=as_pairs)))
    b = hf_tokenizer.TokenizerJSON(
        dict(spec, model=dict(spec["model"], merges=as_strings)))
    for text in CORPUS:
        assert a.encode(text) == b.encode(text)


def test_oniguruma_white_space_is_not_pythons():
    """U+001C..U+001F are white space to Python's ``\\s`` but not to
    Oniguruma's (nor Unicode's White_Space): the translated ``\\s`` leaves
    them out, as ``tokenizers`` does."""
    rx = hf_tokenizer.onig_regex(r"\s+")
    assert rx.fullmatch(" \t\r\n\x0b\x0c\x85\xa0 　")
    for c in "\x1c\x1d\x1e\x1f":
        assert not rx.match(c)
    pre = pre_tokenizers.ByteLevel(add_prefix_space=False)
    text = "a\x1c b\x1f\x1f  c"
    want = [p for p, _ in pre.pre_tokenize_str(text)]
    got = [w for w, _ in hf_tokenizer._pre_tokenizer(
        {"type": "ByteLevel", "add_prefix_space": False})([(text, True)])]
    assert got == want


# ---------------------------------------------------------------------------
# each component against its ``tokenizers`` counterpart

def _spec_of(section: str, component) -> dict:
    """A ``tokenizers`` component as its ``tokenizer.json`` entry."""
    tok = Tokenizer(models.BPE())
    setattr(tok, section, component)
    return json.loads(tok.to_str())[section]


PLAIN = [t for t in CORPUS if not _divergent(t)] + [
    "a1b22c333 4444", "  lead", "trail  ", "▁already▁marked", "x y"]

PRE = [("bytelevel", pre_tokenizers.ByteLevel(add_prefix_space=True)),
       ("bytelevel-noprefix", pre_tokenizers.ByteLevel(
           add_prefix_space=False)),
       ("bytelevel-noregex", pre_tokenizers.ByteLevel(
           add_prefix_space=True, use_regex=False)),
       ("split-string", pre_tokenizers.Split(" ", behavior="removed")),
       ("digits", pre_tokenizers.Digits(individual_digits=False)),
       ("digits-single", pre_tokenizers.Digits(individual_digits=True)),
       ("sequence", pre_tokenizers.Sequence([
           pre_tokenizers.Digits(individual_digits=True),
           pre_tokenizers.Metaspace(prepend_scheme="always")]))]
PRE += [(f"split-{b}{'-invert' if inv else ''}", pre_tokenizers.Split(
    Regex(r"\s+|\p{N}"), behavior=b, invert=inv))
    for b in ("removed", "isolated", "merged_with_previous",
              "merged_with_next", "contiguous") for inv in (False, True)]
PRE += [(f"metaspace-{sch}{'' if sp else '-nosplit'}",
         pre_tokenizers.Metaspace(prepend_scheme=sch, split=sp))
        for sch in ("first", "always", "never") for sp in (True, False)]


@pytest.mark.parametrize("name,component", PRE, ids=[p[0] for p in PRE])
def test_pre_tokenizer_equals_tokenizers(name, component):
    port = hf_tokenizer._pre_tokenizer(_spec_of("pre_tokenizer", component))
    for text in PLAIN:
        want = [w for w, _ in component.pre_tokenize_str(text)]
        assert [w for w, _ in port([(text, True)])] == want, text


NORM = [("nfc", normalizers.NFC()), ("nfd", normalizers.NFD()),
        ("nfkc", normalizers.NFKC()), ("nfkd", normalizers.NFKD()),
        ("prepend", normalizers.Prepend("▁")),
        ("replace-string", normalizers.Replace(" ", "▁")),
        ("replace-regex", normalizers.Replace(Regex(r"\s+"), " ")),
        ("strip", normalizers.Strip()),
        ("strip-left", normalizers.Strip(left=True, right=False)),
        ("strip-right", normalizers.Strip(left=False, right=True)),
        ("sequence", normalizers.Sequence([
            normalizers.NFKC(), normalizers.Replace(Regex(r"\p{N}"), "#"),
            normalizers.Strip()]))]


@pytest.mark.parametrize("name,component", NORM, ids=[n[0] for n in NORM])
def test_normalizer_equals_tokenizers(name, component):
    port = hf_tokenizer._normalizer(_spec_of("normalizer", component))
    for text in PLAIN:
        assert port(text) == component.normalize_str(text), text


DEC = [("bytelevel", decoders.ByteLevel()),
       ("metaspace", decoders.Metaspace()),
       ("metaspace-never", decoders.Metaspace(prepend_scheme="never")),
       ("replace", decoders.Replace("▁", " ")),
       ("bytefallback", decoders.ByteFallback()),
       ("fuse", decoders.Fuse()),
       ("strip", decoders.Strip(" ", 1, 0)),
       ("strip-both", decoders.Strip("▁", 2, 1)),
       ("sequence", decoders.Sequence([
           decoders.Replace("▁", " "), decoders.ByteFallback(),
           decoders.Fuse(), decoders.Strip(" ", 1, 0)]))]
PIECES = (["▁", "▁▁", "a", "▁b", "Ġx", "Ċ", "é", "<0xE2>", "<0x82>",
           "<0xAC>", "<0x41>", "<0xZZ>", "<0x4>", "<s>", " ", "  ", "ab▁"]
          + [hf_tokenizer.BYTE_CHAR[b] for b in (0xE2, 0x82, 0xAC, 0xF0)])


@pytest.mark.parametrize("name,component", DEC, ids=[d[0] for d in DEC])
def test_decoder_equals_tokenizers(name, component):
    port = hf_tokenizer._decoder(_spec_of("decoder", component))
    rng = np.random.default_rng(5)
    for _ in range(400):
        toks = [PIECES[int(i)] for i in rng.integers(0, len(PIECES),
                                                    rng.integers(0, 7))]
        got = "".join(port(toks))
        try:
            want = component.decode(toks)
        except BaseException as e:  # noqa: BLE001 — a Rust panic
            # Strip panics where its start and stop cuts cross (a token
            # of stripped characters only); the port gives that token ""
            if type(e).__name__ != "PanicException":
                raise
            continue
        assert got == want, toks


def _prefixed_bpe(fuse_unk: bool) -> dict:
    """A BPE with a subword prefix, an end-of-word suffix and an unk
    token, over a Metaspace pre-tokenizer and no decoder."""
    tok = Tokenizer(models.BPE(unk_token="[UNK]", fuse_unk=fuse_unk,
                               continuing_subword_prefix="##",
                               end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.train_from_iterator(TRAIN[:3], trainers.BpeTrainer(
        vocab_size=300, show_progress=False, special_tokens=["[UNK]"],
        continuing_subword_prefix="##", end_of_word_suffix="</w>"))
    return json.loads(tok.to_str())


@pytest.mark.parametrize("fuse_unk", [False, True])
def test_bpe_prefix_suffix_and_unk_equal_tokenizers(fuse_unk):
    spec = _prefixed_bpe(fuse_unk)
    ref = Tokenizer.from_str(json.dumps(spec))
    port = hf_tokenizer.TokenizerJSON(spec)
    assert port.vocab_size == ref.get_vocab_size()
    for text in PLAIN:
        ids = ref.encode(text, add_special_tokens=False).ids
        assert port.encode(text) == ids, text
        assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False)


ADDED_TEXTS = ["foo food afoo foo_ (foo) foo", "x  <mask>  y<mask>z",
               "<mask><mask> <mask>", "bar baz and barbaz, bar  baz",
               "foo<mask>bar baz", "  foo  ", "Foo FOO foó"]


def test_added_token_flags_equal_tokenizers(tok_dirs):
    """``single_word``, ``lstrip``, ``rstrip`` and a ``normalized`` token
    (matched after the Prepend/Replace normalizer) split alike."""
    from tokenizers import AddedToken

    ref = Tokenizer.from_file(str(tok_dirs["llama2"] / "tokenizer.json"))
    ref.add_tokens([AddedToken("foo", single_word=True, normalized=False),
                    AddedToken("<mask>", lstrip=True, rstrip=True,
                               normalized=False),
                    AddedToken("bar baz", normalized=True)])
    port = hf_tokenizer.TokenizerJSON(json.loads(ref.to_str()))
    assert port.vocab_size == ref.get_vocab_size()
    for text in ADDED_TEXTS + PLAIN:
        ids = ref.encode(text, add_special_tokens=False).ids
        assert port.encode(text) == ids, text
        assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False)


def test_token_bytes_table_at_llama3_size(pairs):
    """The byte table over all 128256 ids of the smoke's file equals the
    JAX package's over ``tokenizers``."""
    port, ref = pairs["smoke"]
    assert token_bytes_table(port) == jax_token_bytes_table(ref)


# ---------------------------------------------------------------------------
# WordPiece (BERT): BertNormalizer, BertPreTokenizer, the model, the decoder

REPO_TEXT = [line for name in ("README.md", "SURVEY.md")
             for line in (Path(__file__).resolve().parents[1] / name)
             .read_text(encoding="utf-8").splitlines() if line.strip()]
BERT_SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# what BERT's components treat specially: CJK, accents, control and
# format characters, Unicode and ASCII punctuation, long words, unknowns
BERT_CORPUS = CORPUS + REPO_TEXT[:40] + [
    "Le café est très bon. Über straße naïve résumé Ñandú ÅÇÉÎÕÜ",
    "ΣΑΣ ΟΔΟΣ İstanbul ǅemal ﬁnal ß",
    "東京は日本の首都です。北京是中国的首都。𠀋𡈽 ideographs 가나다",
    "x\x00y�z\x07\x1b tab\there nl\nthere cr\rhere \x85nel ​zw",
    "soft­hyphen bidi‎‮marks⁦",
    "¿Qué? ¡Sí! «quote» — dash… “curly” ‘single’ (paren) [br] {c}",
    "$5.00 & 100% #tag @user ^caret `tick` ~tilde |pipe| \\slash",
    "a" * 30 + " " + "b" * 101 + " ok supercalifragilisticexpialidocious",
    "[CLS] hello [SEP] world[MASK] [UNK] [unused1]",
    "don't do not it's they're I'm we've you're can't won't",
    "emoji 😀🎉 unknown ⟁⟂ symbols ∑∫√",
]


def _wordpiece(lowercase: bool, strip_accents, max_chars: int = 100,
               vocab_size: int = 2000) -> dict:
    """A WordPiece trained with ``tokenizers`` on the repo's README and
    SURVEY, with BERT's normalizer, pre-tokenizer and decoder."""
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]",
                                     max_input_chars_per_word=max_chars))
    tok.normalizer = normalizers.BertNormalizer(
        lowercase=lowercase, strip_accents=strip_accents)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.train_from_iterator(REPO_TEXT, trainers.WordPieceTrainer(
        vocab_size=vocab_size, special_tokens=BERT_SPECIAL_TOKENS,
        show_progress=False))
    return json.loads(tok.to_str())


WORDPIECES = {
    "wp-uncased": dict(lowercase=True, strip_accents=None),
    "wp-cased": dict(lowercase=False, strip_accents=None),
    "wp-uncased-accents": dict(lowercase=True, strip_accents=False),
    "wp-cased-strip": dict(lowercase=False, strip_accents=True),
    "wp-short-words": dict(lowercase=True, strip_accents=None, max_chars=6),
}
WP_NAMES = sorted(WORDPIECES) + ["bert-smoke"]


@pytest.fixture(scope="module")
def wp_pairs(tmp_path_factory) -> dict:
    """name → (port tokenizer, JAX package's tokenizer) over one dir."""
    root = tmp_path_factory.mktemp("wordpiece")
    specs = {k: _wordpiece(**v) for k, v in WORDPIECES.items()}
    specs["bert-smoke"] = chip_smoke.bert_tokenizer_spec()
    out = {}
    for name, spec in specs.items():
        d = _write(root / name, spec, {"model_type": "bert"})
        out[name] = (port_tok.load_tokenizer(d), jax_tok.load_tokenizer(d))
    return out


@functools.lru_cache(maxsize=None)
def _bert_char_divergent(c: str) -> bool:
    """Whether BERT's normalizer and pre-tokenizer treat ``c`` differently
    here and in ``tokenizers`` (whose character classes come from other
    Unicode versions): the pipelines compared on ``a{c}b`` in both
    casings."""
    for lower, strip in ((True, None), (False, False), (False, True)):
        ref_n = normalizers.BertNormalizer(lowercase=lower,
                                           strip_accents=strip)
        port_n = hf_tokenizer._normalizer(_spec_of("normalizer", ref_n))
        text = f"a{c}b"
        if port_n(text) != ref_n.normalize_str(text):
            return True
        words = [w for w, _ in pre_tokenizers.BertPreTokenizer()
                 .pre_tokenize_str(text)]
        if [w for w, _ in hf_tokenizer._bert_pre_tokenize(text, True)] \
                != words:
            return True
    return False


def _bert_divergent(text: str) -> bool:
    return any(_bert_char_divergent(c) for c in set(text))


def test_wordpiece_corpus_has_no_recorded_divergence():
    assert not any(_bert_divergent(t) for t in BERT_CORPUS)


@pytest.mark.parametrize("name", WP_NAMES)
def test_wordpiece_loads_with_the_reference_attributes(wp_pairs, name):
    port, ref = wp_pairs[name]
    assert port.vocab_size == ref.vocab_size
    for tok in BERT_SPECIAL_TOKENS + ["the", "##s", "no-such-token"]:
        assert port.token_to_id(tok) == ref._tok.token_to_id(tok), tok


@pytest.mark.parametrize("name", WP_NAMES)
@pytest.mark.parametrize("k", range(len(BERT_CORPUS)))
def test_wordpiece_encode_decode_equal_on_the_corpus(wp_pairs, name, k):
    port, ref = wp_pairs[name]
    text = BERT_CORPUS[k]
    ids = ref.encode(text, add_bos=False)
    assert port.encode(text, add_bos=True) == ids, text
    assert port.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("name", WP_NAMES)
def test_wordpiece_decode_equal_on_arbitrary_ids(wp_pairs, name):
    """Random id runs (special tokens, ``##`` pieces next to words and
    punctuation, the cleanup's contractions) decode alike."""
    port, ref = wp_pairs[name]
    rng = np.random.default_rng(11)
    V = ref.vocab_size
    for _ in range(300):
        ids = [int(i) for i in rng.integers(0, V, rng.integers(1, 12))]
        assert port.decode(ids) == ref.decode(ids), ids


@pytest.mark.parametrize("name", WP_NAMES)
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(st.characters(blacklist_categories=("Cs",)),
                    max_size=40))
def test_wordpiece_encode_equal_on_arbitrary_text(wp_pairs, name, text):
    """Equal ids, except where a character of the text is classed
    otherwise by ``tokenizers``' Unicode tables; decode is equal always."""
    port, ref = wp_pairs[name]
    ids = ref.encode(text)
    got = port.encode(text)
    if not _bert_divergent(text):
        assert got == ids
    assert port.decode(ids) == ref.decode(ids)
    assert port.decode(got) == ref.decode(got)


# (text, stage): a character of each class whose Unicode data differs
# between this interpreter (15.0) and ``tokenizers`` 0.22.2's tables
BERT_DIVERGENT = [
    ("x࢐y", "clean_text"),     # Cf since Unicode 14: removed here
    ("x⹃y", "punctuation"),    # Po since Unicode 10: isolated here
    ("x࢘y", "strip_accents"),  # Mn since Unicode 14: stripped here
    ("xᲉy", "lowercase"),      # Unicode 16: lowercased there only
]


@pytest.mark.parametrize("text,stage", BERT_DIVERGENT,
                         ids=[b[1] for b in BERT_DIVERGENT])
def test_recorded_bert_unicode_divergences(text, stage):
    """The port classes characters with this interpreter's ``unicodedata``;
    ``tokenizers`` takes BERT's classes from older tables (and lowercases
    with newer ones): each of these characters is divergent, and the
    same text without it is not."""
    assert _bert_divergent(text)
    assert not _bert_divergent(text.replace(text[1], ""))
    if stage == "lowercase":
        assert unicodedata.category(text[1]) == "Cn"


def test_bert_components_equal_tokenizers():
    """BertNormalizer in every setting, BertPreTokenizer and the WordPiece
    decoder (cleanup on and off) against their ``tokenizers``
    counterparts."""
    texts = [t for t in BERT_CORPUS + PLAIN if not _bert_divergent(t)]
    for lower in (True, False):
        for strip in (None, True, False):
            for clean in (True, False):
                for chinese in (True, False):
                    ref = normalizers.BertNormalizer(
                        clean_text=clean, handle_chinese_chars=chinese,
                        strip_accents=strip, lowercase=lower)
                    port = hf_tokenizer._normalizer(
                        _spec_of("normalizer", ref))
                    for text in texts:
                        assert port(text) == ref.normalize_str(text), text
    pre = pre_tokenizers.BertPreTokenizer()
    port_pre = hf_tokenizer._pre_tokenizer(_spec_of("pre_tokenizer", pre))
    for text in texts:
        assert [w for w, _ in port_pre([(text, True)])] == [
            w for w, _ in pre.pre_tokenize_str(text)], text
    pieces = ["##s", "##ing", "the", "cat", ".", ",", "?", "!", "'", "n",
              "##'", "'t", "n't", "'m", "'s", "'ve", "'re", "do", "not",
              "[CLS]", "##", "a", "##b", " "]
    rng = np.random.default_rng(4)
    for cleanup in (True, False):
        ref = decoders.WordPiece(prefix="##", cleanup=cleanup)
        port = hf_tokenizer._decoder(_spec_of("decoder", ref))
        for _ in range(400):
            toks = [pieces[int(i)] for i in rng.integers(
                0, len(pieces), rng.integers(0, 8))]
            assert "".join(port(toks)) == ref.decode(toks), toks


def test_bert_smoke_tokenizer_shape():
    """The smoke's 30522-id file: bert-base-uncased's special ids, every
    ASCII word of the corpus (what its documents are made of) one token."""
    spec = chip_smoke.bert_tokenizer_spec()
    vocab = spec["model"]["vocab"]
    assert len(vocab) == 30522 == len(set(vocab.values()))
    assert sorted(vocab.values()) == list(range(30522))
    assert {t: vocab[t] for t in BERT_SPECIAL_TOKENS} == {
        "[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
    port = hf_tokenizer.TokenizerJSON(spec)
    words = [w for w in chip_smoke._corpus_words()
             if w.isascii() and w.isalpha()]
    assert len(words) > 100
    for w in words:
        assert port.encode(w) == [vocab[w]], w
