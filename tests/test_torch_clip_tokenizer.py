"""The port's CLIP tokenizer against ``CLIPTokenizerFast``, on the CPU.

The port builds, from a CLIP ``vocab.json`` and ``merges.txt``, the
``tokenizer.json`` that ``transformers``' ``CLIPConverter`` builds
(``utils.hf_tokenizer.clip_tokenizer_spec``), and reads a
``tokenizer.json`` directly too. The files here come from a byte-level
BPE that ``tokenizers`` trains with CLIP's normalizer, split pattern and
``</w>`` suffix on the repo's own text (README.md and SURVEY.md), laid out
as CLIP's files are (256 byte symbols, their ``</w>`` forms, the merges,
then the two special tokens). Ids are held equal to
``CLIPTokenizerFast(text).input_ids`` and to the JAX package's
``_load_clip_tokenizer`` over case, accents and other scripts, digits,
punctuation runs, runs of white space, special tokens in the text, and
``tokenize_clip``'s truncation at 77; SDXL's ``tokenizer_2`` pads with
"!", which ``transformers`` adds as a special token.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from localai_tpu.image import clip as jclip  # noqa: E402
from localai_tpu.image import loader as jload  # noqa: E402
from localai_tpu.image import pipeline as jpipe  # noqa: E402
from localai_tpu_torch.image import clip as tclip  # noqa: E402
from localai_tpu_torch.image import loader as tload  # noqa: E402
from localai_tpu_torch.image import pipeline as tpipe  # noqa: E402
from localai_tpu_torch.utils import hf_tokenizer as hft  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TEXTS = [
    "A photograph of an astronaut riding a horse",
    "HELLO World, Hello WORLD!!!",
    "it's a dog's life; they're here, we've gone, I'm done, you'll see",
    "2024-10-18 at 12:30, 3.14159 and 1,000,000",
    "café naïve Zoë façade Ελληνικά ΣΑΣ straße",
    "日本語のテキスト and 中文 mixed with English",
    "emoji 🚀🔥 and symbols ©®™ — “quotes” ‘single’",
    "   leading and trailing   ",
    "tabs\tand\nnew\n\nlines  and nbsp　ideographic space",
    "!!!???...,,,;;;:::", "a<|endoftext|>b <|startoftext|> c",
    "masterpiece, best quality, ultra-detailed, 8k, (sharp focus:1.2)",
    "", " ", "x", "xxxxxxxxxxxxxxxxxxxxxxxxxxxxxxxx",
]


@functools.lru_cache(maxsize=None)
def _trained() -> tuple[dict, list]:
    """(vocab, merges) in CLIP's file layout, merges trained here."""
    from tokenizers import Regex, Tokenizer, models, normalizers
    from tokenizers import pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(hft.CLIP_PATTERN), behavior="removed",
                             invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False)])
    trainer = trainers.BpeTrainer(
        vocab_size=1500, min_frequency=2, end_of_word_suffix="</w>",
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False)
    corpus = [(REPO / n).read_text(encoding="utf-8")
              for n in ("README.md", "SURVEY.md")]
    tok.train_from_iterator(corpus, trainer)
    merges = json.loads(tok.to_str())["model"]["merges"]
    merges = [m.split(" ") if isinstance(m, str) else m for m in merges]
    symbols = [hft.BYTE_CHAR[b] for b in range(256)]
    vocab: dict = {}
    for s in symbols + [s + "</w>" for s in symbols] + [
            a + b for a, b in merges] + ["<|startoftext|>",
                                          "<|endoftext|>"]:
        vocab.setdefault(s, len(vocab))
    return vocab, merges


def write_clip_tokenizer(d, pad=None) -> Path:
    """A CLIP tokenizer directory (vocab.json, merges.txt,
    tokenizer_config.json); ``pad`` as SDXL's tokenizer_2 sets it."""
    vocab, merges = _trained()
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
        encoding="utf-8")
    cfg = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
           "unk_token": "<|endoftext|>",
           "pad_token": pad or "<|endoftext|>", "model_max_length": 77}
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return d


@pytest.fixture(scope="module", params=["sd", "sdxl-tokenizer_2"])
def files(request, tmp_path_factory):
    pad = "!" if request.param.startswith("sdxl") else None
    return write_clip_tokenizer(tmp_path_factory.mktemp("clip"), pad=pad)


def _random_texts(n=40, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefgXYZ  \t\n0123456789.,!?'-éßΣ日🚀") + [
        "'s", "'ll", "The ", "AND "]
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 40)))
            for _ in range(n)]


def test_files_and_tokenizer_json_give_the_fast_tokenizers_ids(files,
                                                               tmp_path):
    ref = transformers.CLIPTokenizerFast.from_pretrained(str(files))
    ours = tload._load_clip_tokenizer(files)
    (tmp_path / "tokenizer.json").write_text(
        ref.backend_tokenizer.to_str(), encoding="utf-8")
    from_json = tload._load_clip_tokenizer(tmp_path)
    for text in TEXTS + _random_texts():
        want = ref(text).input_ids
        assert ours.encode(text) == want, text
        assert from_json.encode(text) == want, text
    assert ours.eos_ids == {ref.eos_token_id}
    assert ours.vocab_size == ref.vocab_size


def test_spec_equals_the_converters_tokenizer_json(files):
    """The sections the port builds are the converter's, field for
    field."""
    ref = json.loads(transformers.CLIPTokenizerFast.from_pretrained(
        str(files)).backend_tokenizer.to_str())
    vocab = json.loads((files / "vocab.json").read_text())
    merges = hft.read_clip_merges((files / "merges.txt").read_text())
    pad = json.loads((files / "tokenizer_config.json").read_text())[
        "pad_token"]
    spec = hft.clip_tokenizer_spec(vocab, merges, specials=(pad,))
    for key in ("normalizer", "pre_tokenizer", "post_processor", "decoder"):
        assert spec[key] == ref[key], key
    model = dict(ref["model"])
    assert [list(m) for m in model.pop("merges")] == merges
    assert model.pop("vocab") == vocab
    assert {k: v for k, v in spec["model"].items()
            if k not in ("vocab", "merges")} == model
    by_id = lambda toks: sorted(  # noqa: E731
        (t["id"], t["content"], t["special"]) for t in toks)
    assert by_id(spec["added_tokens"]) == by_id(ref["added_tokens"])


def test_ids_match_the_jax_packages_tokenizer_with_truncation(files):
    ref = jload._load_clip_tokenizer(files, None)
    ours = tload._load_clip_tokenizer(files)
    cfg = tclip.CLIPTextConfig(eos_token_id=ours._tok.token_to_id(
        "<|endoftext|>"))
    jcfg = jclip.CLIPTextConfig(eos_token_id=cfg.eos_token_id)
    long = " ".join(TEXTS * 3)
    for text in TEXTS + [long]:
        assert ours.encode(text) == ref.encode(text)
        np.testing.assert_array_equal(tpipe.tokenize_clip(ours, cfg, text),
                                      jpipe.tokenize_clip(ref, jcfg, text))
    row = tpipe.tokenize_clip(ours, cfg, long)
    assert row.shape == (1, 77) and len(ours.encode(long)) > 77
    assert row[0, 0] == ours._tok.token_to_id("<|startoftext|>")


def test_decoders_and_lowercase():
    vocab, merges = _trained()
    tok = hft.TokenizerJSON(hft.clip_tokenizer_spec(vocab, merges))
    ids = tok.encode("Hello, World")
    assert tok.decode(ids) == "hello</w>,</w>world</w>"
    spec = hft.clip_tokenizer_spec(vocab, merges)
    spec["decoder"] = {"type": "BPEDecoder", "suffix": "</w>"}
    from tokenizers import Tokenizer

    ref = Tokenizer.from_str(json.dumps(spec))
    bpe = hft.TokenizerJSON(spec)
    for text in TEXTS[:8]:
        i = bpe.encode(text)
        assert i == ref.encode(text, add_special_tokens=False).ids
        assert bpe.decode(i) == ref.decode(i, skip_special_tokens=False)
    norm = hft.TokenizerJSON({"model": {"type": "WordLevel", "vocab": {
        "[UNK]": 0}, "unk_token": "[UNK]"}, "normalizer": {
            "type": "Lowercase"}}).normalize
    assert norm("ÀΣΑΣ İx") == "àσασ i̇x"


def test_post_processor_other_than_roberta_is_refused_when_asked():
    """A post-processor the reader lacks (it has RobertaProcessing and,
    since T5's tokenizers, TemplateProcessing) fails when asked for."""
    spec = {"model": {"type": "WordLevel", "vocab": {"a": 0, "[UNK]": 1},
                      "unk_token": "[UNK]"},
            "post_processor": {"type": "BertProcessing",
                               "sep": ["[UNK]", 1], "cls": ["[UNK]", 1]}}
    tok = hft.TokenizerJSON(spec)
    assert tok.encode("a") == [0]
    with pytest.raises(ValueError, match="BertProcessing"):
        tok.encode("a", add_special_tokens=True)


def test_directory_without_a_tokenizer_falls_back_to_bytes(tmp_path,
                                                           caplog):
    tok = tload._load_clip_tokenizer(tmp_path)
    assert type(tok).__name__ == "ByteTokenizer"
    assert "byte tokenizer" in caplog.text
