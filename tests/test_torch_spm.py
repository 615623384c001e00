"""ROADMAP §C 11, the Unigram half: a T5 checkpoint whose tokenizer is a
SentencePiece ``spiece.model`` / ``tokenizer.model`` with
``tokenizer_config.json`` and no ``tokenizer.json``, on the CPU.

The model file is written with ``transformers``' own protobuf module
(``sentencepiece_model_pb2_new``) from a Unigram vocabulary trained with
``tokenizers`` on text in the repo, with T5's control pieces and a
``precompiled_charsmap`` from the port's writer. The reference is
``transformers.convert_slow_tokenizer.T5Converter(...).converted()`` over
a stub of the slow tokenizer (it needs no ``sentencepiece``), which is
the tokenizer ``AutoTokenizer`` builds for such a directory where
``sentencepiece`` is installed. The JAX package's
``utils.tokenizer.HFTokenizer`` cannot read the directory where
``sentencepiece`` is not installed, as on the machines these tests run
on: ``AutoTokenizer`` first builds the slow ``T5Tokenizer``, which needs
it. The port's reader
(``utils/spm.py``: the protobuf decoded by hand, the converter's spec
built) gives the converter's ids for ``legacy`` true and false and
``add_prefix_space`` true and false; a BPE model or another tokenizer
class is still refused at load, by name.
"""

import json
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("tokenizers")
pb2 = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
from tokenizers import Tokenizer  # noqa: E402
from transformers.convert_slow_tokenizer import T5Converter  # noqa: E402

from localai_tpu_torch.utils import spm  # noqa: E402
from localai_tpu_torch.utils import tokenizer as port_tok  # noqa: E402
from test_torch_unigram import CORPUS, TABLE  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXTRA_IDS = 7
TEXTS = CORPUS + ["<extra_id_0> fills <extra_id_3>", "trailing space ",
                  " leading", "</s></s>"]


@pytest.fixture(scope="module")
def pieces():
    """(piece, score, type) of a Unigram model trained on the README:
    <pad> and </s> control pieces, <unk> unknown, then the rest."""
    from tokenizers import models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    text = (REPO / "README.md").read_text(encoding="utf-8")[:80_000]
    tok.train_from_iterator([text] + CORPUS, trainers.UnigramTrainer(
        vocab_size=700, special_tokens=["<pad>", "</s>", "<unk>"],
        unk_token="<unk>"))
    vocab = json.loads(tok.to_str())["model"]["vocab"]
    kinds = {"<pad>": spm.CONTROL, "</s>": spm.CONTROL,
             "<unk>": spm.UNKNOWN}
    return [(p, s, kinds.get(p, spm.NORMAL)) for p, s in vocab]


def model_bytes(pieces, *, model_type=spm.UNIGRAM, charsmap=True,
                byte_fallback=False) -> bytes:
    m = pb2.ModelProto()
    for p, s, t in pieces:
        m.pieces.add(piece=p, score=s, type=t)
    m.trainer_spec.model_type = model_type
    m.trainer_spec.unk_id = 2
    m.trainer_spec.eos_id = 1
    m.trainer_spec.pad_id = 0
    m.trainer_spec.bos_id = -1
    m.trainer_spec.byte_fallback = byte_fallback
    m.trainer_spec.vocab_size = len(pieces)
    if charsmap:
        m.normalizer_spec.precompiled_charsmap = spm.charsmap_bytes(TABLE)
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    return m.SerializeToString()


def reference(path: Path, legacy: bool, add_prefix_space: bool):
    """``T5Converter`` over a stub of the slow ``T5Tokenizer``."""
    vocab = [p.piece for p in spm.read_model(path.read_bytes()).pieces]
    stub = types.SimpleNamespace(
        vocab_file=str(path), _extra_ids=EXTRA_IDS, legacy=legacy,
        add_prefix_space=add_prefix_space,
        convert_tokens_to_ids=lambda t: vocab.index(t))
    return T5Converter(stub).converted()


def write_dir(d: Path, data: bytes, name="spiece.model", **cfg) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_bytes(data)
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer", "extra_ids": EXTRA_IDS,
         "eos_token": "</s>", **cfg}))
    return d


@pytest.mark.parametrize("name", ["spiece.model", "tokenizer.model"])
@pytest.mark.parametrize("legacy", [True, False], ids=["legacy",
                                                        "not-legacy"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix",
                                                        "no-prefix"])
def test_ids_equal_the_converter(tmp_path, pieces, name, legacy, prefix):
    d = write_dir(tmp_path / "t5", model_bytes(pieces), name,
                  legacy=legacy, add_prefix_space=prefix)
    ref = reference(d / name, legacy, prefix)
    tok = port_tok.load_tokenizer(d)
    assert type(tok).__name__ == "HFTokenizer"
    assert tok.vocab_size == ref.get_vocab_size()
    for text in TEXTS:
        want = ref.encode(text, add_special_tokens=False).ids
        assert tok.encode(text) == want, text
        assert tok.decode(want) == ref.decode(want,
                                              skip_special_tokens=False)


def test_spec_is_the_converters(tmp_path, pieces):
    """Section by section, the spec built here is the converter's
    serialized ``tokenizer.json``."""
    d = write_dir(tmp_path / "t5", model_bytes(pieces))
    want = json.loads(reference(d / "spiece.model", True, True).to_str())
    got = spm.t5_tokenizer_spec(spm.read_model(
        (d / "spiece.model").read_bytes()), extra_ids=EXTRA_IDS)
    for key in ("normalizer", "pre_tokenizer", "decoder",
                "post_processor"):
        assert json.loads(Tokenizer.from_str(json.dumps(got)).to_str())[
            key] == want[key], key
    assert got["model"]["vocab"] == want["model"]["vocab"]
    assert got["model"]["unk_id"] == want["model"]["unk_id"]
    assert [(t["id"], t["content"], t["special"])
            for t in got["added_tokens"]] == [
        (t["id"], t["content"], t["special"]) for t in want["added_tokens"]]


def test_model_proto_fields_read_by_hand(pieces):
    """The stdlib wire-format reader gives protobuf's own parse."""
    data = model_bytes(pieces, byte_fallback=True)
    m = pb2.ModelProto()
    m.ParseFromString(data)
    got = spm.read_model(data)
    assert [(p.piece, p.score, p.type) for p in got.pieces] == [
        (p.piece, p.score, p.type) for p in m.pieces]
    ts, ns = m.trainer_spec, m.normalizer_spec
    assert (got.model_type, got.unk_id, got.bos_id, got.eos_id, got.pad_id,
            got.byte_fallback, got.vocab_size) == (
        ts.model_type, ts.unk_id, ts.bos_id, ts.eos_id, ts.pad_id,
        ts.byte_fallback, ts.vocab_size)
    assert got.precompiled_charsmap == ns.precompiled_charsmap
    assert (got.add_dummy_prefix, got.remove_extra_whitespaces) == (
        ns.add_dummy_prefix, ns.remove_extra_whitespaces)
    assert got.unk_piece == ts.unk_piece


def test_no_charsmap_leaves_strip_and_replace(tmp_path, pieces):
    d = write_dir(tmp_path / "t5", model_bytes(pieces, charsmap=False))
    ref = reference(d / "spiece.model", True, True)
    tok = port_tok.load_tokenizer(d)
    for text in TEXTS:
        assert tok.encode(text) == ref.encode(
            text, add_special_tokens=False).ids


def test_bpe_model_is_refused_by_name(tmp_path, pieces):
    d = write_dir(tmp_path / "bpe", model_bytes(pieces,
                                                model_type=spm.BPE),
                  "tokenizer.model")
    with pytest.raises(ValueError, match=r"BPE .*§C 11"):
        port_tok.load_tokenizer(d)


def test_other_tokenizer_class_is_refused_by_name(tmp_path, pieces):
    d = write_dir(tmp_path / "llama", model_bytes(pieces),
                  "tokenizer.model", tokenizer_class="LlamaTokenizer")
    with pytest.raises(ValueError, match=r"LlamaTokenizer.*§C 11"):
        port_tok.load_tokenizer(d)


def test_truncated_model_is_refused():
    with pytest.raises(ValueError, match="truncated"):
        spm.read_model(b"\x0a\x05ab")
