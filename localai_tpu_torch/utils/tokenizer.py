"""Tokenizer abstraction: HF tokenizers for real models, a self-contained
byte-level tokenizer for tests/benchmarks (zero downloads).

Copy of ``localai_tpu/utils/tokenizer.py``, except that the HF tokenizer
reads ``tokenizer.json`` with the port's own reader
(``utils/hf_tokenizer.py``, stdlib only) where the JAX package imports
``tokenizers``: the card's machine has neither ``tokenizers`` nor
``transformers``. A checkpoint with a ``tokenizer_config.json`` and no
``tokenizer.json`` (the JAX package hands it to ``transformers``'
``AutoTokenizer``) is read when it is a T5 tokenizer over a SentencePiece
Unigram ``spiece.model`` / ``tokenizer.model``: ``utils/spm.py`` decodes
the protobuf and builds the ``tokenizer.json`` that ``transformers``'
``T5Converter`` builds (``extra_ids``, ``legacy`` and
``add_prefix_space`` of ``tokenizer_config.json`` included). Any other
such checkpoint (a BPE ``tokenizer.model``, another tokenizer class) is
refused at load, naming what it has (ROADMAP §C 11).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Protocol, Sequence

from localai_tpu_torch.utils.hf_tokenizer import TokenizerJSON


class Tokenizer(Protocol):
    eos_ids: set[int]
    vocab_size: int

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 = bytes, 256 = BOS, 257 = EOS.

    Deterministic, download-free; used by the debug model family and the
    synthetic benchmark path.
    """

    BOS = 256
    EOS = 257

    def __init__(self) -> None:
        self.eos_ids = {self.EOS}
        self.vocab_size = 258

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """A checkpoint's ``tokenizer.json``, read by ``utils.hf_tokenizer``
    with the JAX package's ``encode(t, add_special_tokens=False)`` and
    ``decode(ids, skip_special_tokens=False)`` meaning."""

    def __init__(self, model_dir: str | Path):
        model_dir = Path(model_dir)
        tok_json = model_dir / "tokenizer.json"
        if tok_json.exists():
            self._tok = TokenizerJSON.from_file(tok_json)
        else:
            self._tok = TokenizerJSON(sentencepiece_spec(model_dir))
        self.vocab_size = self._tok.vocab_size
        self._decode = self._tok.decode
        self._encode = self._tok.encode
        self.eos_ids = self._find_eos(model_dir)
        self.bos_id = self._find_bos(model_dir)

    def _each_cfg(self, model_dir: Path):
        import json

        for name in ("generation_config.json", "config.json",
                     "tokenizer_config.json"):
            p = model_dir / name
            if p.exists():
                try:
                    yield json.loads(p.read_text())
                except Exception:  # noqa: BLE001
                    pass

    def _find_eos(self, model_dir: Path) -> set[int]:
        # union across all config files: Llama-3-Instruct lists multiple EOS
        # ids in generation_config.json and a single one in config.json —
        # generation must stop on any of them
        out: set[int] = set()
        for cfg in self._each_cfg(model_dir):
            eos = cfg.get("eos_token_id")
            if isinstance(eos, int):
                out.add(eos)
            elif isinstance(eos, list):
                out.update(int(e) for e in eos)
            elif isinstance(eos, str):
                ids = self._encode(eos)
                if len(ids) == 1:
                    out.add(ids[0])
        return out

    def _find_bos(self, model_dir: Path):
        for cfg in self._each_cfg(model_dir):
            b = cfg.get("bos_token_id")
            if isinstance(b, int):
                return b
        return None

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._encode(text)
        if add_bos and self.bos_id is not None and (
            not ids or ids[0] != self.bos_id
        ):
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._decode(ids)

    def token_to_id(self, token: str) -> Optional[int]:
        """The id of ``token`` (an added token's, else the vocabulary's),
        or None: ``tokenizers``' ``token_to_id``, which the JAX package's
        encoders ask for ``[CLS]``/``[SEP]``/``[PAD]``."""
        return self._tok.token_to_id(token)


SPM_FILES = ("spiece.model", "tokenizer.model")
T5_CLASSES = ("T5Tokenizer", "T5TokenizerFast")


def sentencepiece_spec(model_dir: str | Path) -> dict:
    """The ``tokenizer.json`` of a directory holding
    ``tokenizer_config.json`` and a SentencePiece model but no
    ``tokenizer.json``: T5's Unigram tokenizer as ``T5Converter`` builds
    it. Anything else raises a ``ValueError`` naming it."""
    import json

    from localai_tpu_torch.utils import spm

    model_dir = Path(model_dir)
    found = [model_dir / n for n in SPM_FILES if (model_dir / n).exists()]
    if not found:
        raise ValueError(
            f"{model_dir}: no tokenizer.json and no SentencePiece model "
            f"({' or '.join(SPM_FILES)}); the port reads one of them")
    cfg: dict = {}
    p = model_dir / "tokenizer_config.json"
    if p.exists():
        cfg = json.loads(p.read_text(encoding="utf-8"))
    model = spm.read_model(found[0].read_bytes())
    if model.model_type != spm.UNIGRAM:
        raise ValueError(
            f"{found[0]}: a {spm.MODEL_TYPES.get(model.model_type, '?')} "
            "SentencePiece model without tokenizer.json; the port reads "
            "T5's Unigram model only (ROADMAP §C 11)")
    cls = cfg.get("tokenizer_class")
    if cls not in T5_CLASSES:
        raise ValueError(
            f"{model_dir}: tokenizer_class {cls!r} over a SentencePiece "
            "model without tokenizer.json; the port builds "
            f"{' / '.join(T5_CLASSES)} only (ROADMAP §C 11)")

    def flag(key: str) -> bool:
        return True if cfg.get(key) is None else bool(cfg[key])

    return spm.t5_tokenizer_spec(
        model, extra_ids=int(cfg.get("extra_ids", 100)),
        legacy=flag("legacy"), add_prefix_space=flag("add_prefix_space"))


def load_tokenizer(model_dir: str | Path) -> Tokenizer:
    model_dir = Path(model_dir)
    if (model_dir / "tokenizer.json").exists() or (
        model_dir / "tokenizer_config.json"
    ).exists():
        return HFTokenizer(model_dir)
    return ByteTokenizer()
