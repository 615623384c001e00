"""Tokenizer abstraction: HF tokenizers for real models, a self-contained
byte-level tokenizer for tests/benchmarks (zero downloads).

Copy of ``localai_tpu/utils/tokenizer.py``. The HF tokenizer imports
``tokenizers`` (or ``transformers``) inside its constructor, so the port's
runtime needs neither unless a checkpoint ships a tokenizer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, Sequence


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
    """Wraps a tokenizers/transformers tokenizer loaded from local files."""

    def __init__(self, model_dir: str | Path):
        model_dir = Path(model_dir)
        tok_json = model_dir / "tokenizer.json"
        if tok_json.exists():
            from tokenizers import Tokenizer as RawTok

            self._tok = RawTok.from_file(str(tok_json))
            self.vocab_size = self._tok.get_vocab_size()
            self._decode = lambda ids: self._tok.decode(
                list(ids), skip_special_tokens=False
            )
            self._encode = lambda t: self._tok.encode(t, add_special_tokens=False).ids
        else:
            from transformers import AutoTokenizer

            t = AutoTokenizer.from_pretrained(str(model_dir))
            self._tok = t
            self.vocab_size = len(t)
            self._decode = lambda ids: t.decode(list(ids), skip_special_tokens=False)
            self._encode = lambda s: t.encode(s, add_special_tokens=False)
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


def load_tokenizer(model_dir: str | Path) -> Tokenizer:
    model_dir = Path(model_dir)
    if (model_dir / "tokenizer.json").exists() or (
        model_dir / "tokenizer_config.json"
    ).exists():
        return HFTokenizer(model_dir)
    return ByteTokenizer()
