"""Reader of the Hugging Face ``tokenizer.json`` format on the standard
library alone.

The card's machine has neither ``tokenizers`` nor ``transformers``, so the
port reads a checkpoint's ``tokenizer.json`` itself. The pipeline follows
the format's sections in the order ``tokenizers`` runs them for
``encode(text, add_special_tokens=False)``:

  1. added tokens: the text is split on every entry of ``added_tokens``
     (special ones included), leftmost-longest; ``single_word``,
     ``lstrip``, ``rstrip`` and ``normalized`` are honoured;
  2. normalizer (``NFC``/``NFKC``/``NFD``/``NFKD``, ``Sequence``,
     ``Prepend``, ``Replace``, ``Strip``, ``Lowercase``,
     ``BertNormalizer``, SentencePiece's ``Precompiled`` charsmap over
     grapheme clusters, ``utils/spm.py``) on each piece between added
     tokens;
  3. pre-tokenizer (``ByteLevel``, ``Split``, ``Metaspace``, ``Digits``,
     ``BertPreTokenizer``, ``WhitespaceSplit``, ``Sequence``);
  4. model: ``BPE`` (ranked merges, ``ignore_merges``, ``unk_token``,
     ``fuse_unk``, ``byte_fallback``, ``continuing_subword_prefix``,
     ``end_of_word_suffix``), with a word → ids cache; or ``WordLevel``
     (one vocabulary entry a word, else ``unk_token``: the model of the
     ``tokenizer.json`` that ``utils/gguf.py`` writes from a GGUF's
     vocabulary, which has no pre-tokenizer, so a whole text is one word);
     or ``WordPiece`` (greedy longest-match-first over the vocabulary,
     ``continuing_subword_prefix`` on every piece after a word's first,
     ``unk_token`` for a word with no split or longer than
     ``max_input_chars_per_word``: BERT's model); or ``Unigram``
     (SentencePiece's Viterbi over scored pieces, fused unknowns,
     ``byte_fallback``: T5's model).

``decode(ids)`` maps ids to tokens (added tokens to their content) and
runs the decoder (``ByteLevel``, ``Metaspace``, ``Replace``,
``ByteFallback``, ``Fuse``, ``Strip``, ``WordPiece``, ``BPEDecoder``,
``Sequence``) over all of them,
as ``decode(ids, skip_special_tokens=False)`` does. The post-processor
runs only for ``encode(text, add_special_tokens=True)`` (the CLIP
tokenizers of the image pipeline ask for it), and only
``RobertaProcessing`` (a single sequence between its ``cls`` and ``sep``
ids) and ``TemplateProcessing`` (its ``single`` template, T5's ``$A
</s>``) are read; any other fails when asked for. A component this reader
does not implement fails at load with a ``ValueError`` naming it, and so
does a BERT component without a field that ``tokenizers`` requires.
:func:`clip_tokenizer_spec` builds, from a CLIP ``vocab.json`` and
``merges.txt``, the ``tokenizer.json`` that ``transformers``'
``CLIPConverter`` builds for ``CLIPTokenizerFast``.
``token_to_id`` looks a token up among the added tokens, then in the
model's vocabulary, as ``tokenizers`` does.

The BERT components classify characters with this interpreter's
``unicodedata`` (Unicode 15.0): control characters (Cc, Cf, Co, Cs, but
tab, line feed and carriage return) are removed, White_Space becomes a
space, punctuation is ASCII punctuation or a ``P*`` category, accents are
the ``Mn`` marks of NFD. ``tokenizers`` takes these classes from older
tables (and lowercases with newer ones), so a few hundred code points
assigned or reclassified since differ (recorded in ROADMAP).

The regexes of the format are Oniguruma's. ``\\p{..}``, ``\\s``, ``\\d``
and ``\\w`` are rewritten into explicit character classes built from
``unicodedata`` (Python's own ``\\s`` also matches U+001C..U+001F, which
are not white space in Unicode, and its ``\\w`` differs from
Oniguruma's); the rest of the syntax these files use (``(?i:..)``,
lookahead, possessive and atomic forms) is Python's too.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Unicode classes (Oniguruma's, built from this interpreter's unicodedata)

# Oniguruma's \s with Unicode: U+0009..U+000D, U+0085 and the separators
# (Zs, Zl, Zp), the same set as Unicode's White_Space property
_WS_EXTRA = "\t\n\x0b\x0c\r\x85"
_CATEGORY_NAMES = {
    "Letter": "L", "Mark": "M", "Number": "N", "Punctuation": "P",
    "Symbol": "S", "Separator": "Z", "Other": "C",
    "Uppercase_Letter": "Lu", "Lowercase_Letter": "Ll",
    "Titlecase_Letter": "Lt", "Modifier_Letter": "Lm",
    "Other_Letter": "Lo", "Decimal_Number": "Nd", "Letter_Number": "Nl",
    "Other_Number": "No", "Nonspacing_Mark": "Mn",
    "Spacing_Mark": "Mc", "Enclosing_Mark": "Me",
}


@functools.lru_cache(maxsize=None)
def _category_runs() -> dict[str, list[tuple[int, int]]]:
    """General category → its runs of code points (lo, hi), surrogates
    excluded."""
    out: dict[str, list[tuple[int, int]]] = {}
    cat = unicodedata.category
    run_cat, lo = cat("\0"), 0
    for cp in range(1, sys.maxunicode + 2):
        c = (None if cp > sys.maxunicode
             else "Cs" if 0xD800 <= cp <= 0xDFFF else cat(chr(cp)))
        if c != run_cat:
            if run_cat != "Cs":
                out.setdefault(run_cat, []).append((lo, cp - 1))
            run_cat, lo = c, cp
    return out


def _ranges(runs: list[tuple[int, int]]) -> str:
    """Runs of code points → the body of a regex character class, with
    adjacent runs joined."""
    merged: list[list[int]] = []
    for lo, hi in sorted(runs):
        if merged and lo <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return "".join(re.escape(chr(lo)) if lo == hi
                   else f"{re.escape(chr(lo))}-{re.escape(chr(hi))}"
                   for lo, hi in merged)


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """Class body for ``\\p{name}`` (a general category or its one-letter
    group), ``s`` (white space), ``d`` (Nd) or ``w`` (Oniguruma's word
    characters: letters, marks, decimal digits, connector punctuation)."""
    table = _category_runs()

    def cats(pred) -> list[tuple[int, int]]:
        return [r for c, runs in table.items() if pred(c) for r in runs]

    if name == "s":
        return _ranges([(ord(c), ord(c)) for c in _WS_EXTRA]
                       + cats(lambda c: c in ("Zs", "Zl", "Zp")))
    if name == "d":
        return _ranges(cats(lambda c: c == "Nd"))
    if name == "w":
        return _ranges(cats(lambda c: c[0] in "LM" or c in ("Nd", "Pc")))
    name = _CATEGORY_NAMES.get(name, name)
    if len(name) == 1 and name in "LMNPSZC":
        return _ranges(cats(lambda c: c[0] == name))
    if name in table:
        return _ranges(table[name])
    raise ValueError(f"tokenizer.json: regex property \\p{{{name}}} is "
                     "not supported")


@functools.lru_cache(maxsize=256)
def onig_regex(pattern: str) -> "re.Pattern[str]":
    """An Oniguruma pattern of ``tokenizer.json`` as a compiled Python
    regex, with ``\\p{..}``/``\\P{..}``, ``\\s``/``\\S``, ``\\d``/``\\D``
    and ``\\w``/``\\W`` made explicit."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 3)
                body, neg = _class_body(pattern[i + 3:end]), e == "P"
                i = end + 1
            elif e in "sSdDwW":
                body, neg = _class_body(e.lower()), e.isupper()
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if neg:
                    raise ValueError(
                        f"tokenizer.json: negated class escape inside a "
                        f"character class in {pattern!r} is not supported")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            # a ']' right after '[' or '[^' is a literal
            if pattern.startswith("^", i + 1):
                out.append("^")
                i += 1
            if pattern.startswith("]", i + 1):
                out.append("\\]")
                i += 1
        elif c == "[":
            raise ValueError(f"tokenizer.json: nested character class in "
                             f"{pattern!r} is not supported")
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    try:
        return re.compile("".join(out))
    except re.error as e:
        raise ValueError(f"tokenizer.json: regex {pattern!r} is not "
                         f"supported: {e}") from None


@functools.lru_cache(maxsize=None)
def _white_space() -> frozenset[str]:
    """Unicode's White_Space property (Rust's ``char::is_whitespace``),
    the set Oniguruma's ``\\s`` matches."""
    runs = _category_runs()
    return frozenset(_WS_EXTRA) | frozenset(
        chr(cp) for cat in ("Zs", "Zl", "Zp") for lo, hi in runs.get(cat, ())
        for cp in range(lo, hi + 1))


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric``: the general categories Nd, Nl, No."""
    return unicodedata.category(c)[0] == "N"


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


# ---------------------------------------------------------------------------
# Splitting (``NormalizedString::split`` and its delimiter behaviours)

Match = tuple[int, int, bool]            # (start, end, is a match)


def _regex_matches(rx: "re.Pattern[str]", s: str) -> list[Match]:
    out: list[Match] = []
    prev = 0
    for m in rx.finditer(s):
        a, b = m.span()
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = b
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _char_matches(pred: Callable[[str], bool], s: str) -> list[Match]:
    out: list[Match] = []
    last = 0
    for i, c in enumerate(s):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        out.append((last, len(s), False))
    return out


def _split(s: str, matches: list[Match], behavior: str,
           invert: bool = False) -> list[tuple[int, int]]:
    """Pieces of ``s`` (start, end), empty ones dropped, as
    ``tokenizers``' split behaviours lay them out."""
    if invert:
        matches = [(a, b, not m) for a, b, m in matches]
    spans: list[list[int]] = []
    if behavior == "Isolated":
        spans = [[a, b] for a, b, _ in matches]
    elif behavior == "Removed":
        spans = [[a, b] for a, b, m in matches if not m]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        prev = False
        for a, b, m in matches:
            merge = (m == prev) if behavior == "Contiguous" \
                else (m and not prev)
            if merge and spans:
                spans[-1][1] = b
            else:
                spans.append([a, b])
            prev = m
    elif behavior == "MergedWithNext":
        prev = False
        for a, b, m in reversed(matches):
            if m and not prev and spans:
                spans[-1][0] = a
            else:
                spans.append([a, b])
            prev = m
        spans.reverse()
    else:
        raise ValueError(f"tokenizer.json: split behavior {behavior!r} is "
                         "not supported")
    return [(a, b) for a, b in spans if b > a]


def _pattern_matcher(pattern: dict) -> Callable[[str], list[Match]]:
    """A ``{"String": ..}`` or ``{"Regex": ..}`` pattern of the format."""
    if "Regex" in pattern:
        rx = onig_regex(pattern["Regex"])
    elif "String" in pattern:
        rx = re.compile(re.escape(pattern["String"]))
    else:
        raise ValueError(f"tokenizer.json: pattern {pattern!r} is not "
                         "supported")
    return lambda s: _regex_matches(rx, s)


# ---------------------------------------------------------------------------
# Normalizers: str → str

Normalizer = Callable[[str], str]


def _normalizer(spec: Optional[dict]) -> Normalizer:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return run
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        return _replacer(spec)
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "Lowercase":
        # each character's own lowercase mapping (Rust's char::to_lowercase:
        # no final-sigma rule)
        return lambda s: "".join(c.lower() for c in s)
    if kind == "Precompiled":
        # SentencePiece's charsmap (T5's tokenizer.json): utils/spm.py
        from localai_tpu_torch.utils.spm import Charsmap

        (blob,) = _required(spec, "Precompiled", "precompiled_charsmap")
        return Charsmap.from_base64(blob).normalize
    if kind == "Strip":
        ws = "".join(_white_space())
        left, right = spec.get("strip_left", True), spec.get("strip_right",
                                                             True)

        def strip(s: str) -> str:
            if left:
                s = s.lstrip(ws)
            if right:
                s = s.rstrip(ws)
            return s
        return strip
    raise ValueError(f"tokenizer.json: normalizer {kind!r} is not supported")


def _required(spec: dict, kind: str, *fields: str) -> list:
    """The fields ``tokenizers`` needs to read a component, else a
    ``ValueError`` naming the component and the field."""
    missing = [f for f in fields if f not in spec]
    if missing:
        raise ValueError(f"tokenizer.json: {kind} needs the field "
                         f"{missing[0]!r}")
    return [spec[f] for f in fields]


# BERT's Chinese-character blocks (CJK ideographs and their extensions;
# ``tokenizers``' ``is_chinese_char``)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _bert_drops(c: str) -> bool:
    """``clean_text`` removes NUL, U+FFFD and control characters (tab,
    line feed and carriage return are white space instead)."""
    if c in "\t\n\r":
        return False
    return c in "\0\ufffd" or unicodedata.category(c) in ("Cc", "Cf",
                                                           "Co", "Cs")


def _bert_normalizer(spec: dict) -> Normalizer:
    """``BertNormalizer``: ``clean_text``, then ``handle_chinese_chars``
    (spaces around each CJK ideograph), ``strip_accents`` (NFD without
    ``Mn`` marks; null follows ``lowercase``), ``lowercase`` (each
    character's own lowercase mapping, no final-sigma rule)."""
    clean, chinese, lower = _required(spec, "BertNormalizer", "clean_text",
                                      "handle_chinese_chars", "lowercase")
    strip = spec.get("strip_accents")
    if strip is None:
        strip = lower
    ws = _white_space()
    cat = unicodedata.category

    def run(s: str) -> str:
        if clean:
            s = "".join(" " if c in ws else c for c in s
                        if not _bert_drops(c))
        if chinese:
            s = "".join(f" {c} " if _is_cjk(c) else c for c in s)
        if strip:
            s = "".join(c for c in unicodedata.normalize("NFD", s)
                        if cat(c) != "Mn")
        if lower:
            s = "".join(c.lower() for c in s)
        return s
    return run


_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _is_bert_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c)[0] == "P"


def _bert_pre_tokenize(s: str, first: bool) -> list[tuple[str, bool]]:
    """``BertPreTokenizer``: split on white space (removed), then isolate
    each punctuation character."""
    ws = _white_space()
    out: list[tuple[str, bool]] = []
    for a, b in _split(s, _char_matches(lambda c: c in ws, s), "Removed"):
        word = s[a:b]
        out.extend((word[c:d], first and a + c == 0) for c, d in _split(
            word, _char_matches(_is_bert_punct, word), "Isolated"))
    return out


def _replacer(spec: dict) -> Callable[[str], str]:
    pat, content = spec["pattern"], spec["content"]
    if "String" in pat:
        old = pat["String"]
        return lambda s: s.replace(old, content) if old else s
    rx = onig_regex(pat["Regex"])
    return lambda s: rx.sub(lambda _m: content, s)


# ---------------------------------------------------------------------------
# Pre-tokenizers: [(piece, starts at the original's offset 0)] → same

Splits = list[tuple[str, bool]]
PreTokenizer = Callable[[Splits], Splits]


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte → printable character map (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}
# the pattern GPT-2 (and ByteLevel's use_regex) splits words with
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _each(fn: Callable[[str, bool], list[tuple[str, bool]]]) -> PreTokenizer:
    def run(splits: Splits) -> Splits:
        out: Splits = []
        for s, first in splits:
            out.extend(p for p in fn(s, first) if p[0])
        return out
    return run


def _pieces(s: str, first: bool, spans) -> list[tuple[str, bool]]:
    return [(s[a:b], first and a == 0) for a, b in spans]


def _pre_tokenizer(spec: Optional[dict]) -> PreTokenizer:
    if spec is None:
        return lambda splits: splits
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(splits: Splits) -> Splits:
            for f in steps:
                splits = f(splits)
            return splits
        return run
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", True)
        rx = onig_regex(GPT2_PATTERN) if spec.get("use_regex", True) \
            else None

        def byte_level(s: str, first: bool) -> list[tuple[str, bool]]:
            if prefix and s and not s.startswith(" "):
                s = " " + s
            parts = [(s, first)] if rx is None else _pieces(
                s, first, _split(s, _regex_matches(rx, s), "Isolated"))
            return [("".join(BYTE_CHAR[b] for b in p.encode("utf-8")), f)
                    for p, f in parts]
        return _each(byte_level)
    if kind == "Split":
        match = _pattern_matcher(spec["pattern"])
        behavior, invert = spec["behavior"], spec.get("invert", False)
        return _each(lambda s, first: _pieces(
            s, first, _split(s, match(s), behavior, invert)))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = _prepend_scheme(spec)
        split = spec.get("split", True)

        def metaspace(s: str, first: bool) -> list[tuple[str, bool]]:
            s = s.replace(" ", rep)
            if (scheme == "always" or (scheme == "first" and first)) \
                    and s and not s.startswith(rep):
                s = rep + s
            if not split:
                return [(s, first)]
            return _pieces(s, first, _split(
                s, _char_matches(lambda c: c == rep, s), "MergedWithNext"))
        return _each(metaspace)
    if kind == "BertPreTokenizer":
        return _each(_bert_pre_tokenize)
    if kind == "WhitespaceSplit":
        ws = _white_space()
        return _each(lambda s, first: _pieces(s, first, _split(
            s, _char_matches(lambda c: c in ws, s), "Removed")))
    if kind == "Digits":
        behavior = ("Isolated" if spec.get("individual_digits", False)
                    else "Contiguous")
        return _each(lambda s, first: _pieces(s, first, _split(
            s, _char_matches(_is_numeric, s), behavior)))
    raise ValueError(f"tokenizer.json: pre-tokenizer {kind!r} is not "
                     "supported")


def _prepend_scheme(spec: dict) -> str:
    """Metaspace's prepend scheme; older files carry ``add_prefix_space``."""
    if "prepend_scheme" in spec:
        return spec["prepend_scheme"]
    return "always" if spec.get("add_prefix_space", True) else "never"


# ---------------------------------------------------------------------------
# Model: BPE


class BPE:
    """The ``BPE`` model of ``tokenizers`` without dropout: each word's
    characters become symbols, then the adjacent pair of lowest merge rank
    (leftmost on a tie) is merged until none is left."""

    CACHE_WORDS = 10_000

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.prefix: str = spec.get("continuing_subword_prefix") or ""
        self.suffix: str = spec.get("end_of_word_suffix") or ""
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            new = a + b[len(self.prefix):]
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[new])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"a token not in the vocabulary: {e}") \
                    from None
        self._cache: dict[str, tuple[int, ...]] = {}

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        if self.ignore_merges:
            i = self.vocab.get(word)
            if i is not None:
                return (i,)
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_word(word)
            if len(self._cache) < self.CACHE_WORDS:
                self._cache[word] = hit
        return hit

    def _merge_word(self, w: str) -> tuple[int, ...]:
        syms: list[int] = []
        unk: Optional[int] = None          # a pending (maybe fused) unk
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = (self.prefix if i and self.prefix else "") + ch
            if i == last:
                s += self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if None not in ids:
                    syms.extend(ids)      # a pending unk stays pending
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json: unk_token "
                                     f"{self.unk_token!r} is not in the "
                                     "vocabulary")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        return tuple(self._merge_all(syms))

    def _merge_all(self, syms: list[int]) -> list[int]:
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for p in range(n - 1):
            m = merges.get((syms[p], syms[p + 1]))
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, p, new = heapq.heappop(heap)
            q = nxt[p]
            if not alive[p] or q >= n:
                continue
            m = merges.get((syms[p], syms[q]))
            if m is None or m[1] != new:
                continue                       # a stale entry
            syms[p] = new
            alive[q] = False
            nxt[p] = nxt[q]
            if nxt[p] < n:
                prv[nxt[p]] = p
            if prv[p] >= 0:
                m = merges.get((syms[prv[p]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[p], m[1]))
            if nxt[p] < n:
                m = merges.get((new, syms[nxt[p]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [s for s, a in zip(syms, alive) if a]


# ---------------------------------------------------------------------------
# Decoders: [token] → [str], joined at the end

Decoder = Callable[[list[str]], list[str]]


def _decoder(spec: Optional[dict]) -> Optional[Decoder]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec["decoders"]]

        def run(tokens: list[str]) -> list[str]:
            for f in steps:
                tokens = f(tokens)
            return tokens
        return run
    if kind == "ByteLevel":
        def byte_level(tokens: list[str]) -> list[str]:
            out = bytearray()
            for t in tokens:
                try:
                    out.extend(CHAR_BYTE[c] for c in t)
                except KeyError:            # not byte-level: its own bytes
                    out.extend(t.encode("utf-8"))
            return [bytes(out).decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        strip_first = _prepend_scheme(spec) != "never"
        return lambda tokens: [
            t.replace(rep, "" if i == 0 and strip_first else " ")
            for i, t in enumerate(tokens)]
    if kind == "Replace":
        rep = _replacer(spec)
        return lambda tokens: [rep(t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "WordPiece":
        prefix, cleanup = _required(spec, "WordPiece decoder", "prefix",
                                    "cleanup")

        def wordpiece(tokens: list[str]) -> list[str]:
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = (t.replace(prefix, "", 1) if t.startswith(prefix)
                         else " " + t)
                out.append(_cleanup(t) if cleanup else t)
            return out
        return wordpiece
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [
            t.replace(suffix, "" if i == len(tokens) - 1 else " ")
            for i, t in enumerate(tokens)]
    if kind == "Strip":
        content = spec["content"]
        start, stop = int(spec.get("start", 0)), int(spec.get("stop", 0))

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for t in tokens:
                a, b = 0, len(t)
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                while len(t) - b < stop and b > 0 and t[b - 1] == content:
                    b -= 1
                out.append(t[a:max(a, b)])
            return out
        return strip
    raise ValueError(f"tokenizer.json: decoder {kind!r} is not supported")


# the WordPiece decoder's ``cleanup``: tokenization artefacts of English
# punctuation and contractions, replaced in this order
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
            (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
            (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))


def _cleanup(t: str) -> str:
    for old, new in _CLEANUP:
        t = t.replace(old, new)
    return t


_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _byte_fallback(tokens: list[str]) -> list[str]:
    """``<0xXX>`` runs become their UTF-8 text, or one U+FFFD per byte
    when the run is not valid UTF-8."""
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()

    for t in tokens:
        m = _BYTE_TOKEN.fullmatch(t) if len(t) == 6 else None
        if m is not None:
            run.append(int(m.group(1), 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


# ---------------------------------------------------------------------------
# Added tokens


class _AddedTokens:
    """Splits text on the added tokens of one kind (matched against the
    raw text, or against the normalized text), leftmost-longest."""

    def __init__(self, entries: list[dict], contents: list[str]):
        self.entries = entries
        order = sorted(range(len(entries)), key=lambda k: -len(contents[k]))
        self._by_content = {}
        for k in order:
            self._by_content.setdefault(contents[k], entries[k])
        self._rx = re.compile("|".join(re.escape(contents[k])
                                       for k in order if contents[k])) \
            if any(contents) else None

    def split(self, s: str) -> list[tuple[int, int, Optional[int]]]:
        """(start, end, added id or None) pieces covering ``s``."""
        if self._rx is None or not s:
            return [(0, len(s), None)]
        ws = _white_space()
        out: list[tuple[int, int, Optional[int]]] = []
        start_off = 0
        for m in self._rx.finditer(s):
            a, b = m.span()
            tok = self._by_content[m.group(0)]
            if tok.get("single_word", False):
                if (a > 0 and _is_word_char(s[a - 1])) or (
                        b < len(s) and _is_word_char(s[b])):
                    continue
            if tok.get("lstrip", False):
                na = a
                while na > 0 and s[na - 1] in ws:
                    na -= 1
                a = max(na, start_off)
            if tok.get("rstrip", False):
                while b < len(s) and s[b] in ws:
                    b += 1
            if start_off < a:
                out.append((start_off, a, None))
            out.append((a, b, tok["id"]))
            start_off = b
        if start_off != len(s):
            out.append((start_off, len(s), None))
        return out


class WordLevel:
    """The ``WordLevel`` model of ``tokenizers``: a word is its vocabulary
    entry's id, or ``unk_token``'s (an error when that is not in the
    vocabulary either, as there)."""

    def __init__(self, spec: dict):
        if "unk_token" not in spec:
            raise ValueError("tokenizer.json: WordLevel needs unk_token")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token: str = spec["unk_token"]

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk_token)
            if tid is None:
                raise ValueError(f"tokenizer.json: WordLevel unk_token "
                                 f"{self.unk_token!r} is not in the "
                                 "vocabulary")
        return (tid,)


class WordPiece:
    """The ``WordPiece`` model of ``tokenizers`` (BERT's): a word longer
    than ``max_input_chars_per_word`` characters is ``unk_token``; else it
    is cut greedily into the longest vocabulary entries from its start,
    each piece after the first looked up with
    ``continuing_subword_prefix``, and a word with a remainder no entry
    matches is ``unk_token`` whole."""

    def __init__(self, spec: dict):
        vocab, unk, prefix, max_chars = _required(
            spec, "WordPiece model", "vocab", "unk_token",
            "continuing_subword_prefix", "max_input_chars_per_word")
        self.vocab: dict[str, int] = dict(vocab)
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token: str = unk
        self.prefix: str = prefix
        self.max_chars = int(max_chars)
        self._cache: dict[str, tuple[int, ...]] = {}

    def _unk(self) -> tuple[int, ...]:
        tid = self.vocab.get(self.unk_token)
        if tid is None:
            raise ValueError(f"tokenizer.json: WordPiece unk_token "
                             f"{self.unk_token!r} is not in the vocabulary")
        return (tid,)

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        hit = self._cache.get(word)
        if hit is None:
            hit = self._pieces(word)
            if len(self._cache) < BPE.CACHE_WORDS:
                self._cache[word] = hit
        return hit

    def _pieces(self, word: str) -> tuple[int, ...]:
        if len(word) > self.max_chars:
            return self._unk()
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end]
                tid = self.vocab.get(self.prefix + piece if start
                                     else piece)
                if tid is not None:
                    ids.append(tid)
                    break
                end -= 1
            else:
                return self._unk()
            start = end
        return tuple(ids)


class Unigram:
    """The ``Unigram`` model of ``tokenizers`` (SentencePiece's): Viterbi
    over the pieces that start at each character, a path's score the sum
    of its pieces' scores (float64, the first candidate kept on a tie); a
    character no single piece covers is ``unk_id`` at the lowest score
    less 10, consecutive unknowns fuse into one, and with
    ``byte_fallback`` an unknown becomes its ``<0xXX>`` byte pieces when
    all of them are in the vocabulary."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        pieces = [(str(p), float(sc)) for p, sc in spec.get("vocab") or []]
        self.unk_id: Optional[int] = spec.get("unk_id")
        if self.unk_id is not None and not 0 <= self.unk_id < len(pieces):
            raise ValueError(f"tokenizer.json: Unigram unk_id "
                             f"{self.unk_id} is not in the vocabulary")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.scores = [sc for _, sc in pieces]
        self.vocab: dict[str, int] = {}
        for i, (p, _) in enumerate(pieces):
            self.vocab[p] = i
        self.vocab_r = {i: p for i, (p, _) in enumerate(pieces)}
        self.min_score = min(self.scores, default=float("inf"))
        self._lengths = sorted({len(p) for p, _ in pieces if p})
        self._cache: dict[str, tuple[int, ...]] = {}

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        hit = self._cache.get(word)
        if hit is None:
            hit = self._ids(self._viterbi(word))
            if len(self._cache) < BPE.CACHE_WORDS:
                self._cache[word] = hit
        return hit

    def _viterbi(self, s: str) -> list[str]:
        n = len(s)
        unk_score = self.min_score - self.UNK_PENALTY
        # best[end] = (score, start, id) of the best path ending at end
        best: list[Optional[tuple[float, int, int]]] = [None] * (n + 1)
        best[0] = (0.0, 0, -1)
        vocab, scores = self.vocab, self.scores
        for start in range(n):
            here = best[start][0]
            single = False
            for ln in self._lengths:
                if start + ln > n:
                    break
                tid = vocab.get(s[start:start + ln])
                if tid is None:
                    continue
                cand = scores[tid] + here
                node = best[start + ln]
                if node is None or cand > node[0]:
                    best[start + ln] = (cand, start, tid)
                if ln == 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("tokenizer.json: Unigram needs an "
                                     "unk_id for a character it lacks")
                cand = unk_score + here
                node = best[start + 1]
                if node is None or cand > node[0]:
                    best[start + 1] = (cand, start, self.unk_id)
        out: list[str] = []
        fused: list[str] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id:
                fused.append(s[start:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[start:end])
            end = start
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def _ids(self, pieces: list[str]) -> tuple[int, ...]:
        ids: list[int] = []
        for p in pieces:
            tid = self.vocab.get(p)
            if tid is not None:
                ids.append(tid)
                continue
            if self.byte_fallback:
                bs = [self.vocab.get(f"<0x{b:02X}>") for b in p.encode()]
                if None not in bs:
                    ids.extend(bs)
                    continue
            ids.append(self.unk_id)
        return tuple(ids)


_MODELS = {"BPE": BPE, "WordLevel": WordLevel, "WordPiece": WordPiece,
           "Unigram": Unigram}


# ---------------------------------------------------------------------------
# The tokenizer


class TokenizerJSON:
    """``tokenizer.json`` → ``encode``/``decode`` equal to ``tokenizers``'
    ``encode(text, add_special_tokens=False).ids`` and
    ``decode(ids, skip_special_tokens=False)``."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        kind = model.get("type") or ("BPE" if "merges" in model else None)
        if kind not in _MODELS:
            raise ValueError(f"tokenizer.json: model {kind!r} is not "
                             "supported (this reader has "
                             f"{' and '.join(_MODELS)})")
        self.model = _MODELS[kind](model)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decoder = _decoder(spec.get("decoder"))
        self._post = spec.get("post_processor")
        added = list(spec.get("added_tokens") or [])
        self.added_r = {int(t["id"]): t["content"] for t in added}
        self.added = {t["content"]: int(t["id"]) for t in added}
        raw = [t for t in added if not t.get("normalized", False)]
        norm = [t for t in added if t.get("normalized", False)]
        self._raw_split = _AddedTokens(raw, [t["content"] for t in raw])
        self._norm_split = _AddedTokens(
            norm, [self.normalize(t["content"]) for t in norm])
        self.vocab_size = len(set(self.model.vocab) | {
            t["content"] for t in added})

    @classmethod
    def from_file(cls, path: str | Path) -> "TokenizerJSON":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> list[int]:
        ids = self._encode(text)
        return self.post_process(ids) if add_special_tokens else ids

    def post_process(self, ids: list[int]) -> list[int]:
        """The post-processor over one sequence: ``RobertaProcessing``
        wraps it in its ``cls`` and ``sep`` ids; ``TemplateProcessing``
        lays out its ``single`` template (``$A`` and special tokens)."""
        kind = (self._post or {}).get("type")
        if kind == "RobertaProcessing":
            return [int(self._post["cls"][1]), *ids,
                    int(self._post["sep"][1])]
        if kind == "TemplateProcessing":
            out: list[int] = []
            for piece in self._post["single"]:
                if "Sequence" in piece:
                    out.extend(ids)
                else:
                    tok = piece["SpecialToken"]["id"]
                    out.extend(int(i) for i in
                               self._post["special_tokens"][tok]["ids"])
            return out
        raise ValueError(f"tokenizer.json: post-processor {kind!r} is not "
                         "supported (this reader has RobertaProcessing and "
                         "TemplateProcessing)")

    def _encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for a, b, tid in self._raw_split.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            normalized = self.normalize(text[a:b])
            pieces = self._norm_split.split(normalized)
            for k, (c, d, nid) in enumerate(pieces):
                if nid is not None:
                    ids.append(nid)
                    continue
                first = a == 0 and k == 0
                for word, _ in self.pre_tokenize([(normalized[c:d], first)]):
                    ids.extend(self.model.tokenize(word))
        return ids

    def token_to_id(self, token: str) -> Optional[int]:
        """The id of ``token``: an added token's, else the vocabulary's,
        else None."""
        tid = self.added.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        tok = self.added_r.get(i)
        return tok if tok is not None else self.model.vocab_r.get(i)

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [t for t in map(self.id_to_token, ids) if t is not None]
        if self._decoder is None:
            return " ".join(tokens)
        return "".join(self._decoder(tokens))


# the pre-tokenizer split of transformers' CLIPConverter
CLIP_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]"
                r"|[^\s\p{L}\p{N}]+")
# the merges CLIPTokenizer reads from merges.txt: the lines after the
# version header, at most 49152 - 256 - 2 of them
CLIP_MAX_MERGES = 49152 - 256 - 2


def read_clip_merges(text: str) -> list[list[str]]:
    """``merges.txt`` as ``CLIPTokenizer`` reads it."""
    lines = text.strip().split("\n")[1:CLIP_MAX_MERGES + 1]
    return [line.split() for line in lines]


def clip_tokenizer_spec(vocab: dict[str, int], merges: list, *,
                        bos: str = "<|startoftext|>",
                        eos: str = "<|endoftext|>",
                        unk: str = "<|endoftext|>",
                        specials: Sequence[str] = ()) -> dict:
    """The ``tokenizer.json`` of ``CLIPTokenizerFast`` over a CLIP
    ``vocab.json`` and ``merges.txt`` (``transformers``' ``CLIPConverter``):
    NFC, white-space runs to one space and lowercase; a split on CLIP's
    pattern (matches kept, the rest removed), then ``ByteLevel`` without a
    prefix space; BPE with ``</w>`` ending each word and ``unk`` for
    anything else; ``RobertaProcessing`` between ``bos`` and ``eos``. The
    special tokens (``bos``, ``eos``, ``unk`` and ``specials``, in that
    order, each once) are added, normalized, as ``transformers`` adds
    them."""
    added, seen = [], set()
    for tok in (bos, eos, unk, *specials):
        if tok in seen or tok not in vocab:
            continue
        seen.add(tok)
        added.append({"id": vocab[tok], "content": tok, "single_word": False,
                      "lstrip": False, "rstrip": False, "normalized": True,
                      "special": True})
    return {
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"},
            {"type": "Replace", "pattern": {"Regex": r"\s+"},
             "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_PATTERN},
             "behavior": "Removed", "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": True}]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": [eos, vocab.get(eos)],
                           "cls": [bos, vocab.get(bos)],
                           "trim_offsets": False,
                           "add_prefix_space": False},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": unk,
                  "continuing_subword_prefix": "",
                  "end_of_word_suffix": "</w>", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
