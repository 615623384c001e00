"""SentencePiece on the standard library: the ``precompiled_charsmap`` of
its normalizer, extended grapheme clusters, and its protobuf
``ModelProto`` (``tokenizer.model`` / ``spiece.model``).

The card's machine has neither ``sentencepiece`` nor ``protobuf`` nor
``tokenizers``, so the port reads these formats itself:

* :class:`Charsmap` is the ``Precompiled`` normalizer of ``tokenizers``
  (its ``spm_precompiled`` crate): a little-endian u32 byte size of a
  darts-clone double array, the array's u32 units, then NUL-terminated
  normalized strings. :meth:`Charsmap.normalize` walks the text's
  extended grapheme clusters: a cluster shorter than 6 bytes is looked up
  whole and the FIRST (shortest) key that prefixes it wins, the rest of
  the cluster dropped; otherwise (a longer cluster, or no key prefixing
  it) each character is looked up alone and kept when no key matches.
* :func:`charsmap_bytes` writes such a blob from ``{key: normalized}``
  pairs (the tests and ``chip_smoke.py`` build tokenizers with it): each
  unit's offset is stored XOR-relative to the unit's own position, and the
  array is padded to whole 256-unit blocks, since the Rust reader indexes
  ``base ^ byte`` without a bounds check.
* :func:`graphemes` splits text into extended grapheme clusters
  (UAX #29 with this interpreter's ``unicodedata``: CR LF, controls,
  Extend — Mn, Me, Other_Grapheme_Extend, ZWJ, emoji modifiers —,
  SpacingMark, Prepend, Hangul L/V/T/LV/LVT from the code point,
  emoji ZWJ sequences over Extended_Pictographic, regional-indicator
  pairs). The Indic conjunct rule (GB9c) and the unassigned
  default-ignorable controls are not modelled: ROADMAP lists the
  divergences the tests record.
* :func:`read_model` decodes a ``ModelProto`` from its wire format by
  hand: the pieces (text, score, type), ``trainer_spec`` (model type,
  unk/bos/eos/pad ids, ``byte_fallback``) and ``normalizer_spec``
  (``precompiled_charsmap``, ``add_dummy_prefix``,
  ``remove_extra_whitespaces``); :func:`t5_tokenizer_spec` builds from it
  the ``tokenizer.json`` that ``transformers``' ``T5Converter`` builds.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import struct
import unicodedata
from typing import Optional

# ---------------------------------------------------------------------------
# the darts-clone double array

_LEAF = 1 << 31


def _offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


class Charsmap:
    """A ``precompiled_charsmap``: ``normalize`` is ``tokenizers``'
    ``Precompiled`` normalizer."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: shorter than its size "
                             "field")
        (size,) = struct.unpack_from("<I", blob, 0)
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"precompiled_charsmap: trie of {size} bytes "
                             f"in a blob of {len(blob)}")
        n = size // 4
        self.units = struct.unpack_from(f"<{n}I", blob, 4)
        if n == 0:
            raise ValueError("precompiled_charsmap: empty trie")
        self.normalized = blob[4 + size:]
        self.normalized.decode("utf-8")        # the Rust reader's check
        self._cache: dict[str, Optional[str]] = {}

    @classmethod
    def from_base64(cls, text: str) -> "Charsmap":
        return cls(base64.b64decode(text))

    def prefix_values(self, key: bytes) -> list[int]:
        """Values of the keys that prefix ``key``, shortest first (the
        traversal stops at a NUL byte)."""
        units = self.units
        out: list[int] = []
        pos = _offset(units[0])
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & (_LEAF | 0xFF) != c:
                break
            pos ^= _offset(unit)
            if (unit >> 8) & 1:
                out.append(units[pos] & (_LEAF - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        """The normalized form of the first key prefixing ``chunk``."""
        hit = self._cache.get(chunk, self)
        if hit is not self:
            return hit
        vals = self.prefix_values(chunk.encode("utf-8"))
        out = None
        if vals:
            i = vals[0]
            j = self.normalized.find(b"\0", i)
            out = self.normalized[i:j if j >= 0 else len(self.normalized)
                                  ].decode("utf-8")
        if len(self._cache) < 100_000:
            self._cache[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        out: list[str] = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                hit = self.transform(g)
                if hit is not None:
                    out.append(hit)
                    continue
            for c in g:
                hit = self.transform(c)
                out.append(c if hit is None else hit)
        return "".join(out)


def charsmap_bytes(table: dict[str, str]) -> bytes:
    """A ``precompiled_charsmap`` blob mapping each key to its normalized
    string (keys non-empty, without NUL)."""
    blob = bytearray()
    where: dict[str, int] = {}
    for v in table.values():
        if v not in where:
            where[v] = len(blob)
            blob += v.encode("utf-8") + b"\0"
    root: dict = {}
    for k, v in table.items():
        kb = k.encode("utf-8")
        if not kb or 0 in kb:
            raise ValueError(f"charsmap key {k!r}: empty or with NUL")
        node = root
        for b in kb:
            node = node.setdefault(b, {})
        node[None] = where[v]
    units = [0] * 256
    used = {0}
    bases: set[int] = set()
    free = 1
    queue = [(root, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        slots = ([0] if None in node else []) + labels
        while free in used:
            free += 1
        base = max(free & ~0xFF, 1)
        while base in bases or any((base ^ c) in used for c in slots):
            base += 1
        bases.add(base)
        end = (base | 0xFF) + 1
        if end > len(units):
            units.extend([0] * (end - len(units)))
        off = pos ^ base
        if off >= 1 << 21:
            raise ValueError("charsmap too large for the double array")
        units[pos] |= off << 10
        if None in node:
            units[pos] |= 1 << 8
            units[base] = node[None] | _LEAF
            used.add(base)
        for c in labels:
            used.add(base ^ c)
            units[base ^ c] = c
            queue.append((node[c], base ^ c))
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + bytes(blob))


# ---------------------------------------------------------------------------
# extended grapheme clusters (UAX #29)

# Other_Grapheme_Extend (Unicode 15), ZWNJ and the tag characters are
# Extend; the emoji modifiers are too
_EXTEND_EXTRA = ((0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E),
                 (0x0B57, 0x0B57), (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7),
                 (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E),
                 (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
                 (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F),
                 (0xFF9E, 0xFF9F), (0x1133E, 0x1133E), (0x11357, 0x11357),
                 (0x114B0, 0x114B0), (0x114BD, 0x114BD), (0x115AF, 0x115AF),
                 (0x11930, 0x11930), (0x1D165, 0x1D165),
                 (0x1D16E, 0x1D172), (0xE0020, 0xE007F),
                 (0x1F3FB, 0x1F3FF))
# spacing marks (Mc) that are not SpacingMark, and the two that are
# without being Mc
_NOT_SPACING = ((0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064),
                (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
                (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61),
                (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
                (0x11720, 0x11721))
_SPACING_EXTRA = ((0x0E33, 0x0E33), (0x0EB3, 0x0EB3))
_PREPEND = ((0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F),
            (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
            (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
            (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A),
            (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02))
# Extended_Pictographic (emoji-data.txt)
_PICTOGRAPHIC = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _within(cp: int, ranges) -> bool:
    return any(lo <= cp <= hi for lo, hi in ranges)


@functools.lru_cache(maxsize=65536)
def _gcb(c: str) -> str:
    """The Grapheme_Cluster_Break class of one character (and "Pict" for
    an Extended_Pictographic one otherwise "Any")."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if _within(cp, _PREPEND):
        return "Prepend"
    if _within(cp, _EXTEND_EXTRA):
        return "Extend"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me"):
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if (cat == "Mc" and not _within(cp, _NOT_SPACING)) or \
            _within(cp, _SPACING_EXTRA):
        return "SpacingMark"
    if _within(cp, _PICTOGRAPHIC):
        return "Pict"
    return "Any"


_HANGUL_NEXT = {"L": ("L", "V", "LV", "LVT"), "LV": ("V", "T"),
                "V": ("V", "T"), "LVT": ("T",), "T": ("T",)}


def graphemes(text: str) -> list[str]:
    """``text`` as its extended grapheme clusters."""
    out: list[str] = []
    if not text:
        return out
    start = 0
    prev = _gcb(text[0])
    ri_run = 1 if prev == "RI" else 0      # regional indicators ending here
    pict = 1 if prev == "Pict" else 0      # 1: Pict Extend*, 2: ... ZWJ
    for i in range(1, len(text)):
        cur = _gcb(text[i])
        if prev == "CR" and cur == "LF":
            brk = False
        elif prev in ("Control", "CR", "LF") or \
                cur in ("Control", "CR", "LF"):
            brk = True
        elif cur in _HANGUL_NEXT.get(prev, ()):
            brk = False
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            brk = False
        elif prev == "ZWJ" and cur == "Pict" and pict == 2:
            brk = False
        elif prev == "RI" and cur == "RI":
            brk = ri_run % 2 == 0
        else:
            brk = True
        if brk:
            out.append(text[start:i])
            start = i
        ri_run = ri_run + 1 if cur == "RI" else 0
        if cur == "Pict":
            pict = 1
        elif cur == "Extend" and pict == 1:
            pict = 1
        elif cur == "ZWJ" and pict == 1:
            pict = 2
        else:
            pict = 0
        prev = cur
    out.append(text[start:])
    return out


# ---------------------------------------------------------------------------
# SentencePiece's ModelProto (protobuf wire format)

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4
MODEL_TYPES = {UNIGRAM: "Unigram", BPE: "BPE", WORD: "Word", CHAR: "Char"}


@dataclasses.dataclass
class Piece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclasses.dataclass
class ModelProto:
    pieces: list[Piece]
    model_type: int = UNIGRAM
    vocab_size: int = 8000
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("ModelProto: truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of one message: varints as ints,
    fixed32 / fixed64 as their little-endian bytes, length-delimited
    fields as bytes."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"ModelProto: wire type {wt} of field {num} "
                             "is not supported")
        if i > len(buf):
            raise ValueError("ModelProto: truncated field")
        yield num, wt, v


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def read_model(data: bytes) -> ModelProto:
    """A SentencePiece ``tokenizer.model`` / ``spiece.model``."""
    pieces: list[Piece] = []
    m = ModelProto(pieces=pieces)
    for num, wt, v in _fields(data):
        if num == 1 and wt == 2:
            p = Piece("")
            for n2, w2, v2 in _fields(v):
                if n2 == 1 and w2 == 2:
                    p.piece = v2.decode("utf-8")
                elif n2 == 2 and w2 == 5:
                    p.score = struct.unpack("<f", v2)[0]
                elif n2 == 3 and w2 == 0:
                    p.type = v2
            pieces.append(p)
        elif num == 2 and wt == 2:
            for n2, w2, v2 in _fields(v):
                if w2 != 0 and n2 != 45:
                    continue
                if n2 == 3:
                    m.model_type = v2
                elif n2 == 4:
                    m.vocab_size = _int32(v2)
                elif n2 == 35:
                    m.byte_fallback = bool(v2)
                elif n2 == 40:
                    m.unk_id = _int32(v2)
                elif n2 == 41:
                    m.bos_id = _int32(v2)
                elif n2 == 42:
                    m.eos_id = _int32(v2)
                elif n2 == 43:
                    m.pad_id = _int32(v2)
                elif n2 == 45 and w2 == 2:
                    m.unk_piece = v2.decode("utf-8")
        elif num == 3 and wt == 2:
            for n2, w2, v2 in _fields(v):
                if n2 == 2 and w2 == 2:
                    m.precompiled_charsmap = bytes(v2)
                elif n2 == 3 and w2 == 0:
                    m.add_dummy_prefix = bool(v2)
                elif n2 == 4 and w2 == 0:
                    m.remove_extra_whitespaces = bool(v2)
    return m


def _prepend_scheme(add_prefix_space: bool, legacy: bool) -> str:
    """``transformers``' ``_get_prepend_scheme``."""
    if not add_prefix_space:
        return "never"
    return "always" if legacy else "first"


def t5_tokenizer_spec(model: ModelProto, *, extra_ids: int = 100,
                      legacy: bool = True,
                      add_prefix_space: bool = True) -> dict:
    """The ``tokenizer.json`` that ``T5Converter(...).converted()`` builds
    from a Unigram ``ModelProto``: the pieces then ``<extra_id_N>`` for N
    from ``extra_ids - 1`` down to 0 (score 0); control and user-defined
    pieces as added tokens (control ones special), not normalized; the
    charsmap (when there is one), right strip, runs of two or more spaces
    to one "▁"; Metaspace with the prepend scheme of ``add_prefix_space``
    and ``legacy``; ``$A </s>`` as the post-processor."""
    if model.model_type != UNIGRAM:
        raise ValueError(
            f"tokenizer.model: a {MODEL_TYPES.get(model.model_type, '?')} "
            "SentencePiece model; the port builds T5's Unigram one only "
            "(ROADMAP §C 11)")
    vocab = [[p.piece, p.score] for p in model.pieces]
    vocab += [[f"<extra_id_{i}>", 0.0] for i in range(extra_ids - 1, -1, -1)]
    added = [{"id": i, "content": p.piece, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": p.type == CONTROL}
             for i, p in enumerate(model.pieces)
             if p.type in (CONTROL, USER_DEFINED)]
    norms: list[dict] = [
        {"type": "Strip", "strip_left": False, "strip_right": True},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]
    if model.precompiled_charsmap:
        norms.insert(0, {"type": "Precompiled", "precompiled_charsmap":
                         base64.b64encode(model.precompiled_charsmap)
                         .decode()})
    scheme = _prepend_scheme(add_prefix_space, legacy)
    meta = {"type": "Metaspace", "replacement": "▁",
            "prepend_scheme": scheme, "split": True}
    eos = next((i for i, p in enumerate(vocab) if p[0] == "</s>"), None)
    return {
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [eos],
                                        "tokens": ["</s>"]}}},
        "decoder": dict(meta),
        "model": {"type": "Unigram", "unk_id": model.unk_id,
                  "vocab": vocab, "byte_fallback": False},
    }
