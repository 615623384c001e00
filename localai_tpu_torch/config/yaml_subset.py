"""A YAML reader for model configs, on the standard library alone.

The machine with the card has no PyYAML, so the port reads its model
YAMLs with this module, everywhere (one parse in every environment).
It reads the part of YAML that model configs use, with the meaning
PyYAML's ``safe_load`` gives it:

  * block mappings and sequences nested to any depth, with compact
    ``- key: value`` items and sequences at their key's indentation;
  * block scalars ``|`` and ``>`` with the chomping (``-``/``+``) and
    indentation indicators — Go templates live in these;
  * plain, single- and double-quoted scalars over one or several lines
    (folded as PyYAML folds them), with YAML's double-quote escapes;
  * flow sequences and flow mappings, over one or several lines;
  * anchors (``&a``) and aliases (``*a``), an alias giving the anchored
    node's value (an undefined or a second definition raises, as in
    PyYAML);
  * merge keys, ``<<:`` or ``!!merge <<:``, of a mapping or a sequence of
    mappings (the first mapping of a sequence wins, a later merge key over
    an earlier one, explicit keys over all), with PyYAML's key order;
  * comments, a leading ``---`` and a closing ``...``.

Plain scalars resolve as PyYAML's ``SafeLoader`` resolves them (YAML 1.1):
``yes``/``no``/``on``/``off`` are booleans, ``~``, ``null`` and an empty
value are None, and the int and float patterns are PyYAML's own (so
``1e3`` stays a string; ``0x1f``, ``017`` and ``1:30`` are ints). The
scanning rules (folding, block scalar indentation and chomping, the end
of a plain scalar) follow PyYAML's scanner line by line.

Anything else — a tag other than ``!!merge`` on a mapping key,
directives, several documents, complex (``?``) keys, timestamps — raises
a ``ValueError`` that names the line: the reader never guesses.

``safe_dump`` writes the values model configs hold (mappings, sequences,
strings — multi-line ones as literal block scalars —, numbers, booleans,
None) as block YAML that both this reader and PyYAML's ``safe_load`` read
back to the object dumped.
"""

from __future__ import annotations

import re
from typing import Any, Optional

_WS_END = "\0 \t\n"          # what may follow ':' or '-' as an indicator
_FLOW_IND = ",[]{}"

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# an anchor's or alias's name (PyYAML's scan_anchor) and what may end it
_ANCHOR_NAME = re.compile(r"[0-9A-Za-z_-]+")
_ANCHOR_END = "\0 \t\n?:,]}%@`"
# the merge key of a flow mapping, apart from a plain "<<" value
_MERGE = object()


def safe_load(text: str) -> Any:
    """Parse one YAML document into dicts, lists and scalars, as PyYAML's
    ``safe_load`` would; refuse what the subset does not take."""
    return _Reader(text).document()


def _sexagesimal(value: str, cast) -> Any:
    out, base = cast(0), 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def resolve_plain(value: str, line: int = 0) -> Any:
    """A plain scalar's value under PyYAML's SafeLoader (YAML 1.1)."""
    if _NULL.match(value):
        return None
    if _BOOL.match(value):
        return value.lower() in ("yes", "true", "on")
    if value and value[0] in "-+0123456789.":
        if _FLOAT.match(value):
            v = value.replace("_", "").lower()
            sign = -1 if v[0] == "-" else 1
            if v[0] in "+-":
                v = v[1:]
            if v == ".inf":
                return sign * float("inf")
            if v == ".nan":
                return float("nan")
            if ":" in v:
                return sign * _sexagesimal(v, float)
            return sign * float(v)
        if _INT.match(value):
            v = value.replace("_", "")
            sign = -1 if v[0] == "-" else 1
            if v[0] in "+-":
                v = v[1:]
            if v == "0":
                return 0
            if v.startswith("0b"):
                return sign * int(v[2:], 2)
            if v.startswith("0x"):
                return sign * int(v[2:], 16)
            if v[0] == "0":
                return sign * int(v, 8)
            if ":" in v:
                return sign * _sexagesimal(v, int)
            return sign * int(v)
        if _TIMESTAMP.match(value):
            raise ValueError(f"line {line}: timestamps are not supported "
                             f"by the port's YAML reader ({value!r}); quote "
                             "the value")
    if value == "<<":
        raise ValueError(f"line {line}: merge keys (<<) are not supported "
                         "by the port's YAML reader")
    if value == "=":
        raise ValueError(f"line {line}: the value key (=) is not supported")
    return value


class _Reader:
    """Recursive descent over the text; ``i`` is the position."""

    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace(
            "\x85", "\n")
        for ch in ("\u2028", "\u2029"):
            if ch in text:
                self.s, self.i = text, text.index(ch)
                self.fail("the line separators U+2028/U+2029 are not "
                          "supported")
        self.s = text
        self.i = 0
        self.flow = 0
        self.anchors: dict[str, Any] = {}

    # -- positions -----------------------------------------------------

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def line(self) -> int:
        return self.s.count("\n", 0, self.i) + 1

    @property
    def column(self) -> int:
        return self.i - self.s.rfind("\n", 0, self.i) - 1

    def fail(self, msg: str):
        raise ValueError(f"line {self.line()}: {msg}")

    def at_doc_marker(self) -> bool:
        return (self.column == 0 and self.s.startswith(("---", "..."),
                                                       self.i)
                and self.peek(3) in _WS_END)

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def skip_to_content(self) -> None:
        """Past spaces, comments and line breaks (scan_to_next_token)."""
        while True:
            self.skip_spaces()
            if self.peek() == "#":
                while self.peek() not in "\0\n":
                    self.i += 1
            if self.peek() == "\n":
                self.i += 1
            else:
                return

    def end_of_line(self) -> None:
        """Only a comment may follow a node on its line."""
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in "\0\n":
                self.i += 1
        if self.peek() not in "\0\n":
            self.fail(f"unexpected {self.peek()!r} after a value")

    # -- document ------------------------------------------------------

    def document(self) -> Any:
        self.skip_to_content()
        if self.peek() == "%" and self.column == 0:
            self.fail("YAML directives (%) are not supported")
        if self.at_doc_marker() and self.s.startswith("---", self.i):
            self.i += 3
        node = self.block_node(-1)
        self.skip_to_content()
        if self.at_doc_marker() and self.s.startswith("...", self.i):
            self.i += 3
            self.skip_to_content()
        if self.peek() != "\0":
            if self.at_doc_marker():
                self.fail("several documents in one file are not "
                          "supported")
            self.fail(f"unexpected {self.peek()!r}")
        return node

    # -- block structure -----------------------------------------------

    def refuse_indicator(self) -> None:
        ch = self.peek()
        if ch == "!":
            self.fail("tags (!) are not supported by the port's YAML "
                      "reader")
        if ch == "?" and self.peek(1) in _WS_END:
            self.fail("complex keys (?) are not supported by the port's "
                      "YAML reader")
        if ch in "%@`":
            self.fail(f"{ch!r} cannot start a value")

    # -- anchors, aliases, merge keys -----------------------------------

    def anchor_name(self, what: str) -> str:
        """The name after '&' or '*' (here)."""
        self.i += 1
        m = _ANCHOR_NAME.match(self.s, self.i)
        if m is None or (m.end() < len(self.s)
                         and self.s[m.end()] not in _ANCHOR_END):
            self.fail(f"expected alphabetic or numeric characters in an "
                      f"{what}")
        self.i = m.end()
        return m.group()

    def properties(self) -> tuple[Any, Any]:
        """A node's anchor and tag (either order), and the spaces after
        them; (None, None) when neither is here."""
        anchor = tag = None
        while self.peek() in "&!":
            if self.peek() == "&":
                if anchor is not None:
                    self.fail("a node has two anchors")
                anchor = self.anchor_name("anchor")
            else:
                if tag is not None:
                    self.fail("a node has two tags")
                begin = self.i
                while self.peek() not in "\0 \t\n":
                    self.i += 1
                tag = self.s[begin:self.i]
            self.skip_spaces()
        return anchor, tag

    def refuse_tag(self, tag) -> None:
        """A tag on a node that is not a mapping key: never taken."""
        if tag is not None:
            self.fail(f"tags (!) are not supported by the port's YAML "
                      f"reader ({tag})")

    def define(self, anchor, value) -> None:
        if anchor is None:
            return
        if anchor in self.anchors:
            self.fail(f"found duplicate anchor {anchor!r}")
        self.anchors[anchor] = value

    def alias(self) -> Any:
        name = self.anchor_name("alias")
        if name not in self.anchors:
            self.fail(f"found undefined alias {name!r}")
        return self.anchors[name]

    @staticmethod
    def merge_pairs(value, line: int) -> list:
        """The (key, value) pairs a merge key (on ``line``) adds, in
        PyYAML's order: a sequence's mappings last to first, so the first
        wins."""
        if isinstance(value, dict):
            return list(value.items())
        if isinstance(value, list) and all(isinstance(v, dict)
                                           for v in value):
            return [kv for v in reversed(value) for kv in v.items()]
        raise ValueError(f"line {line}: expected a mapping or list of "
                         "mappings for merging")

    def build_mapping(self, merges: list, pairs: list) -> dict:
        """PyYAML's flatten_mapping then construct_mapping: every merged
        pair first, in merge-key order, then the explicit pairs."""
        out: dict = {}
        try:
            for key, value in merges + pairs:
                out[key] = value
        except TypeError:
            self.fail("complex (collection) keys are not supported")
        return out

    def is_entry(self) -> bool:
        return self.peek() == "-" and self.peek(1) in _WS_END

    def block_node(self, indent: int) -> Any:
        """The node at the next content, if it is indented past
        ``indent`` (the enclosing block collection's column)."""
        self.skip_to_content()
        if self.peek() == "\0" or self.column <= indent or \
                self.at_doc_marker():
            return None
        if self.is_entry():
            return self.block_sequence(self.column)
        col = self.column
        if self.peek() in "&!":
            start = self.i
            anchor, tag = self.properties()
            if self.peek() not in "#\0\n":
                rest = self.i
                if self.scan_key_candidate():
                    # the properties are the first key's
                    self.i = start
                    return self.block_mapping(col)
                self.i = rest
                self.refuse_tag(tag)
                value = self.node_on_line(indent)
            else:
                self.refuse_tag(tag)
                value = self.block_node(indent)
            self.define(anchor, value)
            return value
        if self.peek() in "|>":
            return self.block_scalar(indent)
        self.refuse_indicator()
        start = self.i
        if self.scan_key_candidate():
            self.i = start
            return self.block_mapping(col)
        self.i = start
        if self.peek() == "*":
            value = self.alias()
            self.end_of_line()
            return value
        value = self.inline_value(indent)
        return value

    def node_on_line(self, indent: int) -> Any:
        """The content after a node's properties, on their line."""
        if self.peek() == "*":
            self.fail("an alias cannot have an anchor or a tag")
        if self.is_entry():
            self.fail("a block sequence cannot start on its properties' "
                      "line")
        if self.peek() in "|>":
            return self.block_scalar(indent)
        self.refuse_indicator()
        return self.inline_value(indent)

    def scan_key_candidate(self) -> bool:
        """Whether the node here is an implicit key: a one-line scalar
        followed by ':' and a space or the line's end."""
        ch = self.peek()
        line = self.line()
        if ch in "[{":
            self.flow_collection()
            self.skip_spaces()
            if self.peek() == ":" and self.peek(1) in _WS_END:
                self.fail("complex (collection) keys are not supported")
            return False
        if ch in "'\"":
            self.quoted(ch == '"')
            if self.line() != line:
                return False
            self.skip_spaces()
            return self.peek() == ":" and self.peek(1) in _WS_END
        while True:
            c = self.peek()
            if c in "\0\n" or (c == "#" and self.s[self.i - 1] in " \t"):
                return False
            if c == ":" and self.peek(1) in _WS_END:
                return True
            self.i += 1

    def block_mapping(self, col: int) -> dict:
        pairs: list = []
        merges: list = []
        while True:
            key, merge = self.key_node()
            self.skip_spaces()
            if not (self.peek() == ":" and self.peek(1) in _WS_END):
                self.fail("expected ':' after a mapping key")
            self.i += 1
            line = self.line()
            value = self.mapping_value(col)
            if merge:
                merges.extend(self.merge_pairs(value, line))
            else:
                pairs.append((key, value))
            self.skip_to_content()
            if self.peek() == "\0" or self.at_doc_marker() or \
                    self.column < col:
                return self.build_mapping(merges, pairs)
            if self.column > col:
                self.fail("bad indentation of a mapping entry")
            if self.is_entry():
                self.fail("a sequence entry where a mapping key was "
                          "expected")
            start = self.i
            if not self.scan_key_candidate():
                self.i = start
                self.fail("expected a mapping key ('key: value')")
            self.i = start

    def key_node(self) -> tuple[Any, bool]:
        """A block mapping's key with its properties, and whether it is a
        merge key (a plain ``<<``, or any key tagged ``!!merge``)."""
        line = self.line()
        anchor, tag = self.properties()
        if tag is not None and tag != "!!merge":
            self.refuse_tag(tag)
        merge = tag is not None
        ch = self.peek()
        if ch == "*":
            if anchor is not None or tag is not None:
                self.fail("an alias cannot have an anchor or a tag")
            key = self.alias()
        elif ch in "'\"":
            key = self.quoted(ch == '"')
        else:
            self.refuse_indicator()
            begin = self.i
            while not (self.peek() == ":" and self.peek(1) in _WS_END):
                self.i += 1
            raw = self.s[begin:self.i].rstrip(" \t")
            if raw == "<<":
                key, merge = raw, True
            else:
                key = resolve_plain(raw, line)
        self.define(anchor, key)
        return key, merge

    def mapping_value(self, col: int) -> Any:
        self.skip_spaces()
        anchor, tag = self.properties()
        self.refuse_tag(tag)
        value = self.mapping_content(col, anchor is not None)
        self.define(anchor, value)
        return value

    def mapping_content(self, col: int, anchored: bool) -> Any:
        if self.peek() in "#\0\n":
            self.skip_to_content()
            if self.peek() == "\0" or self.at_doc_marker():
                return None
            if self.column == col and self.is_entry():
                return self.block_sequence(col)   # at the key's column
            return self.block_node(col)
        if self.peek() == "*":
            if anchored:
                self.fail("an alias cannot have an anchor or a tag")
            value = self.alias()
            self.end_of_line()
            return value
        if self.is_entry():
            self.fail("a block sequence cannot start on its key's line")
        if self.peek() in "|>":
            return self.block_scalar(col)
        self.refuse_indicator()
        value = self.inline_value(col)
        return value

    def block_sequence(self, col: int) -> list:
        out: list = []
        while True:
            self.i += 1  # '-'
            self.skip_spaces()
            out.append(self.block_node(col))
            self.skip_to_content()
            if self.peek() == "\0" or self.at_doc_marker() or \
                    self.column < col:
                return out
            if self.column > col:
                self.fail("bad indentation of a sequence entry")
            if not self.is_entry():
                return out   # the mapping that holds an indentless one
                             # goes on at this column

    def inline_value(self, indent: int) -> Any:
        """A flow collection or a scalar starting here, then the line's
        end; ``indent`` is the enclosing block collection's column."""
        ch = self.peek()
        line = self.line()
        if ch in "[{":
            value = self.flow_collection()
        elif ch in "'\"":
            value = self.quoted(ch == '"')
        else:
            if not self.can_start_plain():
                self.fail(f"{ch!r} cannot start a value")
            value = resolve_plain(self.plain(indent), line)
        self.skip_spaces()
        if self.peek() == ":" and self.peek(1) in _WS_END:
            self.fail("mapping values are not allowed here")
        self.end_of_line()
        return value

    # -- scalars -------------------------------------------------------

    def can_start_plain(self) -> bool:
        ch = self.peek()
        return (ch not in "\0 \t\n-?:,[]{}#&*!|>'\"%@`"
                or (self.peek(1) not in "\0 \t\n"
                    and (ch == "-" or (not self.flow and ch in "?:"))))

    def plain(self, indent: int) -> str:
        """PyYAML's scan_plain: ``indent`` is the enclosing block
        collection's column; continuation lines sit past it."""
        chunks: list[str] = []
        spaces: list[str] = []
        min_col = indent + 1
        while True:
            length = 0
            if self.peek() == "#":
                break
            while True:
                ch = self.peek(length)
                if ch in "\0 \t\n" or (
                        ch == ":" and self.peek(length + 1) in
                        "\0 \t\n" + (_FLOW_IND if self.flow else "")) or (
                        self.flow and ch in ",?[]{}"):
                    break
                length += 1
            if length == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.i:self.i + length])
            self.i += length
            end = self.i
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (
                    not self.flow and self.column < min_col):
                break
        if chunks:
            self.i = end   # the line's rest (a comment) is the caller's
        return "".join(chunks)

    def plain_spaces(self):
        chunks: list[str] = []
        begin = self.i
        self.skip_spaces()
        whitespaces = self.s[begin:self.i]
        if self.peek() == "\n":
            self.i += 1
            if self.at_doc_marker():
                return None
            breaks = []
            while self.peek() in " \n":
                if self.peek() == " ":
                    self.i += 1
                else:
                    self.i += 1
                    breaks.append("\n")
                    if self.at_doc_marker():
                        return None
            if not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        elif whitespaces:
            chunks.append(whitespaces)
        return chunks

    def quoted(self, double: bool) -> str:
        """PyYAML's scan_flow_scalar."""
        quote = self.peek()
        self.i += 1
        chunks = self.quoted_non_spaces(double)
        while self.peek() != quote:
            chunks.extend(self.quoted_spaces())
            chunks.extend(self.quoted_non_spaces(double))
        self.i += 1
        return "".join(chunks)

    def quoted_non_spaces(self, double: bool) -> list[str]:
        chunks: list[str] = []
        while True:
            length = 0
            while self.peek(length) not in "'\"\\\0 \t\n":
                length += 1
            if length:
                chunks.append(self.s[self.i:self.i + length])
                self.i += length
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.i += 1
                    digits = self.s[self.i:self.i + n]
                    if len(digits) != n or not all(
                            c in "0123456789ABCDEFabcdef" for c in digits):
                        self.fail(f"expected {n} hexadecimal digits in an "
                                  "escape")
                    chunks.append(chr(int(digits, 16)))
                    self.i += n
                elif ch == "\n":
                    self.i += 1
                    chunks.extend(self.quoted_breaks())
                else:
                    self.fail(f"unknown escape character {ch!r}")
            else:
                return chunks

    def quoted_spaces(self) -> list[str]:
        chunks: list[str] = []
        begin = self.i
        while self.peek() in " \t":
            self.i += 1
        whitespaces = self.s[begin:self.i]
        ch = self.peek()
        if ch == "\0":
            self.fail("unexpected end of stream in a quoted scalar")
        elif ch == "\n":
            self.i += 1
            breaks = self.quoted_breaks()
            if not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        else:
            chunks.append(whitespaces)
        return chunks

    def quoted_breaks(self) -> list[str]:
        chunks: list[str] = []
        while True:
            if self.at_doc_marker():
                self.fail("a document separator inside a quoted scalar")
            while self.peek() in " \t":
                self.i += 1
            if self.peek() == "\n":
                self.i += 1
                chunks.append("\n")
            else:
                return chunks

    def block_scalar(self, indent: int) -> str:
        """PyYAML's scan_block_scalar: ``indent`` is the enclosing block
        collection's column."""
        folded = self.peek() == ">"
        self.i += 1
        chomping = increment = None
        ch = self.peek()
        if ch in "+-":
            chomping = ch == "+"
            self.i += 1
            if self.peek() in "0123456789":
                increment = int(self.peek())
                self.i += 1
        elif ch in "0123456789":
            increment = int(ch)
            self.i += 1
            if self.peek() in "+-":
                chomping = self.peek() == "+"
                self.i += 1
        if increment == 0:
            self.fail("a block scalar's indentation indicator must be 1-9")
        if self.peek() not in "\0 \n":
            self.fail("expected chomping or indentation indicators, found "
                      f"{self.peek()!r}")
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in "\0\n":
                self.i += 1
        if self.peek() not in "\0\n":
            self.fail("expected a comment or a line break after a block "
                      "scalar's header")
        if self.peek() == "\n":
            self.i += 1
        min_indent = max(1, indent + 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " \n":
                if self.peek() == "\n":
                    breaks.append("\n")
                    self.i += 1
                else:
                    self.i += 1
                    max_indent = max(max_indent, self.column)
            block_indent = max(min_indent, max_indent)
        else:
            block_indent = min_indent + increment - 1
            breaks = self.block_breaks(block_indent)
        chunks: list[str] = []
        line_break = ""
        while self.column == block_indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            end = self.s.find("\n", self.i)
            end = len(self.s) if end < 0 else end
            chunks.append(self.s[self.i:end])
            self.i = end
            line_break = ""
            if self.peek() == "\n":
                line_break = "\n"
                self.i += 1
            breaks = self.block_breaks(block_indent)
            if self.column == block_indent and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def block_breaks(self, indent: int) -> list[str]:
        chunks: list[str] = []
        while self.column < indent and self.peek() == " ":
            self.i += 1
        while self.peek() == "\n":
            chunks.append("\n")
            self.i += 1
            while self.column < indent and self.peek() == " ":
                self.i += 1
        return chunks

    # -- flow collections ------------------------------------------------

    def flow_skip(self) -> None:
        while True:
            while self.peek() in " \n":
                self.i += 1
            if self.peek() == "#":
                while self.peek() not in "\0\n":
                    self.i += 1
            else:
                return

    def flow_node(self, key: bool = False) -> Any:
        """A flow node with its properties; a flow mapping's merge key
        (``key``) comes back as ``_MERGE``."""
        self.flow_skip()
        line = self.line()
        anchor, tag = self.properties()
        if tag is not None and not (key and tag == "!!merge"):
            self.refuse_tag(tag)
        if self.peek() == "*":
            if anchor is not None or tag is not None:
                self.fail("an alias cannot have an anchor or a tag")
            return self.alias()
        value = self.flow_content(line, key)
        self.define(anchor, value)
        return _MERGE if tag is not None else value

    def flow_content(self, line: int, key: bool) -> Any:
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted(ch == '"')
        self.refuse_indicator()
        if not self.can_start_plain():
            if ch in ",]}:":
                return None   # an empty node
            self.fail(f"{ch!r} cannot start a value")
        raw = self.plain(-1)
        if key and raw == "<<":
            return _MERGE
        return resolve_plain(raw, line)

    def flow_collection(self) -> Any:
        opener = self.peek()
        closer = "]" if opener == "[" else "}"
        self.i += 1
        self.flow += 1
        out: list = []
        merges: list = []
        while True:
            self.flow_skip()
            if self.peek() == closer:
                self.i += 1
                break
            if self.peek() == "\0":
                self.fail(f"unclosed flow collection (expected "
                          f"{closer!r})")
            if self.peek() == "?" and self.peek(1) in _WS_END:
                self.fail("complex keys (?) are not supported by the "
                          "port's YAML reader")
            line = self.line()
            key = self.flow_node(key=opener == "{")
            self.flow_skip()
            if self.peek() == ":":
                self.i += 1
                if opener == "[":
                    self.fail("single-pair mappings inside a flow sequence "
                              "are not supported")
                self.flow_skip()
                value = (None if self.peek() in ",}" else self.flow_node())
                self.flow_skip()
            else:
                value = None
            if opener == "[":
                out.append(key)
            elif key is _MERGE:
                merges.extend(self.merge_pairs(value, line))
            else:
                out.append((key, value))
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != closer:
                self.fail(f"expected ',' or {closer!r} in a flow "
                          "collection")
        self.flow -= 1
        return out if opener == "[" else self.build_mapping(merges, out)


# -- the writer -----------------------------------------------------------

# characters a plain scalar may not start with (indicators, space)
_PLAIN_FIRST_BAD = set(" -?:,[]{}#&*!|>'\"%@`")
# characters the literal block scalar does not carry (line breaks YAML
# normalizes, the BOM); a string with one goes double-quoted
_LITERAL_BAD = {"\r", "\x85", "\u2028", "\u2029", "\ufeff"}


def _printable(ch: str) -> bool:
    """Whether PyYAML's reader takes ``ch`` raw (its NON_PRINTABLE set)."""
    o = ord(ch)
    return (ch in "\t\n" or 0x20 <= o <= 0x7e or o == 0x85
            or 0xa0 <= o <= 0xd7ff or 0xe000 <= o <= 0xfffd
            or 0x10000 <= o <= 0x10ffff)


def _plain_ok(s: str) -> bool:
    if not s or s[0] in _PLAIN_FIRST_BAD or s[-1] in " :":
        return False
    if not all(0x20 <= ord(c) <= 0x7e for c in s):
        return False
    if ": " in s or " #" in s or s.startswith(("---", "...")):
        return False
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except ValueError:
        return False


def _double_quoted(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= o <= 0x7e:
            out.append(ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch in _LITERAL_BAD or not _printable(ch) or 0x7f <= o < 0xa0:
            out.append(f"\\x{o:02X}" if o < 0x100 else
                       f"\\u{o:04X}" if o < 0x10000 else f"\\U{o:08X}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _scalar(value: Any) -> str:
    """A one-line scalar: plain when it reads back as itself, else
    double-quoted."""
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)   # PyYAML's float pattern
        return text
    if isinstance(value, str):
        return value if _plain_ok(value) else _double_quoted(value)
    raise TypeError(f"cannot dump {type(value).__name__} as YAML")


def _literal(s: str) -> Optional[list[str]]:
    """A multi-line string as a literal block scalar: its header and its
    lines (content written two columns past the parent's), or None when
    it should go double-quoted."""
    if "\n" not in s or any(c in _LITERAL_BAD or not _printable(c)
                            for c in s):
        return None
    body = s.rstrip("\n")
    trailing = len(s) - len(body)
    if not body.strip(" \t\n"):
        return None
    chomp = {0: "-", 1: ""}.get(trailing, "+")
    # an explicit indentation when the first line would mislead the
    # detection (it starts with a space, or is empty)
    indicator = "2" if body[0] in " \n\t" else ""
    lines = body.split("\n") + [""] * max(trailing - 1, 0)
    return ["|" + indicator + chomp] + lines


def _value_lines(head: str, value: Any, indent: int,
                 sort_keys: bool) -> list[str]:
    """``head`` (a key and ':', or '-', at column ``indent``) followed by
    ``value``."""
    pad = " " * (indent + 2)
    if isinstance(value, (dict, list, tuple)) and value:
        sub = _block(value, indent + 2, sort_keys)
        if head.endswith("-"):
            # a compact entry: the collection starts on the dash's line
            return [head + " " + sub[0][indent + 2:]] + sub[1:]
        return [head] + sub
    if isinstance(value, dict):
        return [head + " {}"]
    if isinstance(value, (list, tuple)):
        return [head + " []"]
    if isinstance(value, str):
        lit = _literal(value)
        if lit is not None:
            return [head + " " + lit[0]] + [pad + ln if ln else ""
                                            for ln in lit[1:]]
    return [head + " " + _scalar(value)]


def _block(obj: Any, indent: int, sort_keys: bool) -> list[str]:
    """The lines of a non-empty mapping or sequence whose entries start
    at column ``indent``."""
    pad = " " * indent
    out: list[str] = []
    if isinstance(obj, dict):
        items = sorted(obj.items()) if sort_keys else obj.items()
        for k, v in items:
            if isinstance(k, (dict, list, tuple)):
                raise TypeError("cannot dump a collection as a mapping key")
            out.extend(_value_lines(pad + _scalar(k) + ":", v, indent,
                                    sort_keys))
    else:
        for v in obj:
            out.extend(_value_lines(pad + "-", v, indent, sort_keys))
    return out


def safe_dump(obj: Any, sort_keys: bool = False) -> str:
    """``obj`` as block YAML that this module's ``safe_load`` and PyYAML's
    read back to ``obj``: mappings (with scalar keys), sequences, strings
    (multi-line ones as literal block scalars, strings that would read as
    another type quoted), ints, floats, booleans and None. The text is
    not PyYAML's byte for byte."""
    if isinstance(obj, (dict, list, tuple)) and obj:
        return "\n".join(_block(obj, 0, sort_keys)) + "\n"
    lines = _value_lines("", obj, 0, sort_keys)
    return "\n".join([lines[0].lstrip(" ")] + lines[1:]) + "\n"
