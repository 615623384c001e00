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
  * comments, a leading ``---`` and a closing ``...``.

Plain scalars resolve as PyYAML's ``SafeLoader`` resolves them (YAML 1.1):
``yes``/``no``/``on``/``off`` are booleans, ``~``, ``null`` and an empty
value are None, and the int and float patterns are PyYAML's own (so
``1e3`` stays a string; ``0x1f``, ``017`` and ``1:30`` are ints). The
scanning rules (folding, block scalar indentation and chomping, the end
of a plain scalar) follow PyYAML's scanner line by line.

Anything else — anchors, aliases, tags, directives, several documents,
complex (``?``) keys, merge keys, timestamps — raises a ``ValueError``
that names the line: the reader never guesses.
"""

from __future__ import annotations

import re
from typing import Any

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
        if ch == "&":
            self.fail("anchors (&) are not supported by the port's YAML "
                      "reader")
        if ch == "*":
            self.fail("aliases (*) are not supported by the port's YAML "
                      "reader")
        if ch == "!":
            self.fail("tags (!) are not supported by the port's YAML "
                      "reader")
        if ch == "?" and self.peek(1) in _WS_END:
            self.fail("complex keys (?) are not supported by the port's "
                      "YAML reader")
        if ch in "%@`":
            self.fail(f"{ch!r} cannot start a value")

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
        if self.peek() in "|>":
            return self.block_scalar(indent)
        self.refuse_indicator()
        start = self.i
        if self.scan_key_candidate():
            self.i = start
            return self.block_mapping(col)
        self.i = start
        value = self.inline_value(indent)
        return value

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
        out: dict = {}
        while True:
            self.refuse_indicator()
            key = self.key_scalar()
            self.skip_spaces()
            if not (self.peek() == ":" and self.peek(1) in _WS_END):
                self.fail("expected ':' after a mapping key")
            self.i += 1
            out[key] = self.mapping_value(col)
            self.skip_to_content()
            if self.peek() == "\0" or self.at_doc_marker() or \
                    self.column < col:
                return out
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

    def key_scalar(self) -> Any:
        line = self.line()
        ch = self.peek()
        if ch in "'\"":
            return self.quoted(ch == '"')
        begin = self.i
        while not (self.peek() == ":" and self.peek(1) in _WS_END):
            self.i += 1
        return resolve_plain(self.s[begin:self.i].rstrip(" \t"), line)

    def mapping_value(self, col: int) -> Any:
        self.skip_spaces()
        if self.peek() in "#\0\n":
            self.skip_to_content()
            if self.peek() == "\0" or self.at_doc_marker():
                return None
            if self.column == col and self.is_entry():
                return self.block_sequence(col)   # at the key's column
            return self.block_node(col)
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

    def flow_node(self) -> Any:
        self.flow_skip()
        ch = self.peek()
        line = self.line()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted(ch == '"')
        self.refuse_indicator()
        if not self.can_start_plain():
            if ch in ",]}:":
                return None   # an empty node
            self.fail(f"{ch!r} cannot start a value")
        return resolve_plain(self.plain(-1), line)

    def flow_collection(self) -> Any:
        opener = self.peek()
        closer = "]" if opener == "[" else "}"
        self.i += 1
        self.flow += 1
        out: Any = [] if opener == "[" else {}
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
            key = self.flow_node()
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
            else:
                try:
                    out[key] = value
                except TypeError:
                    self.fail("complex (collection) keys are not supported")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != closer:
                self.fail(f"expected ',' or {closer!r} in a flow "
                          "collection")
        self.flow -= 1
        return out
