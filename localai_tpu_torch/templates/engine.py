"""A template engine for the subset of Jinja that prompt templates use.

The machine with the card has no Jinja2, so the port renders its prompt
templates with this module: a lexer, a parser that builds a tree once per
template, and a renderer that walks the tree. No template text is ever
passed to ``eval``, ``exec`` or ``compile``. Two sources of templates
meet here: Go templates after ``templates.gotmpl.go_template_to_jinja``,
and the Jinja chat templates that checkpoints ship in
``tokenizer_config.json``.

The semantics are those of the JAX package's ``gotmpl.make_environment``
(Jinja2 with ``ChainableUndefined``, ``keep_trailing_newline=True``, no
``trim_blocks``, no ``lstrip_blocks``, and its ``toJson``/``tojson``,
``trim``, ``title`` and ``default`` filters):

  * a missing name or attribute renders ``""``, is falsy, iterates as
    empty and chains (``a.b.c``); calling it, doing arithmetic or an
    ordering comparison with it raises :class:`UndefinedError` — so does
    ``raise_exception(...)``, which is not defined;
  * whitespace control: ``{%-``, ``-%}``, ``{{-``, ``-}}``, ``{#-``,
    ``-#}`` strip all whitespace, newlines included, on their side;
  * tags: ``if``/``elif``/``else``, ``for … in … [if …]`` with ``else``
    and ``loop`` (index, index0, revindex, revindex0, first, last, length,
    previtem, nextitem, cycle), ``set`` (names, tuples, ``ns.attr`` on a
    ``namespace()``, and the block form ``{% set x %}…{% endset %}``),
    ``raw`` and comments. A ``for`` body is a scope of its own each
    iteration, as in Jinja: a ``set`` inside it does not leak out;
  * expressions: literals, ``+ - * / // % ** ~``, comparisons (chained),
    ``in``/``not in``, ``and``/``or``/``not``, ``x if c else y``, tests
    (``is [not] name``), filters, subscripts and slices, attribute lookup
    (attribute first, then item, for ``.``; item first, then attribute,
    for ``[]``), and calls of methods of strings, lists and dicts.

An unknown tag, filter or test fails when the template is parsed
(:class:`TemplateSyntaxError`), as in Jinja2; a wrong call fails when it
renders. Attributes whose name starts with ``_``, and ``str.format``,
are not reachable from a template.
"""

from __future__ import annotations

import json
import re
from collections.abc import Mapping
from typing import Any, Callable, Iterable, Optional


class TemplateError(Exception):
    """Any failure of a template, at parse or at render."""


class TemplateSyntaxError(TemplateError):
    def __init__(self, message: str, lineno: int = 0):
        super().__init__(f"line {lineno}: {message}" if lineno else message)
        self.lineno = lineno


class UndefinedError(TemplateError):
    """An undefined value was called, computed with or compared."""


class TemplateRuntimeError(TemplateError):
    pass


# -- undefined -----------------------------------------------------------


class Undefined:
    """Jinja2's ChainableUndefined: renders empty, is falsy, iterates as
    empty, and its attributes and items are itself."""

    __slots__ = ("_undefined_name",)

    def __init__(self, name: Any = None):
        self._undefined_name = name

    def _fail(self, *args, **kwargs):
        name = self._undefined_name
        raise UndefinedError(f"{name!r} is undefined" if name is not None
                             else "value is undefined")

    __add__ = __radd__ = __sub__ = __rsub__ = _fail
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _fail
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pow__ = __rpow__ = __pos__ = __neg__ = __call__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail
    __int__ = __float__ = __complex__ = _fail

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return self

    def __getitem__(self, key):
        return self

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __repr__(self) -> str:
        return "Undefined"


class Namespace:
    """``namespace(...)``: the one object a template may set attributes
    on."""

    def __init__(self, *args, **kwargs):
        for a in args:
            self.__dict__.update(dict(a))
        self.__dict__.update(kwargs)

    def __repr__(self) -> str:
        return f"<Namespace {self.__dict__!r}>"


class LoopContext:
    """The ``loop`` variable of a ``for`` body."""

    def __init__(self, items: list, index0: int):
        self._items = items
        self.index0 = index0

    @property
    def length(self) -> int:
        return len(self._items)

    @property
    def index(self) -> int:
        return self.index0 + 1

    @property
    def revindex(self) -> int:
        return len(self._items) - self.index0

    @property
    def revindex0(self) -> int:
        return len(self._items) - self.index0 - 1

    @property
    def first(self) -> bool:
        return self.index0 == 0

    @property
    def last(self) -> bool:
        return self.index0 == len(self._items) - 1

    @property
    def previtem(self):
        return (self._items[self.index0 - 1] if self.index0 > 0
                else Undefined("previtem"))

    @property
    def nextitem(self):
        return (self._items[self.index0 + 1]
                if self.index0 + 1 < len(self._items)
                else Undefined("nextitem"))

    def cycle(self, *args):
        if not args:
            raise TypeError("no items for cycling given")
        return args[self.index0 % len(args)]

    def __repr__(self) -> str:
        return f"<LoopContext {self.index}/{self.length}>"


# -- lookups (Jinja2's Environment.getattr / getitem) --------------------

_BLOCKED_ATTRS = {"format", "format_map", "mro"}


def _safe_attr(obj: Any, name: str) -> Any:
    if name.startswith("_") or (name in _BLOCKED_ATTRS
                                and not isinstance(obj, Mapping)):
        raise AttributeError(name)
    return getattr(obj, name)


def getattr_(obj: Any, name: str) -> Any:
    """``obj.name``: the attribute, else the item, else undefined."""
    if isinstance(obj, Undefined):
        return obj
    try:
        return _safe_attr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(name)


def getitem(obj: Any, key: Any) -> Any:
    """``obj[key]``: the item, else (for a string key) the attribute,
    else undefined."""
    if isinstance(obj, Undefined):
        return obj
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return _safe_attr(obj, key)
            except AttributeError:
                pass
        return Undefined(key)


def to_str(value: Any) -> str:
    return value if isinstance(value, str) else str(value)


# -- filters --------------------------------------------------------------


def _attr_getter(attribute: Any, default: Any = None) -> Callable:
    parts = (attribute.split(".") if isinstance(attribute, str)
             else [attribute])
    parts = [int(p) if isinstance(p, str) and p.isdigit() else p
             for p in parts]

    def get(item):
        for p in parts:
            item = getitem(item, p)
        if default is not None and isinstance(item, Undefined):
            item = default
        return item
    return get


def f_length(value) -> int:
    return len(value)


def f_first(value):
    for x in value:
        return x
    return Undefined("first")


def f_last(value):
    try:
        return next(iter(reversed(value)))
    except StopIteration:
        return Undefined("last")


def f_join(value, d: str = "", attribute=None) -> str:
    if attribute is not None:
        value = map(_attr_getter(attribute), value)
    return to_str(d).join(to_str(x) for x in value)


def f_replace(s, old, new, count=None) -> str:
    return to_str(s).replace(to_str(old), to_str(new),
                             -1 if count is None else count)


def f_int(value, default=0, base=10) -> int:
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError):
            return default


def f_float(value, default=0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def f_items(value):
    if isinstance(value, Undefined):
        return iter(())
    if not isinstance(value, Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    return iter(value.items())


def f_jinja_default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def f_reverse(value):
    if isinstance(value, str):
        return value[::-1]
    try:
        return reversed(value)
    except TypeError:
        out = list(value)
        out.reverse()
        return iter(out)


def _sort_key(case_sensitive: bool, attribute=None):
    get = _attr_getter(attribute) if attribute is not None else None

    def key(x):
        if get is not None:
            x = get(x)
        if not case_sensitive and isinstance(x, str):
            return x.lower()
        return x
    return key


def f_sort(value, reverse=False, case_sensitive=False, attribute=None):
    return sorted(value, key=_sort_key(case_sensitive, attribute),
                  reverse=reverse)


def f_unique(value, case_sensitive=False, attribute=None):
    key = _sort_key(case_sensitive, attribute)
    seen = set()
    for item in value:
        k = key(item)
        if k not in seen:
            seen.add(k)
            yield item


def f_sum(iterable, attribute=None, start=0):
    if attribute is not None:
        iterable = map(_attr_getter(attribute), iterable)
    return sum(iterable, start)


def f_dictsort(value, case_sensitive=False, by="key", reverse=False):
    pos = 0 if by == "key" else 1

    def key(item):
        x = item[pos]
        return x.lower() if not case_sensitive and isinstance(x, str) else x
    return sorted(value.items(), key=key, reverse=reverse)


def f_indent(s, width=4, first=False, blank=False):
    indention = width if isinstance(width, str) else " " * width
    newline = "\n"
    s = to_str(s) + newline  # Jinja2's quirk: splitlines drops one
    if blank:
        rv = (newline + indention).join(s.splitlines())
    else:
        lines = s.splitlines()
        rv = lines.pop(0)
        if lines:
            rv += newline + newline.join(
                indention + line if line else line for line in lines)
    if first:
        rv = indention + rv
    return rv


def f_format(value, *args, **kwargs) -> str:
    if args and kwargs:
        raise TemplateRuntimeError("can't handle positional and keyword "
                                   "arguments at the same time")
    return to_str(value) % (kwargs or args)


def _tojson(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def _select(env, value, args, kwargs, *, attr: bool, want: bool):
    args = list(args)
    if attr:
        if not args:
            raise TemplateRuntimeError("missing parameter for attribute "
                                       "name")
        get = _attr_getter(args.pop(0))
    else:
        def get(x):
            return x
    if args:
        name = args.pop(0)
        test = env.tests.get(name)
        if test is None:
            raise TemplateRuntimeError(f"No test named {name!r}.")

        def check(x):
            return bool(test(x, *args, **kwargs))
    else:
        def check(x):
            return bool(x)
    return (item for item in value if check(get(item)) == want)


def _map(env, value, args, kwargs):
    args = list(args)
    if "attribute" in kwargs:
        kwargs = dict(kwargs)
        get = _attr_getter(kwargs.pop("attribute"), kwargs.pop("default",
                                                              None))
        if kwargs:
            raise TemplateRuntimeError(
                f"Unexpected keyword argument {next(iter(kwargs))!r}")
        return (get(item) for item in value)
    if not args:
        return iter(value)
    name = args.pop(0)
    func = env.filters.get(name)
    if func is None:
        raise TemplateRuntimeError(f"No filter named {name!r}.")
    return (env.call_filter(name, func, item, args, kwargs)
            for item in value)


# filters that take the environment first (they look up filters or tests)
_ENV_FILTERS = {
    "selectattr": lambda env, v, *a, **k: _select(env, v, a, k, attr=True,
                                                  want=True),
    "rejectattr": lambda env, v, *a, **k: _select(env, v, a, k, attr=True,
                                                  want=False),
    "select": lambda env, v, *a, **k: _select(env, v, a, k, attr=False,
                                              want=True),
    "reject": lambda env, v, *a, **k: _select(env, v, a, k, attr=False,
                                              want=False),
    "map": lambda env, v, *a, **k: _map(env, v, a, k),
}

DEFAULT_FILTERS: dict[str, Callable] = {
    "length": f_length, "count": f_length,
    "first": f_first, "last": f_last, "join": f_join,
    "upper": lambda s: to_str(s).upper(),
    "lower": lambda s: to_str(s).lower(),
    "capitalize": lambda s: to_str(s).capitalize(),
    "title": lambda s: to_str(s).title(),
    "trim": lambda s, chars=None: to_str(s).strip(chars),
    "replace": f_replace, "list": lambda v: list(v),
    "string": to_str, "int": f_int, "float": f_float,
    "items": f_items, "default": f_jinja_default, "d": f_jinja_default,
    "abs": abs, "reverse": f_reverse, "sort": f_sort, "unique": f_unique,
    "sum": f_sum, "dictsort": f_dictsort, "indent": f_indent,
    "format": f_format, "safe": lambda v: v,
    "tojson": _tojson, **_ENV_FILTERS,
}


# -- tests ----------------------------------------------------------------


def _is_number(v) -> bool:
    import numbers
    return isinstance(v, numbers.Number)


def _is_iterable(v) -> bool:
    try:
        iter(v)
    except TypeError:
        return False
    return True


def _is_sequence(v) -> bool:
    try:
        len(v)
        v.__getitem__
    except Exception:  # noqa: BLE001 — Jinja2's test_sequence
        return False
    return True


DEFAULT_TESTS: dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True, "false": lambda v: v is False,
    "integer": lambda v: isinstance(v, int) and v is not True
    and v is not False,
    "float": lambda v: isinstance(v, float),
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, Mapping),
    "number": _is_number, "iterable": _is_iterable,
    "sequence": _is_sequence,
    "sameas": lambda v, other: v is other,
    "even": lambda v: v % 2 == 0, "odd": lambda v: v % 2 == 1,
    "divisibleby": lambda v, n: v % n == 0,
    "in": lambda v, seq: v in seq,
    "eq": lambda a, b: a == b, "equalto": lambda a, b: a == b,
    "==": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "!=": lambda a, b: a != b, "lt": lambda a, b: a < b,
    "lessthan": lambda a, b: a < b, "<": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "<=": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "greaterthan": lambda a, b: a > b,
    ">": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    ">=": lambda a, b: a >= b,
}


def _range(*args):
    r = range(*args)
    if len(r) > 100000:
        raise TemplateRuntimeError("range too big (more than 100000 items)")
    return r


DEFAULT_GLOBALS: dict[str, Any] = {
    "range": _range, "namespace": Namespace, "dict": lambda **kw: kw,
}


# -- lexer ----------------------------------------------------------------

_OPEN = re.compile(r"\{\{|\{%|\{#")
_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'"
                     r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?[eE][+\-]?(\d+_)*\d+"
                    r"|\.(\d+_)*\d+)")
_INTEGER = re.compile(r"(0[bB](_?[01])+|0[oO](_?[0-7])+|0[xX](_?[\da-fA-F])+"
                      r"|[1-9](_?\d)*|0(_?0)*)")
_OPERATORS = sorted(["+", "-", "/", "//", "*", "%", "**", "~", "[", "]",
                     "(", ")", "{", "}", "==", "!=", ">", ">=", "<", "<=",
                     "=", ".", ":", "|", ",", ";"], key=len, reverse=True)
_RAW = re.compile(r"\{%([-+]?)\s*raw\s*(-?)%\}")
_ENDRAW = re.compile(r"\{%([-+]?)\s*endraw\s*(-?)%\}")
_NEWLINES = re.compile(r"\r\n|\r|\n")


class Token:
    __slots__ = ("type", "value", "lineno")

    def __init__(self, type_: str, value: Any, lineno: int):
        self.type = type_
        self.value = value
        self.lineno = lineno

    def __repr__(self) -> str:
        return f"Token({self.type!r}, {self.value!r})"


def _decode_string(raw: str) -> str:
    body = _NEWLINES.sub("\n", raw[1:-1])
    return body.encode("ascii", "backslashreplace").decode("unicode-escape")


def tokenize(src: str) -> list[tuple]:
    """Template text → [("data", text, line) | ("var"|"block", [Token],
    line)], whitespace control applied."""
    out: list[tuple] = []
    pos = 0
    lstrip_next = False
    n = len(src)

    def line_at(p: int) -> int:
        return src.count("\n", 0, p) + 1

    def data(text: str, strip_right: bool, at: int) -> None:
        nonlocal lstrip_next
        if lstrip_next:
            text = text.lstrip()
            lstrip_next = False
        if strip_right:
            text = text.rstrip()
        if text:
            out.append(("data", _NEWLINES.sub("\n", text), line_at(at)))

    while pos < n:
        m = _OPEN.search(src, pos)
        if m is None:
            data(src[pos:], False, pos)
            break
        start = m.start()
        kind = m.group()
        if kind == "{%":
            raw = _RAW.match(src, start)
            if raw is not None:
                data(src[pos:start], raw.group(1) == "-", pos)
                end = _ENDRAW.search(src, raw.end())
                if end is None:
                    raise TemplateSyntaxError("missing end of raw directive",
                                              line_at(start))
                body = src[raw.end():end.start()]
                if raw.group(2):
                    body = body.lstrip()
                if end.group(1) == "-":
                    body = body.rstrip()
                if body:
                    out.append(("data", _NEWLINES.sub("\n", body),
                                line_at(raw.end())))
                lstrip_next = bool(end.group(2))
                pos = end.end()
                continue
        j = m.end()
        strip_left = j < n and src[j] == "-"
        if j < n and (src[j] == "-" or (src[j] == "+" and kind != "{{")):
            j += 1
        data(src[pos:start], strip_left, pos)
        lineno = line_at(start)
        if kind == "{#":
            end = src.find("#}", j)
            if end < 0:
                raise TemplateSyntaxError("missing end of comment tag",
                                          lineno)
            lstrip_next = end > j and src[end - 1] == "-"
            pos = end + 2
            continue
        closer = "}}" if kind == "{{" else "%}"
        toks, pos, strip_after = _lex_tag(src, j, closer, lineno)
        lstrip_next = strip_after
        out.append(("var" if kind == "{{" else "block", toks, lineno))
    return out


def _lex_tag(src: str, pos: int, closer: str, lineno: int
             ) -> tuple[list[Token], int, bool]:
    toks: list[Token] = []
    depth: list[str] = []
    n = len(src)
    while True:
        while pos < n and src[pos].isspace():
            if src[pos] == "\n":
                lineno += 1
            pos += 1
        if pos >= n:
            raise TemplateSyntaxError(f"unexpected end of template, expected "
                                      f"{closer!r}", lineno)
        if not depth:
            if src.startswith("-" + closer, pos):
                return toks, pos + 3, True
            if src.startswith(closer, pos):
                return toks, pos + 2, False
        m = _STRING.match(src, pos)
        if m:
            toks.append(Token("string", _decode_string(m.group()), lineno))
            lineno += m.group().count("\n")
            pos = m.end()
            continue
        m = _FLOAT.match(src, pos)
        if m:
            toks.append(Token("float", float(m.group().replace("_", "")),
                              lineno))
            pos = m.end()
            continue
        m = _INTEGER.match(src, pos)
        if m:
            toks.append(Token("integer", int(m.group().replace("_", ""), 0),
                              lineno))
            pos = m.end()
            continue
        m = _NAME.match(src, pos)
        if m:
            toks.append(Token("name", m.group(), lineno))
            pos = m.end()
            continue
        for op in _OPERATORS:
            if src.startswith(op, pos):
                break
        else:
            raise TemplateSyntaxError(f"unexpected char {src[pos]!r}",
                                      lineno)
        if op in "([{":
            depth.append({"(": ")", "[": "]", "{": "}"}[op])
        elif op in ")]}":
            if not depth or depth.pop() != op:
                raise TemplateSyntaxError(f"unexpected {op!r}", lineno)
        toks.append(Token("op", op, lineno))
        pos += len(op)


# -- nodes ----------------------------------------------------------------
# Expression nodes have ``ev(ctx)``; statement nodes ``run(ctx, out)``.


class Const:
    def __init__(self, value):
        self.value = value

    def ev(self, ctx):
        return self.value


class Name:
    def __init__(self, name: str):
        self.name = name

    def ev(self, ctx):
        return ctx.lookup(self.name)


class ListExpr:
    def __init__(self, items):
        self.items = items

    def ev(self, ctx):
        return [i.ev(ctx) for i in self.items]


class TupleExpr(ListExpr):
    def ev(self, ctx):
        return tuple(i.ev(ctx) for i in self.items)


class DictExpr:
    def __init__(self, pairs):
        self.pairs = pairs

    def ev(self, ctx):
        return {k.ev(ctx): v.ev(ctx) for k, v in self.pairs}


class GetAttr:
    def __init__(self, node, attr: str):
        self.node = node
        self.attr = attr

    def ev(self, ctx):
        return getattr_(self.node.ev(ctx), self.attr)


class GetItem:
    def __init__(self, node, key):
        self.node = node
        self.key = key

    def ev(self, ctx):
        return getitem(self.node.ev(ctx), self.key.ev(ctx))


class SliceExpr:
    def __init__(self, start, stop, step):
        self.start, self.stop, self.step = start, stop, step

    def ev(self, ctx):
        return slice(*(None if p is None else p.ev(ctx)
                       for p in (self.start, self.stop, self.step)))


def _call_args(ctx, args, kwargs):
    return ([a.ev(ctx) for a in args],
            {k: v.ev(ctx) for k, v in kwargs.items()})


class Call:
    def __init__(self, node, args, kwargs):
        self.node, self.args, self.kwargs = node, args, kwargs

    def ev(self, ctx):
        fn = self.node.ev(ctx)
        args, kwargs = _call_args(ctx, self.args, self.kwargs)
        if isinstance(fn, Undefined):
            fn._fail()
        if not callable(fn):
            raise TypeError(f"{type(fn).__name__!r} object is not callable")
        return fn(*args, **kwargs)


class Filter:
    def __init__(self, node, name, func, args, kwargs):
        self.node, self.name, self.func = node, name, func
        self.args, self.kwargs = args, kwargs

    def ev(self, ctx):
        value = self.node.ev(ctx)
        args, kwargs = _call_args(ctx, self.args, self.kwargs)
        return ctx.env.call_filter(self.name, self.func, value, args, kwargs)


class Test:
    def __init__(self, node, name, func, args, negate):
        self.node, self.name, self.func = node, name, func
        self.args, self.negate = args, negate

    def ev(self, ctx):
        value = self.node.ev(ctx)
        args = [a.ev(ctx) for a in self.args]
        out = bool(self.func(value, *args))
        return not out if self.negate else out


def _concat(a, b):
    return to_str(a) + to_str(b)


_BINOPS: dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b, "~": _concat,
}
_CMPOPS: dict[str, Callable] = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}


class BinOp:
    def __init__(self, op, left, right):
        self.fn, self.left, self.right = _BINOPS[op], left, right

    def ev(self, ctx):
        return self.fn(self.left.ev(ctx), self.right.ev(ctx))


class Compare:
    def __init__(self, first, ops):
        self.first, self.ops = first, ops

    def ev(self, ctx):
        left = self.first.ev(ctx)
        for op, node in self.ops:
            right = node.ev(ctx)
            if not _CMPOPS[op](left, right):
                return False
            left = right
        return True


class Neg:
    def __init__(self, node):
        self.node = node

    def ev(self, ctx):
        return -self.node.ev(ctx)


class Pos(Neg):
    def ev(self, ctx):
        return +self.node.ev(ctx)


class Not(Neg):
    def ev(self, ctx):
        return not self.node.ev(ctx)


class And:
    def __init__(self, left, right):
        self.left, self.right = left, right

    def ev(self, ctx):
        return self.left.ev(ctx) and self.right.ev(ctx)


class Or(And):
    def ev(self, ctx):
        return self.left.ev(ctx) or self.right.ev(ctx)


class CondExpr:
    def __init__(self, test, then, else_):
        self.test, self.then, self.else_ = test, then, else_

    def ev(self, ctx):
        if self.test.ev(ctx):
            return self.then.ev(ctx)
        return (self.else_.ev(ctx) if self.else_ is not None
                else Undefined())


class Output:
    def __init__(self, text: str):
        self.text = text

    def run(self, ctx, out):
        out.append(self.text)


class Emit:
    def __init__(self, node):
        self.node = node

    def run(self, ctx, out):
        v = self.node.ev(ctx)
        out.append(v if isinstance(v, str) else str(v))


def _run_body(body, ctx, out):
    for node in body:
        node.run(ctx, out)


class If:
    def __init__(self, branches, else_body):
        self.branches, self.else_body = branches, else_body

    def run(self, ctx, out):
        for test, body in self.branches:
            if test.ev(ctx):
                _run_body(body, ctx, out)
                return
        _run_body(self.else_body, ctx, out)


def _assign(ctx, target, value):
    """Bind a target (a name, a tuple of targets, or ``ns.attr``)."""
    kind = target[0]
    if kind == "name":
        ctx.vars[target[1]] = value
    elif kind == "tuple":
        values = list(value)
        if len(values) != len(target[1]):
            raise ValueError(f"expected {len(target[1])} values to unpack, "
                             f"got {len(values)}")
        for t, v in zip(target[1], values):
            _assign(ctx, t, v)
    else:  # ("nsattr", name, attr)
        obj = ctx.lookup(target[1])
        if not isinstance(obj, Namespace):
            raise TemplateRuntimeError("cannot assign attribute on "
                                       "non-namespace object")
        setattr(obj, target[2], value)


class For:
    def __init__(self, target, iterable, cond, body, else_body):
        self.target, self.iterable, self.cond = target, iterable, cond
        self.body, self.else_body = body, else_body

    def run(self, ctx, out):
        seq = self.iterable.ev(ctx)
        items = list(seq)
        if self.cond is not None:
            kept = []
            for item in items:
                scope = ctx.child()
                _assign(scope, self.target, item)
                if self.cond.ev(scope):
                    kept.append(item)
            items = kept
        for i, item in enumerate(items):
            scope = ctx.child()
            _assign(scope, self.target, item)
            scope.vars["loop"] = LoopContext(items, i)
            _run_body(self.body, scope, out)
        if not items:
            _run_body(self.else_body, ctx, out)


class Assign:
    def __init__(self, target, node):
        self.target, self.node = target, node

    def run(self, ctx, out):
        _assign(ctx, self.target, self.node.ev(ctx))


class AssignBlock:
    def __init__(self, target, body):
        self.target, self.body = target, body

    def run(self, ctx, out):
        buf: list[str] = []
        _run_body(self.body, ctx, buf)
        _assign(ctx, self.target, "".join(buf))


# -- parser ---------------------------------------------------------------


class _TokenStream:
    def __init__(self, toks: list[Token], lineno: int):
        self.toks = toks
        self.i = 0
        self.lineno = lineno

    @property
    def current(self) -> Optional[Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def look(self, k: int = 1) -> Optional[Token]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def fail(self, msg: str):
        tok = self.current
        raise TemplateSyntaxError(msg, tok.lineno if tok else self.lineno)

    def next(self) -> Token:
        tok = self.current
        if tok is None:
            self.fail("unexpected end of expression")
        self.i += 1
        return tok

    def is_op(self, *ops: str) -> bool:
        t = self.current
        return t is not None and t.type == "op" and t.value in ops

    def is_name(self, *names: str) -> bool:
        t = self.current
        return t is not None and t.type == "name" and t.value in names

    def skip_op(self, op: str) -> bool:
        if self.is_op(op):
            self.i += 1
            return True
        return False

    def skip_name(self, name: str) -> bool:
        if self.is_name(name):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.skip_op(op):
            tok = self.current
            self.fail(f"expected {op!r}, got "
                      f"{tok.value if tok else 'end of expression'!r}")

    def expect_name(self) -> str:
        tok = self.current
        if tok is None or tok.type != "name":
            self.fail("expected a name")
        self.i += 1
        return tok.value

    def at_end(self) -> bool:
        return self.i >= len(self.toks)


_COMPARE_OPS = ("==", "!=", "<", "<=", ">", ">=")
_PRIMARY_START = ("name", "string", "integer", "float")


class _ExprParser:
    """Jinja2's expression grammar (jinja2/parser.py), operator by
    operator."""

    def __init__(self, env: "Environment", ts: _TokenStream):
        self.env = env
        self.ts = ts

    def expression(self, with_condexpr: bool = True):
        return self.condexpr() if with_condexpr else self.or_()

    def condexpr(self):
        ts = self.ts
        expr = self.or_()
        while ts.skip_name("if"):
            test = self.or_()
            else_ = self.condexpr() if ts.skip_name("else") else None
            expr = CondExpr(test, expr, else_)
        return expr

    def or_(self):
        left = self.and_()
        while self.ts.skip_name("or"):
            left = Or(left, self.and_())
        return left

    def and_(self):
        left = self.not_()
        while self.ts.skip_name("and"):
            left = And(left, self.not_())
        return left

    def not_(self):
        if self.ts.skip_name("not"):
            return Not(self.not_())
        return self.compare()

    def compare(self):
        ts = self.ts
        first = self.math1()
        ops = []
        while True:
            tok = ts.current
            if tok is not None and tok.type == "op" and \
                    tok.value in _COMPARE_OPS:
                ts.next()
                ops.append((tok.value, self.math1()))
            elif ts.skip_name("in"):
                ops.append(("in", self.math1()))
            elif ts.is_name("not") and (ts.look() is not None
                                        and ts.look().type == "name"
                                        and ts.look().value == "in"):
                ts.i += 2
                ops.append(("notin", self.math1()))
            else:
                break
        return Compare(first, ops) if ops else first

    def math1(self):
        left = self.concat()
        while self.ts.is_op("+", "-"):
            op = self.ts.next().value
            left = BinOp(op, left, self.concat())
        return left

    def concat(self):
        args = [self.math2()]
        while self.ts.skip_op("~"):
            args.append(self.math2())
        node = args[0]
        for a in args[1:]:
            node = BinOp("~", node, a)
        return node

    def math2(self):
        left = self.pow_()
        while self.ts.is_op("*", "/", "//", "%"):
            op = self.ts.next().value
            left = BinOp(op, left, self.pow_())
        return left

    def pow_(self):
        left = self.unary()
        while self.ts.skip_op("**"):
            left = BinOp("**", left, self.unary())
        return left

    def unary(self, with_filter: bool = True):
        ts = self.ts
        if ts.skip_op("-"):
            node = Neg(self.unary(False))
        elif ts.skip_op("+"):
            node = Pos(self.unary(False))
        else:
            node = self.primary()
        node = self.postfix(node)
        if with_filter:
            node = self.filter_expr(node)
        return node

    def primary(self):
        ts = self.ts
        tok = ts.current
        if tok is None:
            ts.fail("unexpected end of expression")
        if tok.type == "name":
            ts.next()
            if tok.value in ("true", "True"):
                return Const(True)
            if tok.value in ("false", "False"):
                return Const(False)
            if tok.value in ("none", "None"):
                return Const(None)
            return Name(tok.value)
        if tok.type == "string":
            ts.next()
            parts = [tok.value]
            while ts.current is not None and ts.current.type == "string":
                parts.append(ts.next().value)
            return Const("".join(parts))
        if tok.type in ("integer", "float"):
            ts.next()
            return Const(tok.value)
        if ts.skip_op("("):
            node = self.tuple_(explicit_parentheses=True)
            ts.expect_op(")")
            return node
        if ts.is_op("["):
            return self.list_()
        if ts.is_op("{"):
            return self.dict_()
        ts.fail(f"unexpected {tok.value!r}")

    def tuple_(self, *, simplified: bool = False, with_condexpr: bool = True,
               extra_end: tuple = (), explicit_parentheses: bool = False):
        ts = self.ts
        if simplified:
            def parse():
                return self.primary()
        else:
            def parse():
                return self.expression(with_condexpr)
        args = []
        is_tuple = False
        while True:
            if args:
                ts.expect_op(",")
            if self._tuple_end(extra_end):
                break
            args.append(parse())
            if ts.is_op(","):
                is_tuple = True
            else:
                break
        if not is_tuple:
            if args:
                return args[0]
            if not explicit_parentheses:
                ts.fail("expected an expression")
        return TupleExpr(args)

    def _tuple_end(self, extra_end: tuple) -> bool:
        ts = self.ts
        if ts.at_end() or ts.is_op(")"):
            return True
        return bool(extra_end) and ts.is_name(*extra_end)

    def list_(self):
        ts = self.ts
        ts.expect_op("[")
        items = []
        while not ts.is_op("]"):
            if items:
                ts.expect_op(",")
            if ts.is_op("]"):
                break
            items.append(self.expression())
        ts.expect_op("]")
        return ListExpr(items)

    def dict_(self):
        ts = self.ts
        ts.expect_op("{")
        pairs = []
        while not ts.is_op("}"):
            if pairs:
                ts.expect_op(",")
            if ts.is_op("}"):
                break
            key = self.expression()
            ts.expect_op(":")
            pairs.append((key, self.expression()))
        ts.expect_op("}")
        return DictExpr(pairs)

    def postfix(self, node):
        ts = self.ts
        while True:
            if ts.is_op(".", "["):
                node = self.subscript(node)
            elif ts.is_op("("):
                node = self.call(node)
            else:
                return node

    def filter_expr(self, node):
        ts = self.ts
        while True:
            if ts.is_op("|"):
                node = self.filter_(node)
            elif ts.is_name("is"):
                node = self.test(node)
            elif ts.is_op("("):
                node = self.call(node)
            else:
                return node

    def subscript(self, node):
        ts = self.ts
        tok = ts.next()
        if tok.value == ".":
            attr = ts.next()
            if attr.type == "name":
                return GetAttr(node, attr.value)
            if attr.type == "integer":
                return GetItem(node, Const(attr.value))
            ts.fail("expected a name or number after '.'")
        args = []
        while not ts.is_op("]"):
            if args:
                ts.expect_op(",")
            args.append(self.subscribed())
        ts.expect_op("]")
        key = args[0] if len(args) == 1 else TupleExpr(args)
        return GetItem(node, key)

    def subscribed(self):
        ts = self.ts
        parts: list = []
        if ts.is_op(":"):
            ts.next()
            parts = [None]
        else:
            node = self.expression()
            if not ts.is_op(":"):
                return node
            ts.next()
            parts = [node]
        if ts.is_op(":"):
            parts.append(None)
        elif not ts.is_op("]", ","):
            parts.append(self.expression())
        else:
            parts.append(None)
        if ts.skip_op(":"):
            if not ts.is_op("]", ","):
                parts.append(self.expression())
            else:
                parts.append(None)
        else:
            parts.append(None)
        return SliceExpr(*parts)

    def call_args(self):
        ts = self.ts
        ts.expect_op("(")
        args, kwargs = [], {}
        while not ts.is_op(")"):
            if args or kwargs:
                ts.expect_op(",")
                if ts.is_op(")"):
                    break
            if ts.is_op("*", "**"):
                ts.fail("*args and **kwargs are not supported")
            tok, nxt = ts.current, ts.look()
            if (tok is not None and tok.type == "name" and nxt is not None
                    and nxt.type == "op" and nxt.value == "="):
                ts.i += 2
                kwargs[tok.value] = self.expression()
            else:
                if kwargs:
                    ts.fail("positional argument after keyword argument")
                args.append(self.expression())
        ts.expect_op(")")
        return args, kwargs

    def call(self, node):
        args, kwargs = self.call_args()
        return Call(node, args, kwargs)

    def filter_(self, node, start_inline: bool = False):
        ts = self.ts
        while ts.is_op("|") or start_inline:
            if not start_inline:
                ts.next()
            start_inline = False
            name = ts.expect_name()
            while ts.skip_op("."):
                name += "." + ts.expect_name()
            func = self.env.filters.get(name)
            if func is None:
                ts.fail(f"No filter named {name!r}.")
            args, kwargs = (self.call_args() if ts.is_op("(")
                            else ([], {}))
            node = Filter(node, name, func, args, kwargs)
        return node

    def test(self, node):
        ts = self.ts
        ts.next()  # 'is'
        negate = ts.skip_name("not")
        name = ts.expect_name()
        while ts.skip_op("."):
            name += "." + ts.expect_name()
        func = self.env.tests.get(name)
        if func is None:
            ts.fail(f"No test named {name!r}.")
        args: list = []
        tok = ts.current
        if ts.is_op("("):
            args, kwargs = self.call_args()
            if kwargs:
                ts.fail("keyword arguments to tests are not supported")
        elif tok is not None and (
                tok.type in _PRIMARY_START or (tok.type == "op"
                                               and tok.value in "([{")) \
                and not ts.is_name("else", "or", "and"):
            if ts.is_name("is"):
                ts.fail("You cannot chain multiple tests with is")
            arg = self.postfix(self.primary())
            args = [arg]
        return Test(node, name, func, args, negate)


_END_TAGS = {"endif", "endfor", "endset", "elif", "else", "endraw"}


class _Parser:
    def __init__(self, env: "Environment", items: list[tuple]):
        self.env = env
        self.items = items
        self.i = 0

    def parse(self) -> list:
        body, end = self.subparse(())
        if end is not None:
            raise TemplateSyntaxError(f"unexpected tag {end[0]!r}", end[1])
        return body

    def subparse(self, end_tags: tuple):
        """Nodes up to one of ``end_tags``; returns (body, (tag, line,
        stream)) or (body, None) at the end of the template."""
        body: list = []
        while self.i < len(self.items):
            kind, value, lineno = self.items[self.i]
            self.i += 1
            if kind == "data":
                body.append(Output(value))
                continue
            ts = _TokenStream(value, lineno)
            if kind == "var":
                expr = _ExprParser(self.env, ts).tuple_()
                if not ts.at_end():
                    ts.fail(f"unexpected {ts.current.value!r}")
                body.append(Emit(expr))
                continue
            if ts.at_end():
                raise TemplateSyntaxError("empty tag", lineno)
            tok = ts.current
            if tok.type != "name":
                ts.fail("tag name expected")
            tag = tok.value
            if tag in end_tags:
                ts.next()
                return body, (tag, lineno, ts)
            if tag in _END_TAGS:
                raise TemplateSyntaxError(
                    f"Encountered unknown tag {tag!r}." if not end_tags else
                    f"Encountered unknown tag {tag!r}; expected one of "
                    f"{', '.join(repr(t) for t in end_tags)}.", lineno)
            ts.next()
            if tag == "if":
                body.append(self.parse_if(ts, lineno))
            elif tag == "for":
                body.append(self.parse_for(ts, lineno))
            elif tag == "set":
                body.append(self.parse_set(ts, lineno))
            else:
                raise TemplateSyntaxError(f"Encountered unknown tag {tag!r}.",
                                          lineno)
        if end_tags:
            raise TemplateSyntaxError(
                "Unexpected end of template; expected one of "
                f"{', '.join(repr(t) for t in end_tags)}.",
                self.items[-1][2] if self.items else 0)
        return body, None

    @staticmethod
    def _done(ts: _TokenStream) -> None:
        if not ts.at_end():
            ts.fail(f"expected end of statement block, got "
                    f"{ts.current.value!r}")

    def parse_if(self, ts: _TokenStream, lineno: int):
        branches = []
        test = _ExprParser(self.env, ts).tuple_(with_condexpr=False)
        self._done(ts)
        else_body: list = []
        while True:
            body, end = self.subparse(("elif", "else", "endif"))
            branches.append((test, body))
            tag, _, ets = end
            if tag == "elif":
                test = _ExprParser(self.env, ets).tuple_(with_condexpr=False)
                self._done(ets)
                continue
            if tag == "else":
                self._done(ets)
                else_body, end = self.subparse(("endif",))
                self._done(end[2])
            else:
                self._done(ets)
            return If(branches, else_body)

    def parse_target(self, ts: _TokenStream, *, name_only: bool,
                     extra_end: tuple = ()):
        def one():
            name = ts.expect_name()
            if not name_only and ts.is_op("."):
                ts.next()
                return ("nsattr", name, ts.expect_name())
            return ("name", name)
        targets = [one()]
        is_tuple = False
        while ts.skip_op(","):
            is_tuple = True
            if ts.at_end() or ts.is_name(*extra_end) or ts.is_op("="):
                break
            targets.append(one())
        return ("tuple", targets) if is_tuple else targets[0]

    def parse_for(self, ts: _TokenStream, lineno: int):
        target = self.parse_target(ts, name_only=True, extra_end=("in",))
        if not ts.skip_name("in"):
            ts.fail("expected 'in'")
        ep = _ExprParser(self.env, ts)
        iterable = ep.tuple_(with_condexpr=False, extra_end=("recursive",))
        cond = None
        if ts.skip_name("if"):
            cond = ep.expression()
        if ts.is_name("recursive"):
            ts.fail("recursive loops are not supported")
        self._done(ts)
        body, end = self.subparse(("endfor", "else"))
        else_body: list = []
        if end[0] == "else":
            self._done(end[2])
            else_body, end = self.subparse(("endfor",))
        self._done(end[2])
        return For(target, iterable, cond, body, else_body)

    def parse_set(self, ts: _TokenStream, lineno: int):
        target = self.parse_target(ts, name_only=False)
        if ts.skip_op("="):
            node = _ExprParser(self.env, ts).tuple_()
            self._done(ts)
            return Assign(target, node)
        if ts.is_op("|"):
            ts.fail("filters on a block set are not supported")
        self._done(ts)
        body, end = self.subparse(("endset",))
        self._done(end[2])
        return AssignBlock(target, body)


# -- environment ----------------------------------------------------------


class _Context:
    __slots__ = ("env", "vars", "parent", "root")

    def __init__(self, env, vars_, parent=None, root=None):
        self.env = env
        self.vars = vars_
        self.parent = parent
        self.root = root if root is not None else {}

    def lookup(self, name: str):
        ctx = self
        while ctx is not None:
            if name in ctx.vars:
                return ctx.vars[name]
            ctx = ctx.parent
        if name in self.root:
            return self.root[name]
        if name in self.env.globals:
            return self.env.globals[name]
        return Undefined(name)

    def child(self) -> "_Context":
        return _Context(self.env, {}, self, self.root)


class Template:
    """A parsed template; :meth:`render` walks its tree."""

    def __init__(self, env: "Environment", source: str):
        self.env = env
        self.body = _Parser(env, tokenize(source)).parse()

    def render(self, *args, **kwargs) -> str:
        data = dict(*args, **kwargs)
        out: list[str] = []
        _run_body(self.body, _Context(self.env, {}, None, data), out)
        return "".join(out)


class Environment:
    """Filters, tests and globals a template is parsed against."""

    def __init__(self):
        self.filters: dict[str, Callable] = dict(DEFAULT_FILTERS)
        self.tests: dict[str, Callable] = dict(DEFAULT_TESTS)
        self.globals: dict[str, Any] = dict(DEFAULT_GLOBALS)

    def from_string(self, source: str) -> Template:
        return Template(self, source)

    def call_filter(self, name: str, func: Callable, value: Any,
                    args: Iterable, kwargs: dict) -> Any:
        if name in _ENV_FILTERS and func is _ENV_FILTERS[name]:
            return func(self, value, *args, **kwargs)
        return func(value, *args, **kwargs)
