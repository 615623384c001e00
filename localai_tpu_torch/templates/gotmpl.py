"""Go text/template → Jinja conversion, and the environment that renders
both dialects.

Port of ``localai_tpu/templates/gotmpl.py``. The reference ecosystem's
prompt templates (gallery configs, model YAMLs, ``.tmpl`` files) are Go
text/template; they are transpiled to Jinja on load by the JAX package's
functions, copied here unchanged (``go_template_to_jinja``,
``_tok_to_jinja``, ``_split_args``, ``_expr_to_jinja``,
``_head_to_jinja``, ``looks_like_go_template``). Where the JAX package
renders with Jinja2, :func:`make_environment` returns the port's own
engine (``templates.engine``) with the same overrides, so Go templates and
Jinja chat templates share one renderer and its semantics.

Supported subset — everything observed in the reference's gallery/fixtures:
  actions:    {{.Field}}, {{.}}, {{if EXPR}}, {{else if EXPR}}, {{else}},
              {{end}}, {{range .X}}, whitespace trim markers {{- and -}}
  exprs:      eq/ne/gt/ge/lt/le A B, and/or/not, nested field paths,
              string/number literals, bare truthiness
  functions:  toJson, trim, upper, lower, title, default (as filters or
              call-style), pipelines A | f
"""

from __future__ import annotations

import json
import re
from typing import Any

from localai_tpu_torch.templates.engine import Environment

_ACTION = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.DOTALL)
_CMPS = {"eq": "==", "ne": "!=", "gt": ">", "ge": ">=", "lt": "<", "le": "<="}
_FUNCS = {"toJson", "trim", "upper", "lower", "title", "default", "join"}


def _tok_to_jinja(tok: str, in_range: bool) -> str:
    """One expression atom: field path, literal, or keyword."""
    if tok.startswith('"') or tok.startswith("'"):
        return tok
    if re.fullmatch(r"-?\d+(\.\d+)?", tok):
        return tok
    if tok == ".":
        return "_it" if in_range else "_data"
    if tok.startswith("."):
        path = tok[1:]
        return f"_it.{path}" if in_range else path
    if tok.startswith("$."):  # $ = root context
        return tok[2:]
    return tok  # bare identifier (function name, true/false, ...)


def _split_args(expr: str) -> list[str]:
    """Split on whitespace, respecting quoted strings and parens."""
    out, cur, depth, q = [], "", 0, None
    for ch in expr:
        if q:
            cur += ch
            if ch == q:
                q = None
            continue
        if ch in "\"'":
            q = ch
            cur += ch
        elif ch == "(":
            depth += 1
            cur += ch
        elif ch == ")":
            depth -= 1
            cur += ch
        elif ch.isspace() and depth == 0:
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


def _expr_to_jinja(expr: str, in_range: bool) -> str:
    """Convert a Go template expression (prefix calls, pipelines)."""
    # pipelines: A | f | g  → f/g become jinja filters
    parts = [p.strip() for p in expr.split("|")]
    head = parts[0]
    toks = _split_args(head)
    out = _head_to_jinja(toks, in_range)
    for f in parts[1:]:
        out = f"({out}) | {f}"
    return out


def _head_to_jinja(toks: list[str], in_range: bool) -> str:
    if not toks:
        return '""'
    op = toks[0]
    if op in _CMPS and len(toks) >= 3:
        a = _tok_to_jinja(toks[1], in_range)
        b = _tok_to_jinja(toks[2], in_range)
        return f"{a} {_CMPS[op]} {b}"
    if op in ("and", "or") and len(toks) >= 3:
        args = [_head_to_jinja([t], in_range) if not t.startswith("(")
                else _expr_to_jinja(t[1:-1], in_range) for t in toks[1:]]
        return "(" + f" {op} ".join(args) + ")"
    if op == "not" and len(toks) >= 2:
        return f"not ({_head_to_jinja(toks[1:], in_range)})"
    if op in _FUNCS and len(toks) >= 2:
        # call-style function: toJson .X → X | toJson
        args = [_tok_to_jinja(t, in_range) for t in toks[1:]]
        if len(args) == 1:
            return f"{args[0]} | {op}"
        return f"{args[-1]} | {op}({', '.join(args[:-1])})"
    if len(toks) == 1:
        return _tok_to_jinja(op, in_range)
    # unknown function call: render args positionally
    args = ", ".join(_tok_to_jinja(t, in_range) for t in toks[1:])
    return f"{op}({args})"


def go_template_to_jinja(src: str) -> str:
    """Transpile Go template source to Jinja2 source."""
    out: list[str] = []
    stack: list[str] = []  # 'if' | 'for'
    pos = 0
    for m in _ACTION.finditer(src):
        out.append(src[pos:m.start()])
        pos = m.end()
        ltrim = "-" if m.group(1) else ""
        rtrim = "-" if m.group(3) else ""
        body = m.group(2).strip()
        in_range = "for" in stack

        if body.startswith("if "):
            stack.append("if")
            cond = _expr_to_jinja(body[3:].strip(), in_range)
            out.append(f"{{%{ltrim} if {cond} {rtrim}%}}")
        elif body.startswith("else if "):
            cond = _expr_to_jinja(body[8:].strip(), in_range)
            out.append(f"{{%{ltrim} elif {cond} {rtrim}%}}")
        elif body == "else":
            out.append(f"{{%{ltrim} else {rtrim}%}}")
        elif body == "end":
            kind = stack.pop() if stack else "if"
            tag = "endfor" if kind == "for" else "endif"
            out.append(f"{{%{ltrim} {tag} {rtrim}%}}")
        elif body.startswith("range "):
            stack.append("for")
            coll = _expr_to_jinja(body[6:].strip(), in_range)
            out.append(f"{{%{ltrim} for _it in {coll} {rtrim}%}}")
        elif body.startswith("/*") or body.startswith("comment"):
            pass  # comments drop
        else:
            expr = _expr_to_jinja(body, in_range)
            out.append(f"{{{{{ltrim} {expr} {rtrim}}}}}")
    out.append(src[pos:])
    return "".join(out)


def _filter_tojson(v: Any) -> str:
    # Go json.Marshal formatting: compact separators, no HTML escaping of
    # non-ASCII
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def make_environment() -> Environment:
    """The port's engine with the JAX package's overrides: missing fields
    render empty and are falsy (ChainableUndefined, built into the
    engine), the trailing newline is kept, no block trimming."""
    env = Environment()
    env.filters["toJson"] = _filter_tojson
    env.filters["tojson"] = _filter_tojson
    env.filters["trim"] = lambda s: str(s).strip()
    env.filters["title"] = lambda s: str(s).title()
    env.filters["default"] = lambda v, d="": d if not v else v
    return env


def looks_like_go_template(src: str) -> bool:
    """Heuristic: Go templates address fields as {{.Field}} and use
    {{if}}/{{range}}/{{end}} actions; Jinja2 uses {% %} blocks."""
    if "{%" in src:
        return False
    return bool(
        re.search(r"\{\{-?\s*(\.|if\s|else|range\s|end\s*-?\}\}|toJson\s)", src)
    )
