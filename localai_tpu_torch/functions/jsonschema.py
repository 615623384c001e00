"""JSON-schema → byte-regex compiler for constrained decoding.

Copy of ``localai_tpu/functions/jsonschema.py``. It covers what LocalAI's
JSON-schema→BNF converter covers (types, const/enum, properties in a
configurable order, arrays, oneOf/anyOf, $defs/$ref, free-form values),
but compiles to a regular expression consumed by fsm.compile_dfa, because
the constraint is applied as a token logit mask, not a CPU sampler
grammar.

Free-form ("any") values are expanded to a bounded nesting depth — a
regular language can't express unbounded recursion; depth 4 covers
practical tool arguments.
"""

from __future__ import annotations

import json
from typing import Any, Optional

# Single optional whitespace between tokens: keeps the DFA small while
# accepting the formatting LLMs actually emit.
WS = "[ \\t\\n]{0,3}"

STRING_INNER = r'([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))'
STRING = f'"{STRING_INNER}*"'
INTEGER = r"-?(0|[1-9][0-9]*)"
NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
BOOLEAN = r"(true|false)"
NULL = r"null"

_SPECIALS = set("\\.^$*+?()[]{}|")


def escape_literal(text: str) -> str:
    """Escape a literal string for the fsm regex dialect."""
    out = []
    for ch in text:
        if ch in _SPECIALS:
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        else:
            out.append(ch)
    return "".join(out)


def _const_regex(value: Any) -> str:
    return escape_literal(json.dumps(value, separators=(",", ":"),
                                     ensure_ascii=False))


def _any_value(depth: int) -> str:
    """Free-form JSON value to bounded depth."""
    scalar = f"({STRING}|{NUMBER}|{BOOLEAN}|{NULL})"
    if depth <= 0:
        return scalar
    inner = _any_value(depth - 1)
    arr = f"\\[{WS}({inner}({WS},{WS}{inner})*)?{WS}\\]"
    obj = (f"\\{{{WS}({STRING}{WS}:{WS}{inner}"
           f"({WS},{WS}{STRING}{WS}:{WS}{inner})*)?{WS}\\}}")
    return f"({scalar}|{arr}|{obj})"


class SchemaError(ValueError):
    pass


class SchemaCompiler:
    """One schema → one regex. Stateless between compiles except $defs."""

    def __init__(self, *, prop_order: Optional[list[str]] = None,
                 any_depth: int = 3, max_ref_depth: int = 16):
        self.prop_order = prop_order or []
        self.any_depth = any_depth
        self.max_ref_depth = max_ref_depth
        self._root: dict = {}

    def compile(self, schema: dict) -> str:
        self._root = schema
        return self._visit(schema, 0)

    # -- dispatch ---------------------------------------------------------

    def _visit(self, schema: Any, depth: int) -> str:
        if depth > self.max_ref_depth:
            raise SchemaError("schema nesting/$ref depth exceeded "
                              f"{self.max_ref_depth} (recursive schema?)")
        if schema is True or schema == {}:
            return _any_value(self.any_depth)
        if not isinstance(schema, dict):
            raise SchemaError(f"unsupported schema node: {schema!r}")
        if "$ref" in schema:
            return self._visit(self._resolve_ref(schema["$ref"]), depth + 1)
        if "const" in schema:
            return _const_regex(schema["const"])
        if "enum" in schema:
            return "(" + "|".join(_const_regex(v) for v in schema["enum"]) + ")"
        for key in ("oneOf", "anyOf"):
            if key in schema:
                opts = [self._visit(s, depth + 1) for s in schema[key]]
                return "(" + "|".join(opts) + ")"
        if "allOf" in schema:
            merged: dict = {}
            for sub in schema["allOf"]:
                if "$ref" in sub:
                    sub = self._resolve_ref(sub["$ref"])
                merged = _merge(merged, sub)
            merged = _merge(merged,
                            {k: v for k, v in schema.items() if k != "allOf"})
            return self._visit(merged, depth + 1)

        typ = schema.get("type")
        if isinstance(typ, list):
            return "(" + "|".join(
                self._visit({**schema, "type": t}, depth + 1) for t in typ
            ) + ")"
        if typ == "string":
            return self._string(schema)
        if typ == "integer":
            return INTEGER
        if typ == "number":
            return NUMBER
        if typ == "boolean":
            return BOOLEAN
        if typ == "null":
            return NULL
        if typ == "object" or "properties" in schema:
            return self._object(schema, depth)
        if typ == "array" or "items" in schema or "prefixItems" in schema:
            return self._array(schema, depth)
        return _any_value(self.any_depth)

    # -- per-type ---------------------------------------------------------

    def _string(self, schema: dict) -> str:
        if "pattern" in schema:
            # Inline the user pattern for the *content* of the string; it must
            # be in the supported dialect (we strip anchors).
            pat = schema["pattern"]
            pat = pat.removeprefix("^").removesuffix("$")
            return f'"({pat})"'
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is None and hi is None:
            return STRING
        quant = f"{{{lo or 0},{hi if hi is not None else ''}}}"
        return f'"{STRING_INNER}{quant}"'

    def _object(self, schema: dict, depth: int) -> str:
        props: dict[str, Any] = schema.get("properties", {})
        required = schema.get("required")
        if required is None:
            required_set = set(props)  # all required (LocalAI's BNF behavior)
        else:
            required_set = set(required)
        names = list(props)
        if self.prop_order:
            order = {n: i for i, n in enumerate(self.prop_order)}
            names.sort(key=lambda n: (order.get(n, len(order)), ))
        req = [n for n in names if n in required_set]
        opt = [n for n in names if n not in required_set]

        def kv(name: str) -> str:
            val = self._visit(props[name], depth + 1)
            return f'"{escape_literal(name)}"{WS}:{WS}{val}'

        if not props:
            addl = schema.get("additionalProperties")
            if addl in (None, True) or isinstance(addl, dict):
                val = (self._visit(addl, depth + 1) if isinstance(addl, dict)
                       else _any_value(self.any_depth))
                pair = f"{STRING}{WS}:{WS}{val}"
                return (f"\\{{{WS}({pair}({WS},{WS}{pair})*)?{WS}\\}}")
            return f"\\{{{WS}\\}}"

        if req:
            # required properties in order; optional ones may follow the
            # required run, each in declared order — a practical regular
            # approximation of JSON-schema objects.
            seq = kv(req[0])
            for name in req[1:]:
                seq += f"{WS},{WS}{kv(name)}"
            for name in opt:
                seq += f"({WS},{WS}{kv(name)})?"
            inner = seq
        else:
            # no required props: empty object, or a subset starting at any
            # property, preserving declared order
            alts = []
            for i in range(len(opt)):
                seq = kv(opt[i])
                for name in opt[i + 1:]:
                    seq += f"({WS},{WS}{kv(name)})?"
                alts.append(seq)
            inner = "(" + "|".join(alts) + ")?" if alts else ""
        return f"\\{{{WS}{inner}{WS}\\}}" if inner else f"\\{{{WS}\\}}"

    def _array(self, schema: dict, depth: int) -> str:
        if "prefixItems" in schema:
            items = [self._visit(s, depth + 1) for s in schema["prefixItems"]]
            seq = f"{WS},{WS}".join(items)
            return f"\\[{WS}{seq}{WS}\\]"
        item = self._visit(schema.get("items", True), depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is not None:
            hi = int(hi)
            if hi == 0:
                return f"\\[{WS}\\]"
            more = f"({WS},{WS}{item}){{{max(lo - 1, 0)},{hi - 1}}}"
            body = f"{item}{more}"
            if lo == 0:
                body = f"({body})?"
            return f"\\[{WS}{body}{WS}\\]"
        if lo <= 0:
            return f"\\[{WS}({item}({WS},{WS}{item})*)?{WS}\\]"
        more = f"({WS},{WS}{item}){{{lo - 1},}}"
        return f"\\[{WS}{item}{more}{WS}\\]"

    # -- refs -------------------------------------------------------------

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise SchemaError(f"only local $refs supported, got {ref!r}")
        node: Any = self._root
        try:
            for part in ref[2:].split("/"):
                part = part.replace("~1", "/").replace("~0", "~")
                if isinstance(node, list):
                    node = node[int(part)]
                else:
                    node = node[part]
        except (KeyError, IndexError, ValueError, TypeError) as e:
            raise SchemaError(f"unresolvable $ref {ref!r}: {e}") from e
        return node


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        elif k in out and k == "required":
            out[k] = list(dict.fromkeys(list(out[k]) + list(v)))
        else:
            out[k] = v
    return out


def schema_to_regex(schema: dict, *, prop_order: Optional[list[str]] = None,
                    any_depth: int = 3) -> str:
    """Public entry: JSON schema dict → fsm-dialect regex string."""
    return SchemaCompiler(
        prop_order=prop_order, any_depth=any_depth
    ).compile(schema)


# The fixed "any JSON object" pattern used for OpenAI's
# response_format={"type":"json_object"} — LocalAI's JSON mode.
JSON_OBJECT_REGEX = _any_value(4)


def sort_prop_order(spec: str) -> list[str]:
    """Parse LocalAI's "name,arguments" properties_order string (its
    grammar option SetPropOrder)."""
    return [p for p in (s.strip() for s in spec.split(",")) if p]
