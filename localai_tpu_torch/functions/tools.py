"""OpenAI tools → JSON-schema union → decoding constraint.

Copy of ``localai_tpu/functions/tools.py``: LocalAI's
Functions.ToJSONStructure and grammar options, aimed at the FSM/logit-mask
pipeline (jsonschema.py + constraint.py) instead of BNF text.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from localai_tpu_torch.config.model_config import FunctionsConfig
from localai_tpu_torch.functions.jsonschema import (
    WS,
    escape_literal,
    schema_to_regex,
    sort_prop_order,
)

NO_ACTION_DESCRIPTION = (
    "use this action to answer the user without performing any other action"
)


def normalize_tools(tools_or_functions: list[dict]) -> list[dict]:
    """Accept both OpenAI `tools` ([{type:function, function:{...}}]) and
    legacy `functions` ([{name,...}]) shapes; return plain function dicts."""
    out = []
    for t in tools_or_functions or []:
        fn = t.get("function") if isinstance(t.get("function"), dict) else t
        if fn.get("name"):
            out.append(fn)
    return out


def inject_no_action(functions: list[dict], cfg: FunctionsConfig) -> list[dict]:
    """Add the default do-nothing tool the LLM uses to answer in prose
    (parity: chat.go no-action injection; disable_no_action skips it)."""
    if cfg.disable_no_action:
        return functions
    name = cfg.no_action_function_name or "answer"
    desc = cfg.no_action_description_name or NO_ACTION_DESCRIPTION
    action = {
        "name": name,
        "description": desc,
        "parameters": {
            "type": "object",
            "properties": {
                "message": {
                    "type": "string",
                    "description": "The message to reply the user with",
                },
            },
            "required": ["message"],
        },
    }
    return list(functions) + [action]


def select_function(functions: list[dict], name: str) -> list[dict]:
    """tool_choice={"name": x} narrowing (parity: Functions.Select)."""
    return [f for f in functions if f.get("name") == name] or list(functions)


def functions_to_schema(
    functions: list[dict],
    *,
    name_key: str = "name",
    arguments_key: str = "arguments",
) -> dict:
    """The call-object union: oneOf {name: const, arguments: {props}}."""
    one_of = []
    defs: dict[str, Any] = {}
    for fn in functions:
        params = fn.get("parameters") or {}
        if isinstance(params.get("$defs"), dict):
            for key, sub in params["$defs"].items():
                if key in defs and defs[key] != sub:
                    raise ValueError(
                        f"conflicting $defs entry {key!r} across tools"
                    )
                defs[key] = sub
        args_schema: dict[str, Any] = {
            "type": "object",
            "properties": params.get("properties") or {},
        }
        if params.get("required") is not None:
            args_schema["required"] = params["required"]
        one_of.append({
            "type": "object",
            "properties": {
                name_key: {"const": fn.get("name", "")},
                arguments_key: args_schema,
            },
        })
    schema: dict[str, Any] = {"oneOf": one_of}
    if defs:
        schema["$defs"] = defs
    return schema


# Free text for mixed mode: anything without a newline start, like
# LocalAI's freestring rule ([^\x0A\x0D] content).
FREESTRING = r"[^\x0A\x0D][^\x00]*"


@dataclasses.dataclass
class BuiltConstraint:
    """Regex + metadata the chat endpoint needs for the parse side."""

    pattern: str
    functions: list[dict]
    schema: dict
    name_key: str
    arguments_key: str
    schema_type: str  # "json" | "llama3.1"


def build_tool_regex(
    functions: list[dict], cfg: FunctionsConfig
) -> BuiltConstraint:
    """Tools + FunctionsConfig grammar options → the decoding regex.

    Options honored (grammars/options.go parity): parallel_calls (array of
    calls), mixed_mode (free-string alternative), no_mixed_free_string,
    prefix, expect_strings_after_json, properties_order, schema_type
    (json | llama3.1), function_name_key/arguments_key.
    """
    g = cfg.grammar or {}
    name_key = cfg.function_name_key or "name"
    args_key = cfg.function_arguments_key or "arguments"
    prop_order = sort_prop_order(str(g.get("properties_order", ""))) or [
        name_key, args_key
    ]
    schema_type = str(g.get("schema_type", "json") or "json")
    schema = functions_to_schema(
        functions, name_key=name_key, arguments_key=args_key
    )

    if schema_type == "llama3.1":
        # <function=name>{json args}</function> tag form
        alts = []
        for fn in functions:
            params = fn.get("parameters") or {}
            args_schema = {
                "type": "object",
                "properties": params.get("properties") or {},
                **({"required": params["required"]}
                   if params.get("required") is not None else {}),
                **({"$defs": params["$defs"]}
                   if isinstance(params.get("$defs"), dict) else {}),
            }
            args_rx = schema_to_regex(args_schema, prop_order=prop_order)
            fname = escape_literal(fn.get("name", ""))
            alts.append(f"<function={fname}>{args_rx}</function>")
        call = "(" + "|".join(alts) + ")" if alts else FREESTRING
    else:
        call = schema_to_regex(schema, prop_order=prop_order)

    if g.get("parallel_calls"):
        if g.get("disable_parallel_new_lines"):
            sep = f"{WS},{WS}"
        else:
            sep = f"{WS},\\n?{WS}"
        pattern = f"(\\[{WS}{call}({sep}{call})*{WS}\\]|{call})"
    else:
        pattern = call

    prefix = str(g.get("prefix", "") or "")
    if prefix:
        pattern = escape_literal(prefix) + pattern

    if g.get("expect_strings_after_json"):
        pattern = f"{pattern}([^\\x00]*)?"

    if g.get("mixed_mode"):
        if g.get("no_mixed_free_string"):
            pattern = f"({FREESTRING})|({pattern})"
        else:
            # JSON may be surrounded by prose, or the reply is pure prose
            pattern = f"({FREESTRING})|([^\\x00]*{pattern}[^\\x00]*)"

    return BuiltConstraint(
        pattern=pattern,
        functions=functions,
        schema=schema,
        name_key=name_key,
        arguments_key=args_key,
        schema_type=schema_type,
    )


def build_tool_constraint(
    functions: list[dict], cfg: FunctionsConfig, tokenizer: Any
):
    """End-to-end: tools → FSMConstraint ready for GenRequest.constraint.
    Returns (constraint, BuiltConstraint); constraint is None when grammar
    generation is disabled (cfg.grammar['disable'])."""
    built = build_tool_regex(functions, cfg)
    if (cfg.grammar or {}).get("disable"):
        return None, built
    from localai_tpu_torch.functions.constraint import constraint_for_regex

    return constraint_for_regex(built.pattern, tokenizer), built
