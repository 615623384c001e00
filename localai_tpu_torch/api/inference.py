"""Tool-grammar wiring shared by the chat endpoint.

Port of the constrained-decoding part of ``localai_tpu/api/inference.py``
(``ToolContext``, ``ToolGrammarError``, ``prepare_tools``,
``response_format_constraint``, ``parse_tool_calls``) and of the request
helpers of ``localai_tpu/api/schema.py`` (``tool_definitions``,
``tool_choice_name``, ``tools_disabled``), written over the parsed JSON
body, since the port has no pydantic request model.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import uuid
from typing import Any, Optional

from localai_tpu_torch import functions as fx

log = logging.getLogger(__name__)


def _function_def(f: dict) -> dict:
    """A function definition as the JAX package's schema dumps it (the
    ``Functions`` a template renders): ``name`` and ``description``
    (default "") first, then ``parameters`` and the other keys, nulls
    left out."""
    out = {"name": f.get("name", ""), "description": f.get("description",
                                                           "")}
    for k in ("name", "description"):
        if not isinstance(out[k], str):
            raise ValueError(f"function {k} must be a string")
    if f.get("parameters") is not None:
        out["parameters"] = f["parameters"]
    out.update((k, v) for k, v in f.items()
               if k not in out and k != "parameters" and v is not None)
    return out


def tool_definitions(body: dict) -> list[dict]:
    """tools ∪ legacy functions, as plain function dicts (copies)."""
    tools, functions = body.get("tools") or [], body.get("functions") or []
    if not isinstance(tools, list) or not isinstance(functions, list):
        raise ValueError("tools and functions must be lists")
    out: list[dict] = []
    for t in tools:
        if not isinstance(t, dict):
            raise ValueError("each tool must be an object")
        if isinstance(t.get("function"), dict):
            out.append(_function_def(t["function"]))
    for f in functions:
        if not isinstance(f, dict):
            raise ValueError("each function must be an object")
        out.append(_function_def(f))
    return out


def tool_choice_name(body: dict) -> Optional[str]:
    """Requested function name, or None; "none" disables tools."""
    for choice in (body.get("tool_choice"), body.get("function_call")):
        if choice is None:
            continue
        if isinstance(choice, str):
            if choice in ("none", "auto", "required"):
                return None
            return choice
        if isinstance(choice, dict):
            fn = choice.get("function", choice)
            name = fn.get("name") if isinstance(fn, dict) else None
            if name:
                return str(name)
    return None


def tools_disabled(body: dict) -> bool:
    return body.get("tool_choice") == "none" or \
        body.get("function_call") == "none"


@dataclasses.dataclass
class ToolContext:
    """What the chat endpoint needs to post-process a tools response."""

    functions: list[dict]
    config_fn: Any  # FunctionsConfig
    no_action_name: str
    constraint: Any = None


class ToolGrammarError(ValueError):
    """tool_choice='required' whose grammar can't be built — a client
    error (the endpoint maps it to 400)."""


def prepare_tools(sm, body: dict) -> Optional[ToolContext]:
    """Normalize tools, apply tool_choice, build the FSM constraint.
    Returns None when the request carries no usable tools or disables
    them."""
    if tools_disabled(body):
        return None
    functions = tool_definitions(body)
    if not functions:
        return None
    fn_cfg = sm.config.function
    required = (body.get("tool_choice") == "required"
                or body.get("function_call") == "required")
    if required:
        # the model MUST call some tool: no no-action escape hatch, so the
        # grammar admits real calls only
        funcs = list(functions)
    else:
        funcs = fx.inject_no_action(functions, fn_cfg)
    choice = tool_choice_name(body)
    if choice:
        funcs = fx.select_function(funcs, choice)
    constraint = None
    try:
        constraint, _built = fx.build_tool_constraint(funcs, fn_cfg,
                                                      sm.tokenizer)
    except Exception as e:  # noqa: BLE001 — a bad schema ≠ failed request
        if required:
            # ...except under tool_choice="required": without the grammar
            # the "must call a tool" contract can't be honoured
            raise ToolGrammarError(
                f"tool_choice='required' but the tool grammar could not "
                f"be built: {e}") from e
        log.warning("tool grammar build failed (%s); decoding "
                    "unconstrained", e)
    return ToolContext(functions=funcs, config_fn=fn_cfg,
                       no_action_name=fn_cfg.no_action_function_name
                       or "answer",
                       constraint=constraint)


def response_format_constraint(sm, body: dict) -> Optional[Any]:
    """response_format json_object / json_schema → decoding constraint
    (None for text or an unknown type)."""
    rf = body.get("response_format")
    if rf is None:
        return None
    if isinstance(rf, str):
        kind, payload = rf, {}
    elif isinstance(rf, dict):
        kind, payload = str(rf.get("type", "")), rf
    else:
        raise ValueError("response_format must be a string or an object")
    if kind == "json_object":
        return fx.constraint_for_regex(fx.JSON_OBJECT_REGEX, sm.tokenizer)
    if kind == "json_schema":
        schema = (payload.get("json_schema") or {}).get("schema")
        if schema:
            return fx.constraint_for_schema(schema, sm.tokenizer)
    return None


def parse_tool_calls(text: str, tctx: ToolContext
                     ) -> tuple[str, list[dict]]:
    """LLM output → (content, OpenAI tool_calls). The no-action function's
    message becomes plain content. Call ids are random, as on the JAX
    package."""
    cleaned = fx.cleanup_llm_result(text, tctx.config_fn)
    calls = fx.parse_function_call(cleaned, tctx.config_fn)
    content = ""
    tool_calls: list[dict] = []
    for call in calls:
        if call.name == tctx.no_action_name:
            try:
                args = json.loads(call.arguments or "{}")
                content = str(args.get("message", "")) or cleaned
            except Exception:  # noqa: BLE001
                content = cleaned
            continue
        tool_calls.append({
            "id": f"call-{uuid.uuid4().hex[:24]}",
            "index": len(tool_calls),
            "type": "function",
            "function": {"name": call.name, "arguments": call.arguments},
        })
    if not calls:
        content = fx.parse_text_content(cleaned, tctx.config_fn) or cleaned
    elif not content and not tool_calls:
        content = cleaned
    return content, tool_calls
