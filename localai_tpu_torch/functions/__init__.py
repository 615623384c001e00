"""Function calling / constrained decoding, host side.

Port of ``localai_tpu/functions/``: LocalAI's pkg/functions rebuilt as a
token-mask FSM pipeline (schema → regex → byte DFA → per-state [V]
logit-bias rows). The device sees only the bias row
(``ModelRunner.set_bias``).
"""

from localai_tpu_torch.functions.constraint import (
    FSMConstraint,
    constraint_for_regex,
    constraint_for_schema,
)
from localai_tpu_torch.functions.fsm import DFA, compile_dfa
from localai_tpu_torch.functions.jsonschema import (
    JSON_OBJECT_REGEX,
    schema_to_regex,
)
from localai_tpu_torch.functions.parse import (
    FuncCallResult,
    cleanup_llm_result,
    parse_function_call,
    parse_json_objects,
    parse_text_content,
)
from localai_tpu_torch.functions.tools import (
    BuiltConstraint,
    build_tool_constraint,
    build_tool_regex,
    functions_to_schema,
    inject_no_action,
    normalize_tools,
    select_function,
)

__all__ = [
    "DFA",
    "FSMConstraint",
    "FuncCallResult",
    "BuiltConstraint",
    "JSON_OBJECT_REGEX",
    "build_tool_constraint",
    "build_tool_regex",
    "cleanup_llm_result",
    "compile_dfa",
    "constraint_for_regex",
    "constraint_for_schema",
    "functions_to_schema",
    "inject_no_action",
    "normalize_tools",
    "parse_function_call",
    "parse_json_objects",
    "parse_text_content",
    "schema_to_regex",
    "select_function",
]
