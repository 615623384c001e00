"""Chat prompt construction: messages + model config → prompt string.

Port of the template-free part of ``localai_tpu/templates/chat.py::
build_chat_prompt``: role remapping through ``config.roles``, the
role-prefix fallback formatting (with compact-JSON function calls), and the
join by ``template.join_chat_messages_by_character``. Named Go/Jinja
templates are refused when the config loads (config.model_config).
"""

from __future__ import annotations

import json
from typing import Any, Sequence

from localai_tpu_torch.config.model_config import ModelConfig


def _compact_json(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def build_chat_prompt(config: ModelConfig,
                      messages: Sequence[dict[str, Any]]) -> str:
    """Render a /v1/chat/completions message list into the model prompt."""
    parts: list[str] = []
    for msg in messages:
        role = msg.get("role", "user")
        string_content = _string_content(msg.get("content"))
        fcall = msg.get("function_call")
        if msg.get("tool_calls"):
            fcall = msg["tool_calls"]
        if fcall is not None and role == "assistant":
            if config.roles.get("assistant_function_call"):
                role = "assistant_function_call"
        r = config.roles.get(role, "")
        content_exists = bool(string_content)
        content = ""
        if r:
            if content_exists:
                content = f"{r}{string_content}"
            if fcall is not None:
                j = _compact_json(fcall)
                content = (f"{content}\n{r} {j}" if content_exists
                           else f"{r} {j}")
        else:
            if content_exists:
                content = string_content
            if fcall is not None:
                j = _compact_json(fcall)
                content = f"{content}\n{j}" if content_exists else j
        parts.append(content)
    join_char = config.template.join_chat_messages_by_character
    return ("\n" if join_char is None else join_char).join(parts)


def _string_content(content: Any) -> str:
    """Flatten OpenAI string-or-multipart message content."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return str(content)
