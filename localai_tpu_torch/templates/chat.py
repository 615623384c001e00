"""Chat prompt construction: messages + model config → prompt string.

Port of ``localai_tpu/templates/chat.py`` (``build_chat_prompt``,
``build_completion_prompt``, ``build_edit_prompt``,
``apply_tokenizer_template``), rendering through the port's template
engine:
  * role remapping via ``config.roles`` (incl. assistant_function_call),
  * the per-message ``chat_message`` template (the JAX package's data
    fields); a blank render skips the message,
  * the role-prefix fallback with JSON-marshalled tool calls,
  * system-prompt suppression when the request carries its own system
    message,
  * join by ``template.join_chat_messages_by_character``, then the outer
    template: the model-file template (``<model>.tmpl``/``.jinja``/
    ``.j2`` in the models dir), then ``chat``, or ``functions`` for a
    tools request (``SystemPrompt``, ``SuppressSystemPrompt``, ``Input``,
    ``Functions``),
plus the tokenizer chat-template mode. A template that fails to render
falls back exactly where the JAX package's does.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Optional, Sequence

from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.templates.cache import TemplateCache, TemplateType
from localai_tpu_torch.templates.engine import Template
from localai_tpu_torch.templates.gotmpl import (
    go_template_to_jinja,
    looks_like_go_template,
    make_environment,
)

# the placeholders a message with images, audio or video gets by default
DEFAULT_MULTIMODAL = (
    "{{ range .Audio }}[audio-{{.ID}}]{{end}}"
    "{{ range .Images }}[img-{{.ID}}]{{end}}"
    "{{ range .Video }}[vid-{{.ID}}]{{end}}"
    "{{.Text}}"
)


def _compact_json(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def build_chat_prompt(
    cache: TemplateCache,
    config: ModelConfig,
    messages: Sequence[dict[str, Any]],
    *,
    functions: Optional[list[dict]] = None,
    use_function_template: bool = False,
    grammar_active: bool = False,
) -> str:
    """Render a /v1/chat/completions message list into the model prompt."""
    tpl = config.template
    suppress_system = False
    parts: list[str] = []

    for idx, msg in enumerate(messages):
        role = msg.get("role", "user")
        content_value = msg.get("content")
        string_content = _string_content(content_value)
        fcall = msg.get("function_call")
        if msg.get("tool_calls"):
            fcall = msg["tool_calls"]

        # assistant_function_call role override
        if fcall is not None and role == "assistant":
            if config.roles.get("assistant_function_call"):
                role = "assistant_function_call"
        r = config.roles.get(role, "")
        content_exists = bool(string_content)

        content = ""
        if tpl.chat_message:
            data = {
                "SystemPrompt": config.system_prompt,
                "Role": r,
                "RoleName": role,
                "Content": string_content,
                "FunctionCall": fcall,
                "FunctionName": msg.get("name", ""),
                "LastMessage": idx == len(messages) - 1,
                "Function": grammar_active and idx == len(messages) - 1,
                "MessageIndex": idx,
            }
            try:
                content = cache.evaluate(
                    TemplateType.CHAT_MESSAGE, tpl.chat_message, data
                )
            except Exception:  # noqa: BLE001 — template errors skip to fallback
                content = ""
            if tpl.chat_message and content == "":
                # blank template output skips the message entirely
                continue

        if content == "":
            # role-prefix fallback formatting
            if r:
                if content_exists:
                    content = f"{r}{string_content}"
                if fcall is not None:
                    j = _compact_json(fcall)
                    content = (
                        f"{content}\n{r} {j}" if content_exists else f"{r} {j}"
                    )
            else:
                if content_exists:
                    content = string_content
                if fcall is not None:
                    j = _compact_json(fcall)
                    content = f"{content}\n{j}" if content_exists else j
            if content_exists and role == "system":
                suppress_system = True

        parts.append(content)

    join_char = (
        tpl.join_chat_messages_by_character
        if tpl.join_chat_messages_by_character is not None
        else "\n"
    )
    pred_input = join_char.join(parts)

    # outer prompt template selection
    template_name = ""
    if config.model and cache.exists_file(config.model):
        template_name = config.model
    if tpl.chat and not use_function_template:
        template_name = tpl.chat
    if tpl.functions and use_function_template:
        template_name = tpl.functions

    if template_name:
        try:
            pred_input = cache.evaluate(
                TemplateType.CHAT, template_name, {
                    "SystemPrompt": config.system_prompt,
                    "SuppressSystemPrompt": suppress_system,
                    "Input": pred_input,
                    "Functions": functions or [],
                },
            )
        except Exception:  # noqa: BLE001 — failed template leaves input as-is
            pass
    return pred_input


def build_completion_prompt(
    cache: TemplateCache, config: ModelConfig, prompt: str
) -> str:
    """The ``completion`` template (or the model-file template) around a
    /v1/completions prompt."""
    name = config.template.completion or (
        config.model if config.model and cache.exists_file(config.model) else ""
    )
    if not name:
        return prompt
    try:
        return cache.evaluate(TemplateType.COMPLETION, name, {
            "SystemPrompt": config.system_prompt,
            "Input": prompt,
        })
    except Exception:  # noqa: BLE001
        return prompt


def build_edit_prompt(
    cache: TemplateCache, config: ModelConfig, input_text: str, instruction: str
) -> str:
    """The ``edit`` template (or the model-file template) for /v1/edits;
    without one, the instruction, a blank line and the input."""
    name = config.template.edit or (
        config.model if config.model and cache.exists_file(config.model) else ""
    )
    if not name:
        return f"{instruction}\n\n{input_text}"
    try:
        return cache.evaluate(TemplateType.EDIT, name, {
            "SystemPrompt": config.system_prompt,
            "Input": input_text,
            "Instruction": instruction,
        })
    except Exception:  # noqa: BLE001
        return f"{instruction}\n\n{input_text}"


def apply_tokenizer_template(
    tokenizer: Any,
    messages: Sequence[dict[str, Any]],
    *,
    add_generation_prompt: bool = True,
    chat_template: Optional[str] = None,
) -> str:
    """UseTokenizerTemplate mode. The port's tokenizers carry no
    ``apply_chat_template``, so this is always the JAX package's fallback:
    render ``chat_template`` with empty ``bos_token``/``eos_token``, or
    raise the reference's ValueError when there is none."""
    if chat_template is None:
        raise ValueError(
            "tokenizer has no chat template; set template.chat_template or "
            "use prompt templates"
        )
    return parsed_chat_template(chat_template).render(
        messages=list(messages),
        add_generation_prompt=add_generation_prompt,
        bos_token="", eos_token="",
    )


@functools.lru_cache(maxsize=64)
def parsed_chat_template(source: str) -> Template:
    """A chat template, parsed once per source text."""
    return make_environment().from_string(source)


def multimodal_placeholders(
    template: str,
    text: str,
    *,
    n_images: int = 0,
    n_audio: int = 0,
    n_video: int = 0,
    first_image_id: int = 0,
    first_video_id: int = 0,
) -> str:
    """A message's text with its [img-N]/[audio-N]/[vid-N] placeholders,
    through ``template`` (Go or Jinja; ``DEFAULT_MULTIMODAL`` when empty).
    ``first_image_id``/``first_video_id`` offset the ids, so a request
    with several such messages keeps one running numbering."""
    src = template or DEFAULT_MULTIMODAL
    if looks_like_go_template(src):
        src = go_template_to_jinja(src)
    return parsed_chat_template(src).render(
        Text=text,
        Images=[{"ID": first_image_id + i} for i in range(n_images)],
        Audio=[{"ID": i} for i in range(n_audio)],
        Video=[{"ID": first_video_id + i} for i in range(n_video)],
    )


def _string_content(content: Any) -> str:
    """Flatten OpenAI string-or-multipart message content."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        texts = [
            p.get("text", "") for p in content
            if isinstance(p, dict) and p.get("type") == "text"
        ]
        return "".join(texts)
    return str(content)
