"""LLM output → tool calls / text: the parse side of function calling.

Copy of ``localai_tpu/functions/parse.py``, after LocalAI's parse.go:
``cleanup_llm_result`` (ReplaceLLMResult regex substitutions),
``parse_text_content`` (CaptureLLMResult extraction),
``parse_json_objects`` (multi-object tolerant JSON scan),
``parse_function_call`` (JSONRegexMatch → ResponseRegex → JSON decode
pipeline, function_name_key/arguments_key remapping).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
from typing import Any

from localai_tpu_torch.config.model_config import FunctionsConfig

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FuncCallResult:
    name: str
    arguments: str  # stringified JSON object (OpenAI wire shape)


def _apply_replacements(text: str, items: list[dict]) -> str:
    for item in items:
        key = item.get("key")
        if not key:  # malformed entry: an empty pattern would match at
            continue  # every position and mangle the whole output
        text = re.sub(key, item.get("value", ""), text)
    return text


def cleanup_llm_result(llmresult: str, cfg: FunctionsConfig) -> str:
    return _apply_replacements(llmresult, cfg.replace_llm_results)


def parse_text_content(llmresult: str, cfg: FunctionsConfig) -> str:
    """Extract the prose part of a tools response via capture_llm_results
    (first capture group of the first matching regex)."""
    for pattern in cfg.capture_llm_results:
        m = re.search(pattern, llmresult, flags=re.DOTALL)
        if m and m.groups():
            return m.group(1).strip()
    return ""


def parse_json_objects(s: str) -> list[Any]:
    """Parse a string holding one or more JSON values with garbage between
    them: `{..} junk {..}` → both objects; a top-level array of objects is
    flattened. Mirrors LocalAI's offset-skipping ParseJSON."""
    decoder = json.JSONDecoder()
    out: list[Any] = []
    i = 0
    n = len(s)
    while i < n:
        # seek to the next plausible JSON start
        while i < n and s[i] not in "{[":
            i += 1
        if i >= n:
            break
        try:
            obj, end = decoder.raw_decode(s, i)
        except json.JSONDecodeError as e:
            i = max(i + 1, e.pos + 1 if e.pos > i else i + 1)
            continue
        if isinstance(obj, list):
            out.extend(v for v in obj if isinstance(v, dict))
        elif isinstance(obj, dict):
            out.append(obj)
        i = end
    return out


_TAG_CALL = re.compile(r"<function=([\w.-]+)>(.*?)</function>", re.DOTALL)


def parse_function_call(
    llmresult: str, cfg: FunctionsConfig
) -> list[FuncCallResult]:
    """Full pipeline: replacements → JSONRegexMatch extraction →
    ResponseRegex named-group parse | tolerant JSON decode → calls."""
    llmresult = _apply_replacements(llmresult, cfg.replace_function_results)

    name_key = cfg.function_name_key or "name"
    args_key = cfg.function_arguments_key or "arguments"

    candidates: list[str] = []
    if cfg.json_regex_match:
        for pattern in cfg.json_regex_match:
            matches = [
                m.group(1)
                for m in re.finditer(pattern, llmresult, flags=re.DOTALL)
                if m.groups()
            ]
            if matches:
                candidates.extend(matches)
                break

    results: list[FuncCallResult] = []
    if cfg.response_regex:
        for pattern in cfg.response_regex:
            for m in re.finditer(pattern, llmresult, flags=re.DOTALL):
                groups = m.groupdict()
                fname = groups.get(name_key, "")
                if not fname:
                    return results
                results.append(FuncCallResult(
                    name=fname, arguments=groups.get(args_key) or ""
                ))
        return results

    # built-in llama3.1 tag form (LocalAI handles it via its
    # Llama31 schema + user regexes; we support it out of the box)
    tags = _TAG_CALL.findall(llmresult)
    if tags and not candidates:
        for fname, args in tags:
            args = args.strip() or "{}"
            try:
                json.loads(args)
            except json.JSONDecodeError:
                continue
            results.append(FuncCallResult(name=fname, arguments=args))
        if results:
            return results

    if not candidates:
        candidates = [llmresult]
    for cand in candidates:
        for obj in parse_json_objects(cand):
            fname = obj.get(name_key)
            args = obj.get(args_key)
            if not isinstance(fname, str) or args is None:
                continue
            if isinstance(args, str):
                arg_str = args
            else:
                arg_str = json.dumps(args, separators=(",", ":"),
                                     ensure_ascii=False)
            results.append(FuncCallResult(name=fname, arguments=arg_str))
    return results
