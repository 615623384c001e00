"""Tool-grammar and multimodal-text wiring shared by the chat endpoint,
and the per-request generation deadline.

Port of the constrained-decoding part of ``localai_tpu/api/inference.py``
(``ToolContext``, ``ToolGrammarError``, ``prepare_tools``,
``response_format_constraint``, ``parse_tool_calls``), of its multimodal
part (``MMContent``, ``prepare_multimodal``: image and video parts become
[img-N]/[vid-N] placeholders, fetched and decoded concurrently and
encoded by the model's vision tower; ``expand_image_placeholders``), of
its ``request_deadline_s``, and of the request helpers of
``localai_tpu/api/schema.py`` (``tool_definitions``, ``tool_choice_name``,
``tools_disabled``), written over the parsed JSON body, since the port
has no pydantic request model; and of its SLO admission hook,
:func:`shed_check`.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import logging
import re
import uuid
from typing import Any, Optional

import numpy as np

from localai_tpu_torch import functions as fx
from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.obs import logging as obs_logging
from localai_tpu_torch.obs import slo as obs_slo
from localai_tpu_torch.templates.chat import multimodal_placeholders

log = logging.getLogger(__name__)


# the request's X-Correlation-ID header, bound to the handler's thread by
# api.server for the duration of the request (the JAX package reads it off
# its aiohttp request)
_CORRELATION_ID: contextvars.ContextVar[str] = contextvars.ContextVar(
    "localai_correlation_id", default="")


def bind_correlation_id(cid: str) -> contextvars.Token:
    return _CORRELATION_ID.set(cid)


def unbind_correlation_id(token: contextvars.Token) -> None:
    _CORRELATION_ID.reset(token)


def correlation_id() -> str:
    """The request's X-Correlation-ID header ("" when none); callers fall
    back to their response id."""
    return _CORRELATION_ID.get()


def trace_id() -> str:
    """The trace id the server's request wrapper bound for this request:
    the engine's lifecycle spans group under it, so
    /debug/timeline/{id} shows the HTTP span and every generation it
    spawned together ("" outside a served request)."""
    return obs_logging.current_trace_id()


def request_deadline_s(cfg: Any) -> float:
    """The per-request generation deadline in seconds: the settings'
    ``request_deadline_s`` (``--request-deadline-s`` /
    ``LOCALAI_REQUEST_DEADLINE_S``), or 600 when it is not positive.
    Expiry cancels the generation (its decode slot frees on the next
    engine step) and the request ends with 504."""
    v = cfg.request_deadline_s
    return float(v) if v and v > 0 else 600.0


def shed_check(model: str, scheduler: Any = None) -> None:
    """SLO burn-rate admission control (``obs.slo``): when the observatory
    says ``model`` is out of its error budget on both the fast and slow
    windows, refuse new work with 429 and ``Retry-After`` instead of
    queueing it into a latency spiral. Recovery is automatic: shed
    requests never become SLO events, so the fast window drains. A no-op
    with no targets configured."""
    from localai_tpu_torch.api.openai import APIError

    if not obs_slo.SLO.should_shed(model):
        return
    retry = obs_slo.SLO.shed(model)
    note = getattr(scheduler, "note_shed", None)
    if note is not None:
        note()
    # one whole refused request for the waste decomposition, in the
    # caller's tenant bucket: the only tier that ever sees it
    obs_ledger.LEDGER.note_waste("shed", model=model,
                                 tenant=obs_ledger.current_tenant(),
                                 requests=1)
    raise APIError(429, f"model {model!r} is shedding load (SLO burn rate "
                        f"over threshold); retry after {retry}s",
                   headers={"Retry-After": str(retry)})


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


def _text_content(content: Any) -> str:
    """The text parts of a message, joined (the JAX package's
    ``Message.text_content``)."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    return "".join(str(p.get("text", "")) for p in content
                   if p.get("type") == "text" or "text" in p)


def _media_parts(content: Any, kind: str) -> list[str]:
    """URLs or base64 payloads of a message's ``<kind>_url`` parts."""
    if not isinstance(content, list):
        return []
    key, out = f"{kind}_url", []
    for p in content:
        if p.get("type") == key or key in p:
            val = p.get(key)
            if isinstance(val, dict):
                val = val.get("url")
            if val:
                out.append(str(val))
    return out


@dataclasses.dataclass
class MMContent:
    """Encoded multimodal conditioning: per-item patch embeddings plus the
    row spans videos occupy (a video = several sampled frames)."""

    embeds: Any                                  # [n_rows, n_patches, D]
    video_groups: list[tuple[int, int]]          # [vid-N] → (start, count)


def prepare_multimodal(sm, messages: list[dict]
                       ) -> tuple[list[dict], Optional[MMContent]]:
    """Messages with image or video parts → (their text with [img-N]/
    [vid-N] placeholders — ``template.multimodal``, or the default —, ids
    running across messages; the encoded media, or None when the request
    has none or the model has no vision tower). Media are fetched and
    decoded concurrently (at most 8 at a time, so latency is the slowest
    item's, not the sum); a video's sampled frames are encoded like
    images and injected as consecutive blocks. Raises ``MediaError`` for
    a reference that cannot be fetched or decoded."""
    out: list[dict] = []
    refs: list[str] = []
    vid_refs: list[str] = []
    for m in messages:
        imgs = _media_parts(m.get("content"), "image")
        vids = _media_parts(m.get("content"), "video")
        if imgs or vids:
            m = dict(m, content=multimodal_placeholders(
                sm.config.template.multimodal or "",
                _text_content(m.get("content")),
                n_images=len(imgs), n_video=len(vids),
                first_image_id=len(refs), first_video_id=len(vid_refs)))
            refs.extend(imgs)
            vid_refs.extend(vids)
        out.append(m)
    if not refs and not vid_refs:
        return out, None
    if sm.vision is None:
        log.warning(
            "model %s received %d image(s)/%d video(s) but has no vision "
            "tower (set mmproj or use a llava checkpoint); serving "
            "text-only", sm.name, len(refs), len(vid_refs))
        return out, None
    from concurrent.futures import ThreadPoolExecutor

    from localai_tpu_torch.utils.media import fetch_image, fetch_video_frames

    with ThreadPoolExecutor(max_workers=min(8, len(refs) + len(vid_refs))) \
            as pool:
        img_it = pool.map(fetch_image, refs)
        vid_it = pool.map(fetch_video_frames, vid_refs)
        images = list(img_it)
        frame_lists = list(vid_it)
    video_groups: list[tuple[int, int]] = []
    start = len(images)
    frames: list = []
    for fl in frame_lists:
        video_groups.append((start, len(fl)))
        frames.extend(fl)
        start += len(fl)
    return out, MMContent(embeds=sm.vision.encode(images + frames),
                          video_groups=video_groups)


def expand_image_placeholders(sm, prompt: str, mm: Any
                              ) -> tuple[list[int], Optional[np.ndarray],
                                         Optional[np.ndarray]]:
    """Tokenize a prompt with [img-N]/[vid-N] placeholders: each image
    placeholder becomes n_patches image-token ids (a video: n_frames x
    n_patches), and the matching embedding rows [n_mm, D] and prompt
    positions [n_mm] are returned for the prefill's scatter. ``mm`` is an
    :class:`MMContent` or a raw [n, patches, D] array (images only)."""
    if isinstance(mm, MMContent):
        embeds, video_groups = mm.embeds, mm.video_groups
    else:
        embeds, video_groups = mm, []
    n_images = embeds.shape[0] - sum(c for _, c in video_groups)
    segs = re.split(r"\[(img|vid)-(\d+)\]", prompt)
    tokens = sm.tokenizer.encode(segs[0], add_bos=True)
    rows, poss = [], []
    n_patches = embeds.shape[1]

    def inject(row_start: int, count: int) -> None:
        start = len(tokens)
        tokens.extend([sm.image_token_id] * (n_patches * count))
        poss.extend(range(start, start + n_patches * count))
        rows.append(embeds[row_start:row_start + count].reshape(
            count * n_patches, -1))

    for i in range(1, len(segs), 3):
        kind, idx = segs[i], int(segs[i + 1])
        if kind == "img" and 0 <= idx < n_images:
            inject(idx, 1)
        elif kind == "vid" and 0 <= idx < len(video_groups):
            inject(*video_groups[idx])
        tail = segs[i + 2]
        if tail:
            tokens.extend(sm.tokenizer.encode(tail, add_bos=False))
    injected = sum(r.shape[0] // n_patches for r in rows)
    if injected < embeds.shape[0]:
        # a custom template.multimodal without the media loops eats the
        # placeholders: say so instead of silently serving text only
        log.warning(
            "%d of %d encoded media item(s) had no [img-N]/[vid-N] "
            "placeholder in the rendered prompt (check template.multimodal)",
            embeds.shape[0] - injected, embeds.shape[0])
    if not rows:
        return tokens, None, None
    return tokens, np.concatenate(rows, 0), np.asarray(poss, np.int32)
