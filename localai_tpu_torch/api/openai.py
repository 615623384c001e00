"""OpenAI-compatible endpoints: chat completions, completions, edits,
embeddings, models.

Port of the text part of ``localai_tpu/api/openai.py`` (and the response
shapes of ``api/schema.py``), written as framework-free functions over
parsed JSON: ``api.server`` maps HTTP onto them. Response JSON has the
JAX package's shape — id, object, created, model, choices with ``delta``
(stream) or ``message``, finish_reason, usage; embeddings as a list of
``embedding`` objects. Prompts are built by the model's templates
(``templates.chat``): the tokenizer chat template (``chat_template`` /
``use_tokenizer_template``) or ``chat_message`` + ``chat``/``functions``
for chats, ``completion`` for each prompt of a completion, ``edit`` for
an edit. ``n`` choices each get ``seed + i`` (and a fresh constraint);
streamed, every choice streams on its own index (a streamed tools chat
stays single-choice, as on the JAX package). Non-streamed choices go
through the model's text shaping (:func:`finetune_result`). Chat
completions serve constrained decoding as the JAX package does
(``api.inference``): tools and legacy functions under every
``tool_choice``, answered with ``tool_calls``, and ``response_format``
``json_object`` / ``json_schema``. A raw ``grammar`` string is refused
with a 400 (the JAX package reads it nowhere), and so are tools and a
non-text ``response_format`` on ``/v1/completions``, which the JAX
package ignores there: a silent no-op would serve something else than
was asked for. A chat's ``image_url`` and ``video_url`` parts go through
the model's vision tower (``api.inference.prepare_multimodal``); a
reference that cannot be fetched or decoded is a 400, as on the JAX
package. A streamed answer records ``first_sse_write`` on its request's
trace after its first content frame (``api.streams.mark_first_write``).
"""

from __future__ import annotations

import math
import queue
import re
import threading
import time
import uuid
from typing import Any, Iterator, Optional

from localai_tpu_torch.api import inference as inf
from localai_tpu_torch.api.streams import (
    SSE_DONE,
    mark_first_write,
    sse_event,
)
from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.templates.chat import (
    apply_tokenizer_template,
    build_chat_prompt,
    build_completion_prompt,
    build_edit_prompt,
)
from localai_tpu_torch.utils.media import MediaError

class APIError(Exception):
    """An error the server reports as ``{"error": ...}`` with a status
    (and ``headers``, e.g. a shed 429's ``Retry-After``)."""

    def __init__(self, status: int, message: str,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = dict(headers or {})


def new_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chat_chunk(rid: str, model: str, delta: dict, *, index: int = 0,
               finish_reason: Optional[str] = None,
               usage_dict: Optional[dict] = None) -> dict:
    out = {"id": rid, "object": "chat.completion.chunk",
           "created": int(time.time()), "model": model,
           "choices": [{"index": index, "delta": delta,
                        "finish_reason": finish_reason}]}
    if usage_dict is not None:
        out["usage"] = usage_dict
    return out


def completion_response(rid: str, model: str, choices: list[dict],
                        usage_dict: dict, *,
                        object_name: str = "text_completion") -> dict:
    return {"id": rid, "object": object_name,
            "created": int(time.time()),
            "model": model, "choices": choices, "usage": usage_dict}


def embeddings_response(model: str, vectors: list[list[float]],
                        prompt_tokens: int) -> dict:
    return {"object": "list", "model": model,
            "data": [{"object": "embedding", "index": i, "embedding": v}
                     for i, v in enumerate(vectors)],
            "usage": usage(prompt_tokens, 0)}


def chat_response(rid: str, model: str, choices: list[dict],
                  usage_dict: dict) -> dict:
    return {"id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": model,
            "choices": choices, "usage": usage_dict}


def models_response(names: list[str]) -> dict:
    return {"object": "list",
            "data": [{"id": n, "object": "model", "owned_by": "localai-tpu"}
                     for n in names]}


def _model_name(manager, body: dict) -> str:
    """The request's ``model``, or the first configured model."""
    name = body.get("model") or ""
    if not name:
        names = manager.loader.names()
        if not names:
            raise APIError(404, "no models configured")
        name = names[0]
    if manager.loader.get(name) is None:
        raise APIError(404, f"model {name!r} not found; available: "
                            f"{manager.loader.names()}")
    return name


def _serving(manager, body: dict, usecase: Optional[str] = None):
    """(ServingModel, model name) for a request body; a model without
    ``usecase`` (when given) is refused before it is loaded."""
    name = _model_name(manager, body)
    if usecase is not None and not manager.loader.get(name).has_usecase(
            usecase):
        raise APIError(400, f"model {name!r} does not support {usecase}")
    try:
        return manager.get(name), name
    except FileNotFoundError as e:
        raise _load_failed(e) from None


def _load_failed(e: Exception) -> APIError:
    return APIError(500, f"model load failed: {e}")


def _runner(sm, usecase: str):
    """The llama engine's runner of a serving model: embeddings and
    cosine rerank need it, and a recurrent or remote model has none."""
    runner = getattr(sm, "runner", None)
    if runner is None:
        raise APIError(400, f"model {sm.name!r} ({sm.config.backend}) "
                            f"does not serve {usecase}")
    return runner


def finetune_result(cfg, prompt: str, text: str, *,
                    echo: bool = False) -> str:
    """Post-inference text shaping, as the JAX package's
    ``api.inference.finetune_result``: ``echo`` prepends the prompt, then
    ``cutstrings`` (regexes removed), the first matching
    ``extract_regex`` (its group 1, else the match), ``trimspace`` (strip
    once when any is set) and ``trimsuffix``."""
    if echo:
        text = prompt + text
    for c in cfg.cutstrings:
        text = re.sub(c, "", text)
    for ex in cfg.extract_regex:
        m = re.search(ex, text)
        if m:
            text = m.group(1) if m.groups() else m.group(0)
            break
    if cfg.trimspace:
        text = text.strip()
    for suf in cfg.trimsuffix:
        text = text.removesuffix(suf)
    return text


def _refuse_grammar(body: dict) -> None:
    """400 for a raw ``grammar`` string: the JAX package declares the
    request field and reads it nowhere, so no constraint could honour
    it."""
    if body.get("grammar"):
        raise APIError(400, "grammar: a raw grammar string is not served "
                            "(the JAX package declares the field and reads "
                            "it nowhere); use tools or response_format for "
                            "constrained decoding")


def _refuse_completion_constraints(body: dict) -> None:
    """400 for tools, functions, a tool_choice that forces a call or a
    non-text response_format on /v1/completions, where the JAX package
    ignores them (it constrains chat completions only)."""
    asked = [k for k in ("tools", "functions") if body.get(k)]
    if body.get("tool_choice") not in (None, "none", "auto"):
        asked.append("tool_choice")
    rf = body.get("response_format")
    if rf and not (isinstance(rf, dict) and rf.get("type") == "text"):
        asked.append("response_format")
    if asked:
        raise APIError(400, f"{', '.join(asked)}: constrained decoding is "
                            "served on /v1/chat/completions only")


def _choices(body: dict) -> int:
    """The request's ``n`` (1 when absent or below 1) of a body
    :func:`request_body` read."""
    return max(1, body.get("n") or 1)


def _gen_request(sm, body: dict, prompt: str, stream: bool,
                 constraint=None, seed_offset: int = 0,
                 mm: Any = None, rid: str = "") -> GenRequest:
    """Request body over the model's YAML defaults → GenRequest; choice
    ``seed_offset`` of an ``n`` > 1 request samples with ``seed + i``.
    With encoded media (``mm``, an ``inference.MMContent``) the prompt's
    placeholders expand into image-token ids whose rows the prefill
    replaces with the media's embeddings. The correlation id is the
    request's X-Correlation-ID, else the response id ``rid``; the trace id
    the server bound, else the correlation id."""
    _refuse_grammar(body)
    cfg = sm.config
    p = cfg.parameters.merged_with({
        k: body.get(k) for k in ("temperature", "top_p", "top_k", "min_p",
                                 "max_tokens", "seed", "presence_penalty",
                                 "frequency_penalty", "repeat_penalty")})
    stop = body.get("stop")
    stops = ([stop] if isinstance(stop, str)
             else [s for s in stop or [] if isinstance(s, str)])
    logit_bias = None
    if body.get("logit_bias"):
        logit_bias = {}
        for k, v in body["logit_bias"].items():
            try:
                logit_bias[int(k)] = float(v)
            except (TypeError, ValueError):
                continue
    cid = inf.correlation_id() or rid
    seed = p.seed
    if seed is not None and seed_offset:
        seed = seed + seed_offset
    mm_rows = mm_pos = None
    if mm is not None:
        tokens, mm_rows, mm_pos = inf.expand_image_placeholders(sm, prompt,
                                                                mm)
    else:
        tokens = sm.tokenizer.encode(prompt, add_bos=True)
    return GenRequest(
        prompt=tokens,
        max_new_tokens=p.max_tokens or 2048,
        temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
        min_p=p.min_p, repeat_penalty=p.repeat_penalty,
        presence_penalty=p.presence_penalty,
        frequency_penalty=p.frequency_penalty, seed=seed,
        logit_bias=logit_bias,
        stop=tuple(cfg.stopwords) + tuple(stops), constraint=constraint,
        ignore_eos=bool(body.get("ignore_eos")), stream=stream,
        mm_embeds=mm_rows, mm_positions=mm_pos,
        correlation_id=cid, trace_id=inf.trace_id() or cid,
        tenant=obs_ledger.current_tenant())


_MESSAGE_FIELDS = ("role", "name", "content", "tool_calls", "function_call")


def _str_field(value: Any, what: str) -> str:
    if not isinstance(value, str):
        raise APIError(400, f"{what} must be a string")
    return value


def _dump_function_call(fc: dict, what: str) -> dict:
    """A function call as the JAX package's schema dumps it: ``name`` and
    ``arguments`` (default "") first, then its other non-null keys."""
    out = {"name": _str_field(fc.get("name", ""), f"{what}.name"),
           "arguments": _str_field(fc.get("arguments", ""),
                                   f"{what}.arguments")}
    out.update((k, v) for k, v in fc.items()
               if k not in out and v is not None)
    return out


def _dump_tool_call(tc: Any) -> dict:
    if not isinstance(tc, dict):
        raise APIError(400, "tool_calls entries must be objects")
    fn = tc.get("function", {})
    if not isinstance(fn, dict):
        raise APIError(400, "tool_calls[].function must be an object")
    out: dict[str, Any] = {"id": _str_field(tc.get("id", ""),
                                            "tool_calls[].id")}
    if tc.get("index") is not None:
        out["index"] = tc["index"]
    out["type"] = _str_field(tc.get("type", "function"),
                             "tool_calls[].type")
    out["function"] = _dump_function_call(fn, "tool_calls[].function")
    out.update((k, v) for k, v in tc.items()
               if k not in out and v is not None)
    return out


def chat_messages(raw: Any) -> list[dict]:
    """The request's messages as the templates see them: the JAX package
    validates them into its schema and dumps them without nulls (a role
    defaults to ``user``, tool calls get their default fields, declared
    fields come first)."""
    if not isinstance(raw, list):
        raise APIError(400, "messages must be a list")
    out = []
    for m in raw:
        if not isinstance(m, dict):
            raise APIError(400, "each message must be an object")
        d: dict[str, Any] = {"role": _str_field(m.get("role", "user"),
                                                "role")}
        if m.get("name") is not None:
            d["name"] = _str_field(m["name"], "name")
        content = m.get("content")
        if content is not None:
            if not (isinstance(content, str) or (
                    isinstance(content, list)
                    and all(isinstance(p, dict) for p in content))):
                raise APIError(400, "content must be a string or a list "
                                    "of parts")
            d["content"] = content
        if m.get("tool_calls") is not None:
            if not isinstance(m["tool_calls"], list):
                raise APIError(400, "tool_calls must be a list")
            d["tool_calls"] = [_dump_tool_call(tc) for tc in m["tool_calls"]]
        fc = m.get("function_call")
        if fc is not None:
            if not isinstance(fc, dict):
                raise APIError(400, "function_call must be an object")
            try:
                d["function_call"] = _dump_function_call(fc, "function_call")
            except APIError:
                d["function_call"] = fc   # kept as given, as a plain dict
        d.update((k, v) for k, v in m.items()
                 if k not in _MESSAGE_FIELDS and v is not None)
        out.append(d)
    return out



# the JAX package's request schema (api/schema.py OpenAIRequest), field by
# field, for the checks and coercions pydantic runs in its lax mode
_FLOATS = ("temperature", "top_p", "min_p", "presence_penalty",
           "frequency_penalty", "repeat_penalty")
_INTS = ("top_k", "max_tokens", "n", "seed")
_REQUIRED_INTS = ("mode", "step")
_BOOLS = ("ignore_eos", "echo", "stream")
_STRS = ("model", "instruction", "suffix", "size", "file", "user")
_OPT_STRS = ("grammar", "language", "backend")
_STR_OR_STRS = ("prompt", "stop")
_STR_OR_DICT = ("tool_choice", "function_call", "response_format")
_LISTS_OF_DICTS = ("tools", "functions")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
# a string pydantic reads as an int: digits (with single underscores
# between them), optionally a fraction of zeros
_INT_STR = re.compile(r"\s*[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?\s*")


def _as_float(v: Any) -> Optional[float]:
    """``v`` read as a float field in pydantic's lax mode, else None."""
    if isinstance(v, (bool, int, float)) or (isinstance(v, str)
                                             and v.isascii()):
        try:
            return float(v)
        except (ValueError, OverflowError):
            return None
    return None


def _as_int(v: Any) -> Optional[int]:
    """``v`` read as an int field in pydantic's lax mode, else None."""
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        ok = math.isfinite(v) and v == int(v) and abs(v) < 2 ** 63
        return int(v) if ok else None
    if isinstance(v, str) and v.isascii() and _INT_STR.fullmatch(v):
        return int(v.strip().split(".")[0])
    return None


def _as_bool(v: Any) -> Optional[bool]:
    """``v`` read as a bool field in pydantic's lax mode, else None."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
        return v.lower() in _TRUE
    return None


def request_body(body: Any) -> dict:
    """``body`` as the JAX package's request schema reads it, for every
    route and lane that takes one (chat, completions, edits, embeddings
    and each batch line): numbers and booleans coerced as pydantic's lax
    mode coerces them (numeric strings, integral floats, 0/1 and yes/no
    words), the other fields type-checked, the messages checked by
    :func:`chat_messages`. What the schema refuses is a 400 ``invalid
    request: <field>: <why>; ...`` (the JAX message is pydantic's own
    wording; ROADMAP §C)."""
    if not isinstance(body, dict):
        raise APIError(400, "invalid request: the body must be an object")
    out = dict(body)
    errors = []

    def coerce(fields, read, why, optional=True):
        for k in fields:
            if k not in body or (optional and body[k] is None):
                continue
            v = read(body[k])
            if v is None:
                errors.append(f"{k}: {why}")
            else:
                out[k] = v

    coerce(_FLOATS, _as_float, "not a number")
    coerce(_INTS, _as_int, "not an integer")
    coerce(_REQUIRED_INTS, _as_int, "not an integer", optional=False)
    coerce(_BOOLS, _as_bool, "not a boolean", optional=False)
    for k in _STRS:
        if k in body and not isinstance(body[k], str):
            errors.append(f"{k}: not a string")
    for k in _OPT_STRS:
        if body.get(k) is not None and not isinstance(body[k], str):
            errors.append(f"{k}: not a string")
    for k in _STR_OR_STRS:
        v = body.get(k)
        if v is not None and not isinstance(v, str) and not (
                isinstance(v, list) and all(isinstance(x, str) for x in v)):
            errors.append(f"{k}: not a string or a list of strings")
    for k in _STR_OR_DICT:
        v = body.get(k)
        if v is not None and not isinstance(v, (str, dict)):
            errors.append(f"{k}: not a string or an object")
    for k in _LISTS_OF_DICTS:
        v = body.get(k)
        if v is not None and not (isinstance(v, list) and all(
                isinstance(x, dict) for x in v)):
            errors.append(f"{k}: not a list of objects")
    bias = body.get("logit_bias")
    if bias is not None:
        vals = ({k: _as_float(x) for k, x in bias.items()}
                if isinstance(bias, dict) else None)
        if vals is None or None in vals.values():
            errors.append("logit_bias: not an object of numbers")
        else:
            out["logit_bias"] = vals
    v = body.get("input")
    if v is not None and not isinstance(v, (str, list)):
        errors.append("input: not a string or a list")
    if "messages" in body:
        try:
            chat_messages(body["messages"])
        except APIError as e:
            errors.append(f"messages: {e.message}")
    if errors:
        raise APIError(400, "invalid request: " + "; ".join(errors))
    return out


def _wait(manager, *handles: GenHandle) -> None:
    """Join generations within the request deadline
    (``inference.request_deadline_s`` of the manager's settings); on
    expiry cancel them all (the slots free on the next engine step) and
    answer 504. A handle that failed with no output is a backend failure
    (502), not an empty completion."""
    timeout = inf.request_deadline_s(manager.app)
    deadline = time.monotonic() + timeout
    try:
        for h in handles:
            h.result(max(0.0, deadline - time.monotonic()))
    except BaseException as e:
        for h in handles:
            h.cancel()
        if isinstance(e, TimeoutError):
            raise APIError(504, f"generation exceeded the {timeout:.0f}s "
                                "request deadline and was cancelled"
                           ) from None
        raise
    for h in handles:
        if h.finish_reason == "error" and not h.text:
            raise APIError(502, "generation failed in the backend")


def _merged(handles: list[GenHandle]) -> Iterator[tuple[int, Any]]:
    """(choice index, stream item) of several generations, as they
    arrive; each handle is drained by a thread of its own."""
    q: "queue.Queue[tuple[int, Any]]" = queue.Queue()

    def pump(i: int, h: GenHandle) -> None:
        for item in h:
            q.put((i, item))

    for i, h in enumerate(handles):
        threading.Thread(target=pump, args=(i, h), daemon=True,
                         name=f"choice-{i}").start()
    live = len(handles)
    while live:
        i, item = q.get()
        if item.finish_reason is not None:
            live -= 1
        yield i, item


def _chat_prompt(sm, messages: list[dict],
                 tctx: Optional[inf.ToolContext]) -> str:
    """The tokenizer chat template for ``use_tokenizer_template``, or for
    a ``chat_template`` on a chat without tools (tool requests stay on
    the model's templates, which render function schemas and tool turns);
    else ``build_chat_prompt``."""
    cfg = sm.config
    if cfg.template.use_tokenizer_template or (
            cfg.template.chat_template and tctx is None):
        return apply_tokenizer_template(
            sm.tokenizer, messages, chat_template=cfg.template.chat_template)
    return build_chat_prompt(
        sm.templates, cfg, messages,
        functions=tctx.functions if tctx else None,
        use_function_template=tctx is not None,
        grammar_active=tctx is not None and tctx.constraint is not None)


def chat(manager, body: dict):
    """POST /v1/chat/completions → a response dict, or an iterator of SSE
    frames when ``stream`` is set. Tools (``api.inference.prepare_tools``)
    or a JSON ``response_format`` attach a grammar constraint to the
    request; a tools answer is parsed into ``tool_calls``. ``n`` > 1
    submits every choice at once, each with ``seed + i`` and a constraint
    of its own."""
    body = request_body(body)
    sm, model = _serving(manager, body, "chat")
    # SLO admission control before any prompt build or constraint compile:
    # a 429 must cost the overloaded engine nothing
    inf.shed_check(model, getattr(sm, "scheduler", None))
    raw_messages = chat_messages(body.get("messages"))
    stream = bool(body.get("stream"))
    n = _choices(body)
    try:
        tctx = inf.prepare_tools(sm, body)
    except inf.ToolGrammarError as e:
        raise APIError(400, str(e)) from e
    rf_constraint = (None if tctx is not None
                     else inf.response_format_constraint(sm, body))
    try:
        messages, mm = inf.prepare_multimodal(sm, raw_messages)
    except MediaError as e:  # a bad image or video reference
        raise APIError(400, str(e)) from e
    prompt = _chat_prompt(sm, messages, tctx)
    constraint = tctx.constraint if tctx is not None else rf_constraint
    rid = new_id("chatcmpl")
    gr = _gen_request(sm, body, prompt, stream, constraint, mm=mm, rid=rid)

    def extra_choice(i: int) -> GenRequest:
        """Choice i > 0 needs a fresh constraint (FSM state is
        per-request)."""
        c = None
        if tctx is not None:
            c = inf.prepare_tools(sm, body).constraint
        elif rf_constraint is not None:
            c = inf.response_format_constraint(sm, body)
        return _gen_request(sm, body, prompt, stream, c, seed_offset=i,
                            mm=mm, rid=rid)

    if stream:
        if n > 1 and tctx is None:
            grs = [gr] + [extra_choice(i) for i in range(1, n)]
            return _chat_stream_n([sm.scheduler.submit(g) for g in grs],
                                  rid, model)
        return _chat_stream(sm.scheduler.submit(gr), rid, model, sm.config,
                            tctx)
    handles = []
    for i in range(n):
        handles.append(sm.scheduler.submit(gr if i == 0
                                           else extra_choice(i)))
    _wait(manager, *handles)
    choices = []
    for i, h in enumerate(handles):
        text = finetune_result(sm.config, "", h.text)
        message: dict[str, Any] = {"role": "assistant"}
        finish = h.finish_reason or "stop"
        if tctx is not None:
            content, tool_calls = inf.parse_tool_calls(text, tctx)
            message["content"] = content or None
            if tool_calls:
                message["tool_calls"] = tool_calls
                finish = "tool_calls"
        else:
            message["content"] = text
        choices.append({"index": i, "message": message,
                        "finish_reason": finish})
    return chat_response(rid, model, choices, usage(
        handles[-1].prompt_tokens, sum(h.completion_tokens
                                       for h in handles)))


def _chat_stream(handle: GenHandle, rid: str, model: str, cfg,
                 tctx: Optional[inf.ToolContext]) -> Iterator[bytes]:
    """SSE frames. Plain chat streams deltas as they decode; with tools
    the text must be parsed whole, so the deltas are buffered and the
    final frames carry one ``tool_calls`` delta per call (or the
    content)."""
    finish = "stop"
    buffered: list[str] = []
    try:
        yield sse_event(chat_chunk(rid, model,
                                   {"role": "assistant", "content": ""}))
        for item in handle:
            if item.finish_reason is not None:
                finish = item.finish_reason
                break
            if not item.delta:
                continue
            if tctx is not None:
                buffered.append(item.delta)
            else:
                yield sse_event(chat_chunk(rid, model,
                                           {"content": item.delta}))
                mark_first_write(handle)
    except BaseException:
        handle.cancel()  # client went away: free the decode slot now
        raise
    if tctx is not None:
        text = finetune_result(cfg, "", "".join(buffered))
        content, tool_calls = inf.parse_tool_calls(text, tctx)
        if tool_calls:
            finish = "tool_calls"
            for tc in tool_calls:
                yield sse_event(chat_chunk(rid, model, {"tool_calls": [tc]}))
        elif content:
            yield sse_event(chat_chunk(rid, model, {"content": content}))
    yield sse_event(chat_chunk(
        rid, model, {}, finish_reason=finish,
        usage_dict=usage(handle.prompt_tokens, handle.completion_tokens)))
    yield SSE_DONE


def _chat_stream_n(handles: list[GenHandle], rid: str,
                   model: str) -> Iterator[bytes]:
    """``n`` > 1 plain-chat streaming: every choice decodes concurrently,
    interleaved on the one SSE stream by index; one usage frame for the
    request (prompt tokens counted once)."""
    try:
        for i in range(len(handles)):
            yield sse_event(chat_chunk(rid, model, {"role": "assistant",
                                                    "content": ""}, index=i))
        for i, item in _merged(handles):
            if item.finish_reason is not None:
                yield sse_event(chat_chunk(rid, model, {}, index=i,
                                           finish_reason=item.finish_reason))
            elif item.delta:
                yield sse_event(chat_chunk(rid, model,
                                           {"content": item.delta}, index=i))
                mark_first_write(handles[i])
    except BaseException:
        for h in handles:
            h.cancel()
        raise
    frame = chat_chunk(rid, model, {})
    frame["choices"] = []
    frame["usage"] = usage(handles[0].prompt_tokens,
                           sum(h.completion_tokens for h in handles))
    yield sse_event(frame)
    yield SSE_DONE


def _prompt_list(body: dict) -> list[str]:
    """``prompt`` as a list of strings (one string, or a list of them) of
    a body :func:`request_body` read."""
    raw = body.get("prompt")
    if isinstance(raw, list):
        return list(raw) or [""]
    return [raw or ""]


def completions(manager, body: dict):
    """POST /v1/completions → a response dict, or SSE frames. Each prompt
    of a list goes through the ``completion`` template and runs ``n``
    choices; choice ``p * n + i`` is prompt p's i-th."""
    body = request_body(body)
    sm, model = _serving(manager, body, "completion")
    inf.shed_check(model, getattr(sm, "scheduler", None))
    prompts = _prompt_list(body)
    stream = bool(body.get("stream"))
    _refuse_completion_constraints(body)
    n = _choices(body)
    templated = [build_completion_prompt(sm.templates, sm.config, p)
                 for p in prompts]
    rid = new_id("cmpl")
    if stream:
        handles = [sm.scheduler.submit(_gen_request(
            sm, body, prompt, stream, seed_offset=i, rid=rid))
            for prompt in templated for i in range(n)]
        return _completions_stream(handles, rid, model)
    choices = []
    prompt_total = completion_total = 0
    for raw, prompt in zip(prompts, templated):
        handles = [sm.scheduler.submit(_gen_request(
            sm, body, prompt, stream, seed_offset=i, rid=rid))
            for i in range(n)]
        _wait(manager, *handles)
        for h in handles:
            prompt_total += h.prompt_tokens
            completion_total += h.completion_tokens
            choices.append({"index": len(choices),
                            "text": finetune_result(
                                sm.config, raw, h.text,
                                echo=bool(body.get("echo"))),
                            "finish_reason": h.finish_reason or "stop"})
    return completion_response(rid, model, choices,
                               usage(prompt_total, completion_total))


def _completions_stream(handles: list[GenHandle], rid: str,
                        model: str) -> Iterator[bytes]:
    """Every choice streams concurrently on its own index."""
    try:
        for i, item in _merged(handles):
            h = handles[i]
            if item.finish_reason is not None:
                text, finish = "", item.finish_reason
            elif item.delta:
                text, finish = item.delta, None
            else:
                continue
            yield sse_event(completion_response(
                rid, model, [{"index": i, "text": text,
                              "finish_reason": finish}],
                usage(h.prompt_tokens, h.completion_tokens)))
            if finish is None:
                mark_first_write(h)
    except BaseException:
        for h in handles:
            h.cancel()
        raise
    yield SSE_DONE


def edits(manager, body: dict) -> dict:
    """POST /v1/edits: each input (``prompt``, a string or a list, as the
    JAX package reads it) goes through the ``edit`` template with
    ``instruction``; one choice each, ``object: "edit"``."""
    body = request_body(body)
    sm, model = _serving(manager, body, "edit")
    inf.shed_check(model, getattr(sm, "scheduler", None))
    inputs = _prompt_list(body)
    instruction = body.get("instruction") or ""
    rid = new_id("edit")
    choices = []
    ptotal = ctotal = 0
    for i, text_in in enumerate(inputs):
        prompt = build_edit_prompt(sm.templates, sm.config, text_in,
                                   instruction)
        h = sm.scheduler.submit(_gen_request(sm, body, prompt, False,
                                             rid=rid))
        _wait(manager, h)
        ptotal += h.prompt_tokens
        ctotal += h.completion_tokens
        choices.append({"index": i,
                        "text": finetune_result(sm.config, prompt, h.text),
                        "finish_reason": h.finish_reason or "stop"})
    return completion_response(rid, model, choices, usage(ptotal, ctotal),
                               object_name="edit")


def embeddings(manager, body: dict) -> dict:
    """POST /v1/embeddings: ``input`` is a string, a list of strings, one
    token array or a list of token arrays. A sentence encoder (``backend:
    bert-embeddings | sentencetransformers``) embeds the texts in one
    batched forward and refuses token arrays (they would carry another
    vocabulary's ids); any other model mean-pools each input through the
    LLM engine (``runner.embed``). On this request's thread."""
    body = request_body(body)
    raw = body.get("input")
    if raw is None:
        inputs = [""]
    elif isinstance(raw, str):
        inputs = [raw]
    elif isinstance(raw, list):
        inputs = list(raw) or [""]
        if all(isinstance(x, int) for x in inputs):
            inputs = [inputs]  # one tokenized input
    else:
        raise APIError(400, "input must be a string, a list of strings or "
                            "token arrays")
    name = _model_name(manager, body)
    # SLO admission control covers embeddings (the same engine capacity),
    # checked before any model load
    inf.shed_check(name)
    if manager.is_embedder(manager.loader.get(name)):
        if not all(isinstance(t, str) for t in inputs):
            raise APIError(400, "token-array input is not supported for "
                                "sentence-encoder backends; send text")
        try:
            em = manager.get_embedder(name)
        except FileNotFoundError as e:
            raise _load_failed(e) from None
        vecs, ptokens = em.embed(inputs)
        return embeddings_response(name, [[float(x) for x in v]
                                          for v in vecs], ptokens)
    sm, model = _serving(manager, {"model": name}, "embeddings")
    runner = _runner(sm, "embeddings")
    vocab = runner.cfg.vocab_size
    vectors, prompt_tokens = [], 0
    for item in inputs:
        if isinstance(item, list):
            toks = [int(t) for t in item]
            if not all(0 <= t < vocab for t in toks):
                raise APIError(400, f"token ids must lie in [0, {vocab})")
        else:
            toks = sm.tokenizer.encode(str(item), add_bos=True)
        prompt_tokens += len(toks)
        vectors.append([float(x) for x in runner.embed(toks)])
    return embeddings_response(model, vectors, prompt_tokens)


def list_models(manager, query: Optional[dict] = None) -> dict:
    """GET /v1/models; ``?filter=<regex>`` keeps the names it matches (an
    invalid regex filters nothing, as on the JAX package)."""
    names = manager.loader.names()
    flt = (query or {}).get("filter")
    if flt:
        try:
            rx = re.compile(flt)
            names = [n for n in names if rx.search(n)]
        except re.error:
            pass
    return models_response(names)


def readyz(manager) -> dict:
    return {"status": "ok",
            "models_configured": len(manager.loader.names()),
            "models_loaded": manager.loaded_names()}
