"""OpenAI-compatible endpoints: chat completions, completions,
embeddings, models.

Port of the plain-text part of ``localai_tpu/api/openai.py`` (and the
response shapes of ``api/schema.py``), written as framework-free
functions over parsed JSON: ``api.server`` maps HTTP onto them. Response
JSON has the JAX package's shape — id, object, created, model, choices
with ``delta`` (stream) or ``message``, finish_reason, usage; embeddings
as a list of ``embedding`` objects. Non-streamed choices go through the
model's text shaping (:func:`finetune_result`). Chat completions serve
constrained decoding as the JAX package does (``api.inference``): tools
and legacy functions under every ``tool_choice``, answered with
``tool_calls``, and ``response_format`` ``json_object`` /
``json_schema``. A raw ``grammar`` string is refused with a 400 (the JAX
package reads it nowhere), and so are tools and a non-text
``response_format`` on ``/v1/completions``, which the JAX package ignores
there: a silent no-op would serve something else than was asked for.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from typing import Any, Iterator, Optional

from localai_tpu_torch.api import inference as inf
from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.templates.chat import build_chat_prompt

SSE_DONE = b"data: [DONE]\n\n"
REQUEST_TIMEOUT_S = 600.0


class APIError(Exception):
    """An error the server reports as ``{"error": ...}`` with a status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def sse_event(payload: Any) -> bytes:
    """One ``data: {json}`` SSE frame."""
    return b"data: " + json.dumps(
        payload, separators=(",", ":"), ensure_ascii=False
    ).encode("utf-8") + b"\n\n"


def new_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chat_chunk(rid: str, model: str, delta: dict, *,
               finish_reason: Optional[str] = None,
               usage_dict: Optional[dict] = None) -> dict:
    out = {"id": rid, "object": "chat.completion.chunk",
           "created": int(time.time()), "model": model,
           "choices": [{"index": 0, "delta": delta,
                        "finish_reason": finish_reason}]}
    if usage_dict is not None:
        out["usage"] = usage_dict
    return out


def completion_response(rid: str, model: str, choices: list[dict],
                        usage_dict: dict) -> dict:
    return {"id": rid, "object": "text_completion",
            "created": int(time.time()),
            "model": model, "choices": choices, "usage": usage_dict}


def embeddings_response(model: str, vectors: list[list[float]],
                        prompt_tokens: int) -> dict:
    return {"object": "list", "model": model,
            "data": [{"object": "embedding", "index": i, "embedding": v}
                     for i, v in enumerate(vectors)],
            "usage": usage(prompt_tokens, 0)}


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
    return manager.get(name), name


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


def _gen_request(sm, body: dict, prompt: str, stream: bool,
                 constraint=None) -> GenRequest:
    """Request body over the model's YAML defaults → GenRequest."""
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
    if int(body.get("n") or 1) != 1:
        raise APIError(400, "n > 1 is not supported yet")
    return GenRequest(
        prompt=sm.tokenizer.encode(prompt, add_bos=True),
        max_new_tokens=p.max_tokens or 2048,
        temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
        min_p=p.min_p, repeat_penalty=p.repeat_penalty,
        presence_penalty=p.presence_penalty,
        frequency_penalty=p.frequency_penalty, seed=p.seed,
        logit_bias=logit_bias,
        stop=tuple(cfg.stopwords) + tuple(stops), constraint=constraint,
        stream=stream)


def _wait(handle: GenHandle) -> None:
    """Join a generation; on timeout cancel it (the slot frees on the next
    engine step). A handle that failed with no output is a backend failure
    (502), not an empty completion."""
    try:
        handle.result(REQUEST_TIMEOUT_S)
    except TimeoutError:
        handle.cancel()
        raise APIError(504, "generation exceeded the request deadline "
                            "and was cancelled") from None
    if handle.finish_reason == "error" and not handle.text:
        raise APIError(502, "generation failed in the backend")


def chat(manager, body: dict):
    """POST /v1/chat/completions → a response dict, or an iterator of SSE
    frames when ``stream`` is set. Tools (``api.inference.prepare_tools``)
    or a JSON ``response_format`` attach a grammar constraint to the
    request; a tools answer is parsed into ``tool_calls``."""
    sm, model = _serving(manager, body)
    messages = body.get("messages")
    if not isinstance(messages, list):
        raise APIError(400, "messages must be a list")
    stream = bool(body.get("stream"))
    try:
        tctx = inf.prepare_tools(sm, body)
    except inf.ToolGrammarError as e:
        raise APIError(400, str(e)) from e
    constraint = (tctx.constraint if tctx is not None
                  else inf.response_format_constraint(sm, body))
    prompt = build_chat_prompt(
        sm.config, messages,
        functions=tctx.functions if tctx else None,
        use_function_template=tctx is not None,
        grammar_active=tctx is not None and tctx.constraint is not None)
    gr = _gen_request(sm, body, prompt, stream, constraint)
    rid = new_id("chatcmpl")
    h = sm.scheduler.submit(gr)
    if stream:
        return _chat_stream(h, rid, model, sm.config, tctx)
    _wait(h)
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
    return {"id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0, "message": message,
                         "finish_reason": finish}],
            "usage": usage(h.prompt_tokens, h.completion_tokens)}


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


def completions(manager, body: dict):
    """POST /v1/completions → a response dict, or SSE frames."""
    sm, model = _serving(manager, body)
    prompt = body.get("prompt", "")
    if not isinstance(prompt, str):
        raise APIError(400, "prompt must be a string (lists are not "
                            "supported yet)")
    stream = bool(body.get("stream"))
    _refuse_completion_constraints(body)
    gr = _gen_request(sm, body, prompt, stream)
    rid = new_id("cmpl")
    h = sm.scheduler.submit(gr)
    if stream:
        return _completions_stream(h, rid, model)
    _wait(h)
    text = finetune_result(sm.config, prompt, h.text,
                           echo=bool(body.get("echo")))
    return completion_response(
        rid, model, [{"index": 0, "text": text,
                      "finish_reason": h.finish_reason or "stop"}],
        usage(h.prompt_tokens, h.completion_tokens))


def _completions_stream(handle: GenHandle, rid: str,
                        model: str) -> Iterator[bytes]:
    finish = "stop"
    try:
        for item in handle:
            if item.finish_reason is not None:
                finish = item.finish_reason
                break
            if item.delta:
                yield sse_event(completion_response(
                    rid, model, [{"index": 0, "text": item.delta,
                                  "finish_reason": None}],
                    usage(handle.prompt_tokens, handle.completion_tokens)))
    except BaseException:
        handle.cancel()
        raise
    yield sse_event(completion_response(
        rid, model, [{"index": 0, "text": "", "finish_reason": finish}],
        usage(handle.prompt_tokens, handle.completion_tokens)))
    yield SSE_DONE


def embeddings(manager, body: dict) -> dict:
    """POST /v1/embeddings: ``input`` is a string, a list of strings, one
    token array or a list of token arrays; each input is mean-pooled
    through the LLM engine (``runner.embed``), on this request's thread."""
    sm, model = _serving(manager, body, "embeddings")
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
    vocab = sm.runner.cfg.vocab_size
    vectors, prompt_tokens = [], 0
    for item in inputs:
        if isinstance(item, list):
            toks = [int(t) for t in item]
            if not all(0 <= t < vocab for t in toks):
                raise APIError(400, f"token ids must lie in [0, {vocab})")
        else:
            toks = sm.tokenizer.encode(str(item), add_bos=True)
        prompt_tokens += len(toks)
        vectors.append([float(x) for x in sm.runner.embed(toks)])
    return embeddings_response(model, vectors, prompt_tokens)


def list_models(manager) -> dict:
    return models_response(manager.loader.names())


def readyz(manager) -> dict:
    return {"status": "ok",
            "models_configured": len(manager.loader.names()),
            "models_loaded": manager.loaded_names()}
