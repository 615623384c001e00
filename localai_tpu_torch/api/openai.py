"""OpenAI-compatible endpoints: chat completions, completions, models.

Port of the plain-text part of ``localai_tpu/api/openai.py`` (and the
response shapes of ``api/schema.py``), written as framework-free
functions over parsed JSON: ``api.server`` maps HTTP onto them. Response
JSON has the JAX package's shape — id, object, created, model, choices
with ``delta`` (stream) or ``message``, finish_reason, usage.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Iterator, Optional

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


def models_response(names: list[str]) -> dict:
    return {"object": "list",
            "data": [{"id": n, "object": "model", "owned_by": "localai-tpu"}
                     for n in names]}


def _serving(manager, body: dict):
    """(ServingModel, model name) for a request body: ``model`` or the
    first configured model."""
    name = body.get("model") or ""
    if not name:
        names = manager.loader.names()
        if not names:
            raise APIError(404, "no models configured")
        name = names[0]
    if manager.loader.get(name) is None:
        raise APIError(404, f"model {name!r} not found; available: "
                            f"{manager.loader.names()}")
    return manager.get(name), name


def _gen_request(sm, body: dict, prompt: str, stream: bool) -> GenRequest:
    """Request body over the model's YAML defaults → GenRequest."""
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
        stop=tuple(cfg.stopwords) + tuple(stops), stream=stream)


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
    frames when ``stream`` is set."""
    sm, model = _serving(manager, body)
    messages = body.get("messages")
    if not isinstance(messages, list):
        raise APIError(400, "messages must be a list")
    stream = bool(body.get("stream"))
    gr = _gen_request(sm, body, build_chat_prompt(sm.config, messages),
                      stream)
    rid = new_id("chatcmpl")
    h = sm.scheduler.submit(gr)
    if stream:
        return _chat_stream(h, rid, model)
    _wait(h)
    return {"id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": h.text},
                         "finish_reason": h.finish_reason or "stop"}],
            "usage": usage(h.prompt_tokens, h.completion_tokens)}


def _chat_stream(handle: GenHandle, rid: str, model: str) -> Iterator[bytes]:
    finish = "stop"
    try:
        yield sse_event(chat_chunk(rid, model,
                                   {"role": "assistant", "content": ""}))
        for item in handle:
            if item.finish_reason is not None:
                finish = item.finish_reason
                break
            if item.delta:
                yield sse_event(chat_chunk(rid, model,
                                           {"content": item.delta}))
    except BaseException:
        handle.cancel()  # client went away: free the decode slot now
        raise
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
    gr = _gen_request(sm, body, prompt, stream)
    rid = new_id("cmpl")
    h = sm.scheduler.submit(gr)
    if stream:
        return _completions_stream(h, rid, model)
    _wait(h)
    return completion_response(
        rid, model, [{"index": 0, "text": h.text,
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


def list_models(manager) -> dict:
    return models_response(manager.loader.names())


def readyz(manager) -> dict:
    return {"status": "ok",
            "models_configured": len(manager.loader.names()),
            "models_loaded": manager.loaded_names()}
