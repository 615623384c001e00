"""The transport-free half of the worker tier: the request options a
replica takes, the handle a reply stream feeds, and the stream reader.

Port of the parts of ``localai_tpu/worker/serving.py`` that fleets run
over in-process replicas (``fleet.replica.InProcessReplica``):

  * :class:`PredictOptions` — the JAX package's ``PredictOptions`` proto
    message as a dataclass with its field names; an optional field that
    is unset is ``None`` where the JAX package tests ``HasField``;
  * :class:`WorkerGenHandle` — a ``GenHandle`` fed from a reply stream
    instead of the engine thread, counting completion tokens from the
    final reply (or the streamed deltas when a replica died first);
  * :func:`predict_options` — GenRequest → options (the inverse of
    ``worker.server.gen_request_from_options``). A constraint crosses as
    its source regex only; a constraint without one decodes unconstrained
    inside the replica, with a warning, as on the JAX package;
  * :func:`consume_stream` — the one place a reply stream is read into a
    handle.

The gRPC worker process, its client and servicers wait for the port's own
transport (ROADMAP item 23, part 2).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest

log = logging.getLogger(__name__)

_SAMPLING_FIELDS = (
    "temperature", "top_k", "top_p", "min_p",
    "repeat_penalty", "presence_penalty", "frequency_penalty", "seed",
)


@dataclasses.dataclass
class PredictOptions:
    """``backend.proto``'s ``PredictOptions`` (field names and defaults;
    ``None`` = an unset optional field)."""

    prompt: str = ""
    tokens: list[int] = dataclasses.field(default_factory=list)
    max_tokens: int = 0
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repeat_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    seed: Optional[int] = None
    stop: list[str] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    logit_bias: dict[int, float] = dataclasses.field(default_factory=dict)
    constraint_schema: str = ""
    constraint_regex: str = ""
    correlation_id: str = ""
    add_bos: bool = False
    stream: bool = False


class WorkerGenHandle(GenHandle):
    """A GenHandle fed from a reply stream instead of the engine thread.
    Token ids do not cross the stream, so completion counts come from the
    final reply's usage fields, and when the stream dies before that final
    reply, from the count of streamed deltas (each reply carries at least
    one sampled token)."""

    def __init__(self, req: GenRequest, rid: int):
        super().__init__(req, rid)
        self._completion_override: Optional[int] = None
        self._streamed_deltas = 0

    @property
    def completion_tokens(self) -> int:
        if self._completion_override is not None:
            return self._completion_override
        return max(len(self.token_ids), self._streamed_deltas)


def predict_options(gr: GenRequest) -> PredictOptions:
    """GenRequest → options (inverse of ``gen_request_from_options``)."""
    opts = PredictOptions(
        tokens=list(gr.prompt),
        max_tokens=gr.max_new_tokens,
        stop=list(gr.stop),
        ignore_eos=gr.ignore_eos,
        correlation_id=gr.correlation_id,
        stream=gr.stream,
    )
    for f in _SAMPLING_FIELDS:
        v = getattr(gr, f)
        if v is not None:
            setattr(opts, f, v)
    if gr.logit_bias:
        for k, v in gr.logit_bias.items():
            opts.logit_bias[int(k)] = float(v)
    if gr.constraint is not None:
        regex = getattr(gr.constraint, "source_regex", None)
        if regex:
            opts.constraint_regex = regex
        else:
            log.warning(
                "constraint without a serializable source regex; the "
                "replica will decode unconstrained"
            )
    return opts


def consume_stream(handle: WorkerGenHandle, replies, *,
                   watchdog=None, channel: str = "",
                   tr=None) -> tuple[str, bool]:
    """Drain one reply iterator into ``handle``. Returns ``(finish,
    got_final)``: ``got_final=False`` means the stream ended without the
    final usage reply (the replica died mid-generation); the caller
    decides whether that is a failover signal."""
    finish = "stop"
    got_final = False
    for reply in replies:
        if watchdog is not None:
            watchdog.pulse(channel)
        if handle.cancelled:
            finish = "cancelled"
            got_final = True
            break
        if reply.finish_reason:
            finish = reply.finish_reason
            got_final = True
            handle._completion_override = reply.tokens or None
            if reply.prompt_tokens:
                handle.prompt_tokens = reply.prompt_tokens
            break
        if reply.message:
            if tr is not None and handle.t_first_token is None:
                tr.event("first_delta")
            handle._streamed_deltas += 1
            handle._emit(reply.message.decode("utf-8", "replace"), None)
    return finish, got_final
