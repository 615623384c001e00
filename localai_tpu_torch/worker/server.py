"""Request options → engine request, the replica side of a dispatch.

Port of ``gen_request_from_options`` of ``localai_tpu/worker/server.py``,
the one converter every replica kind decodes a request with (in-process
replicas here; the gRPC servicer once the port has its own transport,
ROADMAP item 23 part 2).
"""

from __future__ import annotations

import json


def gen_request_from_options(req, sm, trace_id: str = "",
                             tenant: str = ""):
    """``worker.serving.PredictOptions`` → GenRequest against a serving
    model (the inverse of ``worker.serving.predict_options``)."""
    from localai_tpu_torch.engine.scheduler import GenRequest

    if req.tokens:
        prompt = list(req.tokens)
    else:
        prompt = sm.tokenizer.encode(req.prompt, add_bos=req.add_bos)
    constraint = None
    if req.constraint_schema:
        from localai_tpu_torch.functions.constraint import (
            constraint_for_schema,
        )

        constraint = constraint_for_schema(
            json.loads(req.constraint_schema), sm.tokenizer)
    elif req.constraint_regex:
        from localai_tpu_torch.functions.constraint import (
            constraint_for_regex,
        )

        constraint = constraint_for_regex(req.constraint_regex, sm.tokenizer)
    return GenRequest(
        prompt=prompt,
        max_new_tokens=req.max_tokens or 2048,
        temperature=req.temperature,
        top_k=req.top_k,
        top_p=req.top_p,
        min_p=req.min_p,
        repeat_penalty=req.repeat_penalty,
        presence_penalty=req.presence_penalty,
        frequency_penalty=req.frequency_penalty,
        seed=req.seed,
        logit_bias=dict(req.logit_bias) or None,
        stop=tuple(req.stop),
        ignore_eos=req.ignore_eos,
        constraint=constraint,
        correlation_id=req.correlation_id,
        # the engine's spans record under the front door's trace id
        trace_id=trace_id or req.correlation_id,
        # the hashed tenant bucket of the usage ledger; an in-process
        # replica's resubmit leaves it empty, so the fleet's front-door
        # request is the one the ledger counts
        tenant=tenant,
        stream=req.stream,
    )
