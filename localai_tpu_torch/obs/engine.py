"""EngineTelemetry: the scheduler-facing facade of the obs subsystem.

Turns request lifecycle events into spans (queued → prefill → decode, with
``admitted``/``drained`` markers), per-request histogram observations
(queue wait, TTFT, TPOT), one SLO event per finished request
(``obs.slo``) and one usage-ledger entry per finished request that carries
a tenant (``obs.ledger``), as ``localai_tpu/obs/engine.py`` does.
Everything runs on host timestamps the scheduler already holds (the
handle's ``t_submit`` / ``t_first_token`` / ``t_done``): no device read,
no synchronisation.

One instance per scheduler (the manager names it after the model).
"""

from __future__ import annotations

import time
from typing import Any, Optional

from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.obs import slo as obs_slo
from localai_tpu_torch.obs.metrics import REGISTRY, Registry
from localai_tpu_torch.obs.trace import STORE, RequestTrace, TraceStore

# finish reasons that mean the request left its slot early
PREEMPT_REASONS = ("cancelled", "error")
# finish reasons the SLO observatory counts: natural completions plus
# backend errors (a cancel is a client action, not a serving outcome;
# shed requests never reach a slot at all)
SLO_REASONS = ("stop", "length", "error")


class EngineTelemetry:
    def __init__(self, model: str = "", *,
                 registry: Optional[Registry] = None,
                 store: Optional[TraceStore] = None,
                 slo: Optional[obs_slo.SLOTracker] = None):
        self.model = model
        self.registry = registry or REGISTRY
        self.store = store or STORE
        self.slo = slo or obs_slo.SLO
        # the ledger's KV-block-seconds unit: the scheduler sets it from a
        # paged runner's block size (16 otherwise, the JAX package's)
        self.kv_block_tokens = 16

    # -- request lifecycle ------------------------------------------------

    def queued(self, handle: Any) -> RequestTrace:
        """Called at submit(); returns the trace the scheduler attaches to
        the handle."""
        req = handle.request
        tid = (getattr(req, "trace_id", "") or req.correlation_id
               or f"req-{self.model or 'engine'}-{handle.id}")
        tr = RequestTrace(
            tid, f"{self.model or 'engine'}-{handle.id}", model=self.model,
            prompt_tokens=handle.prompt_tokens,
        )
        tr.begin("queued")
        self.store.start(tr)
        return tr

    def admitted(self, tr: Optional[RequestTrace], *, slot: int,
                 queue_wait: float, background: bool = False) -> None:
        """``background`` marks a batch-lane request: it waits in the
        queue by design (admitted only when the interactive lane is
        empty), so its queue wait stays out of the interactive latency
        histogram; its trace still records it."""
        if tr is None:
            return
        tr.end("queued", seconds=round(queue_wait, 6))
        tr.event("admitted", slot=slot)
        tr.begin("prefill", slot=slot)
        tr.annotate(queue_wait_ms=round(queue_wait * 1e3, 3))
        if not background:
            self.registry.queue_wait.observe(queue_wait, model=self.model)

    def prefill_done(self, tr: Optional[RequestTrace], *, path: str = "",
                     prefix_reused: int = 0) -> None:
        if tr is None:
            return
        tr.end("prefill", path=path, prefix_reused=prefix_reused)
        tr.begin("decode")

    def finished(self, tr: Optional[RequestTrace], handle: Any,
                 reason: str, preempted: Optional[bool] = None) -> None:
        """Terminal event for every path: natural stop, length, cancel,
        admit failure, engine error. Derives TTFT/TPOT from the handle's
        host-side timing mirror and retires the trace. ``preempted`` marks
        a request that left a decode slot before natural completion;
        it defaults from the reason, but a request cancelled while still
        queued passes False (queue abandonment is not slot churn).

        Background batch-lane requests (``request.priority > 0``) never
        become SLO events and stay out of the TTFT/TPOT histograms: a batch
        line queues behind all interactive work by design, so counting it
        would let an offline job trip shedding of the interactive traffic
        the lane exists to protect. Request and preemption counters,
        traces and the ledger (lane ``batch``) still record them."""
        if tr is None:
            return
        background = getattr(getattr(handle, "request", None),
                             "priority", 0) > 0
        n = handle.completion_tokens
        ttft = tpot = None
        if handle.t_first_token is not None:
            ttft = handle.t_first_token - handle.t_submit
            t_end = handle.t_done or time.monotonic()
            if n > 1:
                tpot = (t_end - handle.t_first_token) / (n - 1)
        tr.end("decode", tokens=n)
        tr.event("drained", finish_reason=reason)
        tr.annotate(
            finish_reason=reason,
            completion_tokens=n,
            ttft_ms=None if ttft is None else round(ttft * 1e3, 3),
            tpot_ms=None if tpot is None else round(tpot * 1e3, 3),
            tokens_per_second=round(handle.tokens_per_second, 3),
        )
        if ttft is not None and not background:
            self.registry.ttft.observe(ttft, model=self.model)
        if tpot is not None and not background:
            self.registry.tpot.observe(tpot, model=self.model)
        self.registry.requests.inc(model=self.model, finish_reason=reason)
        if preempted is None:
            preempted = reason in PREEMPT_REASONS
        if preempted:
            self.registry.preemptions.inc(model=self.model, reason=reason)
        # usage accounting (obs.ledger), gated on the request's tenant
        # stamp: a direct scheduler submit stays unattributed
        tenant = getattr(getattr(handle, "request", None), "tenant", "")
        if tenant:
            t_end = handle.t_done or time.monotonic()
            queue_wait_ms = tr.attrs.get("queue_wait_ms") or 0.0
            service_s = max(
                0.0, (t_end - handle.t_submit) - queue_wait_ms / 1e3)
            ledger_reason = reason
            if reason == "error" and getattr(handle, "nan_poisoned", False):
                ledger_reason = "nan_quarantine"
            obs_ledger.LEDGER.note_request(
                tenant=tenant,
                model=self.model or "engine",
                lane="batch" if background else "interactive",
                reason=ledger_reason,
                tokens=n,
                prompt_tokens=handle.prompt_tokens,
                dispatch_ms=service_s * 1e3,
                queue_wait_ms=queue_wait_ms,
                kv_block_s=obs_ledger.kv_block_seconds(
                    handle.prompt_tokens, n, service_s,
                    self.kv_block_tokens),
            )
        if reason in SLO_REASONS and not background:
            t_end = handle.t_done or time.monotonic()
            self.slo.observe(
                self.model or "engine",
                ttft_ms=None if ttft is None else ttft * 1e3,
                tpot_ms=None if tpot is None else tpot * 1e3,
                e2e_ms=(t_end - handle.t_submit) * 1e3,
                queue_ms=tr.attrs.get("queue_wait_ms"),
                error=(reason == "error"),
            )
        self.store.finish(tr)
