"""Continuous-batching scheduler: the serving loop over ModelRunner.

A lean port of ``localai_tpu/engine/scheduler.py``. One engine thread:

  * admits queued requests into free slots by block reservation (a request
    the pool cannot cover yet waits, FIFO, until blocks free);
  * interleaves chunked prefill — one chunk per loop iteration — with
    pipelined multi-step decode dispatches (up to ``pipeline_depth`` in
    flight, each result's device→host copy started at dispatch);
  * bans the ids a padded model vocab has beyond the tokenizer's;
  * detokenizes incrementally, checks EOS / stop strings / max_tokens /
    context exhaustion, and releases the slot.

Left out of this slice (see ROADMAP): speculative decoding, the prompt
cache, grammar constraints, the background batch lane, SLO shedding,
telemetry and the self-healing supervisor.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np

from localai_tpu_torch.engine.runner import NAN_TOKEN, ModelRunner
from localai_tpu_torch.engine.stream import IncrementalDetokenizer, StopChecker

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GenRequest:
    """One generation request (the scheduler-facing request schema)."""

    prompt: list[int]
    max_new_tokens: int = 256
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repeat_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    seed: Optional[int] = None
    logit_bias: Optional[dict[int, float]] = None
    stop: Sequence[str] = ()
    # an SSE client is attached: the scheduler bounds delivery lag by
    # shrinking the per-dispatch step count while this request is active
    stream: bool = False


class StreamItem:
    """Stream element: text delta or end-of-stream marker."""

    __slots__ = ("delta", "token_id", "finish_reason")

    def __init__(self, delta: str, token_id: Optional[int],
                 finish_reason: Optional[str]):
        self.delta = delta
        self.token_id = token_id
        self.finish_reason = finish_reason


class GenHandle:
    """Per-request handle: iterate deltas (streaming) or join for the full
    result. Filled by the engine thread."""

    def __init__(self, req: GenRequest, rid: int):
        self.request = req
        self.id = rid
        self._q: "queue.Queue[StreamItem]" = queue.Queue()
        self.text = ""
        self.token_ids: list[int] = []
        self.finish_reason: Optional[str] = None
        self.prompt_tokens = len(req.prompt)
        self._done = threading.Event()
        self.cancelled = False

    # engine-thread side -------------------------------------------------
    def _emit(self, delta: str, token_id: Optional[int]) -> None:
        if token_id is not None:
            self.token_ids.append(token_id)
        if delta:
            self.text += delta
        if delta or token_id is not None:
            self._q.put(StreamItem(delta, token_id, None))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._q.put(StreamItem("", None, reason))
        self._done.set()

    # consumer side ------------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation; the engine releases the slot on next step."""
        self.cancelled = True

    def __iter__(self):
        while True:
            item = self._q.get()
            yield item
            if item.finish_reason is not None:
                return

    def result(self, timeout: Optional[float] = None) -> "GenHandle":
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        return self

    @property
    def completion_tokens(self) -> int:
        return len(self.token_ids)


@dataclasses.dataclass
class _PendingPrefill:
    """A chunked admission in flight (one chunk per engine iteration)."""

    slot: int
    handle: GenHandle
    adm: Any                 # engine.runner.PagedAdmission


@dataclasses.dataclass
class _SlotCtx:
    """Host-side state for one occupied slot."""

    handle: GenHandle
    detok: IncrementalDetokenizer
    stopper: StopChecker
    generated: int = 0
    admit_seq: int = 0       # dispatch counter at admit time: tokens from
                             # dispatches issued before admission are not ours


class Scheduler:
    """Owns one ModelRunner + tokenizer; runs the engine thread."""

    def __init__(self, runner: ModelRunner, tokenizer: Any,
                 *, default_max_tokens: int = 2048, pipeline_depth: int = 2,
                 multi_step: int = 16, stream_latency_target: float = 0.1):
        self.runner = runner
        self.tokenizer = tokenizer
        self.default_max_tokens = default_max_tokens
        self.pipeline_depth = max(1, pipeline_depth)
        # tokens decoded per dispatch; with an SSE stream attached the size
        # adapts down (powers of two) to keep steps x depth x step-time
        # under stream_latency_target seconds
        self.multi_step = max(1, multi_step)
        self.stream_latency_target = stream_latency_target
        self._step_ema: Optional[float] = None   # seconds per decoded token
        self._last_drain_t: Optional[float] = None
        self._seen_shapes: set = set()
        self._prefills: "deque[_PendingPrefill]" = deque()
        # a request the block pool couldn't cover yet (FIFO: it blocks the
        # queue until blocks free)
        self._held: Optional[GenHandle] = None
        self._pending: "queue.Queue[GenHandle]" = queue.Queue()
        self._slots: dict[int, _SlotCtx] = {}
        self._ids = itertools.count()
        self._wake = threading.Event()
        self._stopping = False
        self._lock = threading.Lock()
        self._dispatch_seq = 0
        self._thread = threading.Thread(target=self._run, name="engine",
                                        daemon=True)
        self._thread.start()

    # -- public API ------------------------------------------------------

    def submit(self, req: GenRequest) -> GenHandle:
        handle = GenHandle(req, next(self._ids))
        self._pending.put(handle)
        self._wake.set()
        return handle

    def generate(self, req: GenRequest, timeout: float = 600.0) -> GenHandle:
        return self.submit(req).result(timeout)

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stopping = True
        self._wake.set()
        self._thread.join(timeout)

    # -- engine thread ---------------------------------------------------

    def _run(self) -> None:
        # each entry: (tokens, dispatch seq, steps, pipelined, issue time,
        # first dispatch of its shape)
        inflight: deque[tuple[Any, int, int, bool, float, bool]] = deque()

        def drain_one() -> None:
            toks, seq, k, pipelined, t_issue, fresh = inflight.popleft()
            rows = np.asarray(toks)  # waits on the copy started at dispatch
            now = time.monotonic()
            # per-token timing for the adaptive streaming dispatch size: a
            # dispatch issued behind another in flight is measured from the
            # previous drain; the first dispatch of a shape is skipped
            dt = (now - self._last_drain_t
                  if pipelined and self._last_drain_t is not None
                  else now - t_issue)
            if not fresh and k > 0:
                self._observe_step_time(dt / k)
            self._last_drain_t = now
            if rows.ndim == 1:
                rows = rows[None]
            self._process_rows(rows, seq)

        while not self._stopping:
            admitted = self._admit_pending()
            chunked = self._step_prefill_chunk()
            if not self._slots:
                self._last_drain_t = None  # idle gap would pollute the EMA
                if inflight:
                    drain_one()
                    continue
                if self._prefills:
                    continue
                if not admitted and not chunked:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            try:
                steps = self._effective_steps()
                self._dispatch_seq += 1
                fresh = steps not in self._seen_shapes
                self._seen_shapes.add(steps)
                t_issue = time.monotonic()
                if steps > 1:
                    tokens = self.runner.step_n_async(steps)
                else:
                    tokens = self.runner.step_async()
                inflight.append((tokens, self._dispatch_seq, steps,
                                 bool(inflight), t_issue, fresh))
                if len(inflight) >= self.pipeline_depth:
                    drain_one()
            except Exception:  # noqa: BLE001 — engine must not die silently
                log.exception("decode step failed; failing active requests")
                inflight.clear()
                with self._lock:
                    failed = list(self._slots.items())
                    self._slots.clear()
                for slot, ctx in failed:
                    self.runner.release(slot)
                    ctx.handle._finish("error")

    def _observe_step_time(self, dt: float) -> None:
        if dt <= 0:
            return
        self._step_ema = (dt if self._step_ema is None
                          else 0.8 * self._step_ema + 0.2 * dt)

    def _effective_steps(self) -> int:
        """Tokens per dispatch: the full multi_step without a stream
        attached; with one, the largest power of two that keeps
        steps x pipeline_depth x step-time under the latency target
        (one step until the first timing sample)."""
        k = self.multi_step
        if k <= 1:
            return 1
        with self._lock:
            streaming = any(c.handle.request.stream
                            for c in self._slots.values())
        if not streaming:
            return k
        if self._step_ema is None:
            return 1
        budget = self.stream_latency_target / max(1, self.pipeline_depth)
        n = int(budget / self._step_ema) if self._step_ema > 0 else k
        p = 1
        while p * 2 <= min(n, k):
            p *= 2
        return p

    def _reservation_fits(self, req: GenRequest) -> bool:
        """Host-arithmetic estimate of whether ``req``'s block reservation
        could be allocated now (allocate() stays authoritative)."""
        alloc = self.runner.allocator
        reserve = min(self.runner.max_ctx,
                      len(req.prompt) + (req.max_new_tokens
                                         or self.default_max_tokens) + 1)
        need = alloc.blocks_for(reserve) - len(alloc.match_prefix(req.prompt))
        return alloc.stats().available >= need

    def _admit_pending(self) -> bool:
        admitted = False
        while self.runner.free_slots():
            if self._held is not None:
                if (not self._held.cancelled
                        and not self._reservation_fits(self._held.request)):
                    return admitted
                handle, self._held = self._held, None
            else:
                try:
                    handle = self._pending.get_nowait()
                except queue.Empty:
                    return admitted
            if handle.cancelled:
                handle._finish("cancelled")
                continue
            if not self._reservation_fits(handle.request):
                self._held = handle
                return admitted
            slot = self.runner.acquire_slot()
            try:
                if not self._start(slot, handle):
                    self.runner.release(slot)
                    self._held = handle
                    return admitted
                admitted = True
            except Exception as e:  # noqa: BLE001 — bad request ≠ dead engine
                log.warning("admit failed: %s", e)
                self.runner.release(slot)
                handle._finish("error")
        return admitted

    def _start(self, slot: int, handle: GenHandle) -> bool:
        """Reserve blocks and queue the chunked prefill of ``handle`` in
        ``slot``. False when the pool can't cover the reservation now."""
        req = handle.request
        base = self._padded_vocab_ban()
        if req.logit_bias:
            if base is None:
                base = np.zeros(self.runner.cfg.vocab_size, np.float32)
            # bound by the tokenizer vocab: a user bias must not resurrect
            # banned padded ids
            limit = min(base.shape[0],
                        getattr(self.tokenizer, "vocab_size", None)
                        or base.shape[0])
            for tid, b in req.logit_bias.items():
                if 0 <= int(tid) < limit:
                    base[int(tid)] = b
        # reserve the worst case so decode can never run out of blocks
        reserve = len(req.prompt) + (req.max_new_tokens
                                     or self.default_max_tokens) + 1
        adm = self.runner.begin_admit(
            slot, req.prompt, reserve_tokens=reserve,
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            min_p=req.min_p, repeat_penalty=req.repeat_penalty,
            presence_penalty=req.presence_penalty,
            frequency_penalty=req.frequency_penalty, seed=req.seed,
            bias_row=base)
        if adm is None:
            return False
        self._prefills.append(_PendingPrefill(slot=slot, handle=handle,
                                              adm=adm))
        return True

    def _step_prefill_chunk(self) -> bool:
        """Dispatch ONE pending prefill chunk (FIFO across admissions) and
        activate the slot on its final chunk. True if a chunk ran."""
        if not self._prefills:
            return False
        pf = self._prefills[0]
        if pf.handle.cancelled:
            self._prefills.popleft()
            pf.adm.abort()   # frees the blocks, slot returns to free list
            pf.handle._finish("cancelled")
            return True
        try:
            first = pf.adm.step_chunk()
        except Exception as e:  # noqa: BLE001 — fail this request only
            log.warning("prefill failed: %s", e)
            self._prefills.popleft()
            pf.adm.abort()
            pf.handle._finish("error")
            return True
        if first is None:
            return True
        self._prefills.popleft()
        ctx = _SlotCtx(
            handle=pf.handle,
            detok=IncrementalDetokenizer(self.tokenizer.decode),
            stopper=StopChecker(pf.handle.request.stop),
            admit_seq=self._dispatch_seq,
        )
        with self._lock:
            self._slots[pf.slot] = ctx
        self._consume(pf.slot, ctx, first)
        return True

    def _padded_vocab_ban(self) -> Optional[np.ndarray]:
        """Standing bias banning ids the tokenizer cannot produce (model
        vocabs are often padded wider than the tokenizer — the debug
        presets pad the 258-id byte tokenizer to 512). A fresh [V] row, or
        None when the vocabs agree."""
        tok_v = getattr(self.tokenizer, "vocab_size", None)
        V = self.runner.cfg.vocab_size
        if not tok_v or tok_v >= V:
            return None
        row = np.zeros(V, np.float32)
        row[tok_v:] = -1e30
        return row

    def _process_rows(self, rows: np.ndarray, seq: int) -> None:
        """Consume [steps, S] sampled rows in temporal order. The seq guard
        drops tokens of dispatches issued before a slot's admission; a slot
        released at row i ignores the rows after it."""
        for i in range(rows.shape[0]):
            for slot, ctx in list(self._slots.items()):
                if seq <= ctx.admit_seq:
                    continue
                tok = int(rows[i, slot])
                if tok == NAN_TOKEN:
                    # non-finite logits row: fail THIS request only
                    log.warning("slot %d: non-finite logits; failing its "
                                "request", slot)
                    self._release(slot, ctx, "error")
                    continue
                self._consume(slot, ctx, tok)

    def _consume(self, slot: int, ctx: _SlotCtx, token_id: int) -> None:
        """Handle one sampled token for one slot: stream, stop, release."""
        handle = ctx.handle
        req = handle.request
        if handle.cancelled:
            self._release(slot, ctx, "cancelled")
            return
        if token_id in getattr(self.tokenizer, "eos_ids", set()):
            handle._emit(ctx.stopper.flush(), None)
            self._release(slot, ctx, "stop")
            return
        ctx.generated += 1
        delta = ctx.detok.push(token_id)
        handle._emit(ctx.stopper.push(delta), token_id)
        if ctx.stopper.stopped is not None:
            self._release(slot, ctx, "stop")
            return
        limit = req.max_new_tokens or self.default_max_tokens
        if (ctx.generated >= limit
                or handle.prompt_tokens + ctx.generated
                >= self.runner.max_ctx - 1):
            # max_tokens, or context exhausted (no silent context shift)
            handle._emit(ctx.stopper.flush(), None)
            self._release(slot, ctx, "length")

    def _release(self, slot: int, ctx: _SlotCtx, reason: str) -> None:
        with self._lock:
            self._slots.pop(slot, None)
        self.runner.release(slot)
        ctx.handle._finish(reason)
