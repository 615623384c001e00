"""Continuous-batching scheduler: the serving loop over ModelRunner.

A lean port of ``localai_tpu/engine/scheduler.py``. One engine thread:

  * admits queued requests into free slots: on a paged runner by block
    reservation (a request the pool cannot cover yet waits, FIFO, until
    blocks free) and chunked prefill — one chunk per loop iteration; on a
    contiguous runner in one prefill dispatch into the free slot whose
    resident tokens share the longest reusable prefix with the prompt;
  * interleaves those prefills with pipelined multi-step decode
    dispatches (up to ``pipeline_depth`` in flight, each result's
    device→host copy started at dispatch);
  * with a speculative engine (``spec``, a
    :class:`localai_tpu_torch.spec.SpecEngine`), dispatches verify
    windows of gamma+1 tokens a slot instead of plain multi-step decode
    whenever the drafter has a proposal, and falls back to plain decode
    when it declines or its acceptance backoff suppresses windows;
  * drives grammar constraints (``GenRequest.constraint``, a
    :class:`TokenConstraint`): the constraint's mask is composed into the
    slot's bias row at admission, so the first token is already
    constrained, and refreshed after every token. While a constrained
    slot is live the pipeline is drained and decode goes synchronous: one
    ``step()`` when every live slot is constrained, else
    ``step_frozen_n``, where the constrained slots take one token and the
    others the full dispatch. No verify window runs then; windows resume
    (after a drafter resync) once no constrained slot is live;
  * bans the ids a padded model vocab has beyond the tokenizer's;
  * passes a multimodal request's image rows (``GenRequest.mm_embeds`` /
    ``mm_positions``) to its admission; such a slot keeps no resident
    token record, so its KV is never reused and no verify window runs
    while it is live (its drafts could not be resynced);
  * detokenizes incrementally, checks EOS / stop strings / max_tokens /
    context exhaustion, and releases the slot;
  * with a disk prompt cache (``prompt_cache``, an
    ``engine.promptcache.PromptKVCache``): at admission the entry sharing
    the longest prefix with the prompt is scored by the runner's
    ``reusable_prefix`` and loaded into the slot when it beats the slot's
    own resident prefix (never for a multimodal prompt); a request that
    ends with stop or length stores its prompt's KV rows (with
    ``prompt_cache_all`` its generation's too) through a writer thread:
    the engine thread only takes a device snapshot;
  * feeds the request lifecycle to ``obs.EngineTelemetry`` (queued at
    submit, admitted, prefill done, finished at every release, error and
    cancel) from host fields of the handle, and answers ``metrics()`` in
    the JAX package's keys and shapes;
  * writes one flight-ring record (``obs.flight``) at every drain point —
    the pipelined drain, the constrained lane's synchronous dispatch, each
    speculative window and each prefill chunk — with its dispatch-anatomy
    phases (``obs.anatomy``: gap, sched, launch, sync), feeds measured
    dispatch latency to the program catalog (``obs.compile``) and rejected
    draft tokens to the usage ledger, guards its drain with the stall
    watchdog (channel ``engine:<model>``) and shares the watchdog with its
    runner (channel ``device``); the API counts SLO refusals through
    :meth:`Scheduler.note_shed`;
  * admits on two lanes: interactive requests first, background batch
    requests (``GenRequest.priority`` ``PRIORITY_BATCH``, the batch
    executor's lines) only when no interactive request is queued; a held
    batch request goes back to its own lane, so it never blocks an
    interactive admission;
  * guards every decode row for non-finite logits: a poisoned row
    (``NAN_TOKEN``) fails only its own request and holds its slot out of
    admission for ``LOCALAI_NAN_QUARANTINE_DISPATCHES`` dispatches
    (default 16) while the co-batched streams go on;
  * heals itself under ``faults.EngineSupervisor``: :meth:`rebuild` fences
    the wedged engine thread off (an epoch it checks after every drain and
    before every launch), fails the requests holding engine state, has
    the runner allocate fresh device state, probes it from an abandonable
    thread and starts a new engine thread on the queued requests;
    :meth:`mark_failed` latches the failed state, after which ``submit``
    fails fast;
  * hosts the fault sites ``engine.dispatch``, ``engine.drain`` and
    ``decode.nan`` (behind the one ``faults.ACTIVE`` boolean) and, under
    ``LOCALAI_KV_CHECK=1``, sweeps the block allocator's invariants at
    every drain (``kv_invariant_violations``).

Under a fleet (``fleet.serving``) each in-process replica is one
scheduler: its release exports a migrating request's prompt + generation
KV (``GenHandle.migrate_export``), and a replica's in-memory prefix cache
fronts a configured disk cache (``attach_prompt_cache(layer=True)``).
With a host KV tier attached to the block allocator, ``metrics()``
reports the ``kv_tier_*`` keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Optional, Protocol, Sequence

import numpy as np

from localai_tpu_torch.engine.runner import NAN_TOKEN, ModelRunner
from localai_tpu_torch.engine.stream import IncrementalDetokenizer, StopChecker
from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.obs import anatomy as obs_anatomy
from localai_tpu_torch.obs import compile as obs_compile
from localai_tpu_torch.obs import flight as obs_flight
from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.obs import profiler as obs_profiler
from localai_tpu_torch.obs import watchdog as obs_watchdog
from localai_tpu_torch.obs.engine import EngineTelemetry

log = logging.getLogger(__name__)


class _EngineAbandoned(Exception):
    """Raised inside a fenced-off engine thread (a rebuild bumped the
    epoch while it sat in a blocked round-trip): exit without touching
    the rebuilt engine's state."""


# admission lanes: interactive requests (a client waiting) are admitted
# strictly before background batch work — a batch line fills a slot only
# when no interactive request is queued
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1


class TokenConstraint(Protocol):
    """Grammar/JSON-schema constraint driven by the scheduler.

    ``allowed_mask`` returns a [V] f32 additive bias row (0 allowed, -1e30
    disallowed) or None for "anything"; ``advance`` consumes the sampled
    token; ``done`` means the constrained region is complete.
    """

    def allowed_mask(self) -> Optional[np.ndarray]: ...
    def advance(self, token_id: int) -> None: ...
    @property
    def done(self) -> bool: ...


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
    constraint: Optional[TokenConstraint] = None
    ignore_eos: bool = False            # decode past EOS to max_new_tokens
    # an SSE client is attached: the scheduler bounds delivery lag by
    # shrinking the per-dispatch step count while this request is active
    stream: bool = False
    # multimodal injection: image-embedding rows [n_mm, D] scattered over
    # placeholder token positions [n_mm] during prefill (see ModelRunner)
    mm_embeds: Optional[Any] = None
    mm_positions: Optional[Any] = None
    # the request's X-Correlation-ID (else its response id) and the trace
    # id its HTTP span carries: the engine's spans group under the latter
    correlation_id: str = ""
    trace_id: str = ""
    # usage accounting (obs.ledger): the derive_tenant() bucket of the
    # request's API key, stamped by the server's auth check; "" leaves the
    # request out of the ledger
    tenant: str = ""
    # admission lane: PRIORITY_BATCH requests queue on the background lane
    # and are admitted only when the interactive lane is empty
    priority: int = PRIORITY_INTERACTIVE


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
        # host timing mirror (telemetry, the busy watchdog's clock)
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # lifecycle trace (obs.RequestTrace), attached by the scheduler
        self.trace = None
        # live-migration export flag (fleet.kveconomy): a migration
        # cancels the request but still needs its prompt + generation KV
        # snapshotted into the prompt cache at release; set by the
        # replica's migrate_out before cancel()
        self.migrate_export = False
        # NaN-guard receipt: set by Scheduler._poisoned just before the
        # error release, so the ledger classifies the waste as
        # nan_quarantine instead of a generic error
        self.nan_poisoned = False
        # global admission order (the engine thread stamps it at admit):
        # lane-ordering tests and forensics read it; None until admitted
        self.admit_index: Optional[int] = None

    # engine-thread side -------------------------------------------------
    def _emit(self, delta: str, token_id: Optional[int]) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
        if token_id is not None:
            self.token_ids.append(token_id)
        if delta:
            self.text += delta
        if delta or token_id is not None:
            self._q.put(StreamItem(delta, token_id, None))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.t_done = time.monotonic()
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

    @property
    def tokens_per_second(self) -> float:
        if self.t_first_token is None:
            return 0.0
        end = self.t_done or time.monotonic()
        dt = end - self.t_first_token
        return (len(self.token_ids) - 1) / dt if dt > 0 else 0.0


@dataclasses.dataclass
class _PendingPrefill:
    """A chunked admission in flight (one chunk per engine iteration)."""

    slot: int
    handle: GenHandle
    adm: Any                 # engine.runner.PagedAdmission
    base: Optional[np.ndarray] = None   # the slot's [V] bias w/o a mask
    mask_set: bool = False


@dataclasses.dataclass
class _SlotCtx:
    """Host-side state for one occupied slot."""

    handle: GenHandle
    detok: IncrementalDetokenizer
    stopper: StopChecker
    generated: int = 0
    base_bias: Optional[np.ndarray] = None  # [V] row from logit_bias and
                                            # the padded-vocab ban
    mask_set: bool = False   # a constraint mask is currently on the device
    admit_seq: int = 0       # dispatch counter at admit time: tokens from
                             # dispatches issued before admission are not ours


class Scheduler:
    """Owns one ModelRunner + tokenizer; runs the engine thread."""

    def __init__(self, runner: ModelRunner, tokenizer: Any,
                 *, default_max_tokens: int = 2048, pipeline_depth: int = 2,
                 multi_step: int = 16, stream_latency_target: float = 0.1,
                 spec: Optional[Any] = None,
                 prompt_cache: Optional[Any] = None,
                 prompt_cache_all: bool = False,
                 telemetry: Optional[EngineTelemetry] = None,
                 watchdog: Optional[obs_watchdog.Watchdog] = None,
                 flight: Optional[obs_flight.FlightRecorder] = None):
        self.runner = runner
        self.tokenizer = tokenizer
        # request lifecycle → spans + latency histograms (host fields only)
        self.telemetry = telemetry or EngineTelemetry()
        # the ledger's KV-block-seconds unit follows a paged runner's block
        self.telemetry.kv_block_tokens = getattr(runner, "block_tokens", 16)
        # stall watchdog: the drain here and the runner's blocking syncs
        # are heartbeat-guarded (channels "engine:<model>" and "device")
        self.watchdog = watchdog or obs_watchdog.WATCHDOG
        runner.watchdog = self.watchdog
        self._wd_channel = (f"engine:{self.telemetry.model}"
                            if self.telemetry.model else "engine")
        self.watchdog.start()
        # flight recorder: one record per drain, host mirrors only
        self.flight = (flight if flight is not None
                       else obs_flight.FlightRecorder())
        self._tokens_emitted = 0      # host token counter (_consume)
        self._flight_mark = 0         # emitted count at the last record
        self.watchdog.add_context(f"flight:{self._wd_channel}",
                                  self._flight_forensics)
        # anomaly profiler: the ring is watched (weakly) for step-time p99
        # regressions — a dict insert unless LOCALAI_PROFILE_ON_ANOMALY
        # armed the manager
        obs_profiler.PROFILER.watch_flight(
            self.telemetry.model or "engine", self.flight)
        # dispatch-anatomy accumulators (obs.anatomy): measured host-phase
        # seconds since the last flight record, taken and reset by
        # _take_anat(). Engine thread only.
        self._anat_sched_s = 0.0    # admit/select/host-mirror spans
        self._anat_launch_s = 0.0   # eager runner call-return spans
        self._anat_overlap_s = 0.0  # wall other records already account
        # requests refused by SLO admission control (the API's 429s): a
        # mirror for metrics(); localai_requests_shed_total is obs.slo's
        self.shed_total = 0
        # lifetime counters of metrics(), written on the engine thread
        # under _lock
        self.total_prompt_tokens = 0
        self.total_generated_tokens = 0
        self.total_preemptions = 0    # cancelled / engine-error slot exits
        self.total_prefill_chunks = 0
        # the disk prompt KV cache: stores run on the writer thread (the
        # host copy and the npz write), the engine thread only enqueues a
        # device snapshot
        self.prompt_cache = None
        self.prompt_cache_all = prompt_cache_all
        self._pc_queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._pc_thread: Optional[threading.Thread] = None
        # seconds in the admit-time lookup (index scan + npz read), in
        # load_prefix, and on the writer thread (host copy + npz write)
        self.pc_seconds = {"lookup_s": 0.0, "load_s": 0.0, "store_s": 0.0}
        self.attach_prompt_cache(prompt_cache)
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
        # paged runners admit chunk by chunk; contiguous ones in one shot
        self._chunked = runner.paged
        self._prefills: "deque[_PendingPrefill]" = deque()
        # each slot's prompt + generated tokens (engine thread only): the
        # record contiguous prefix reuse is scored against and drafters
        # are seeded from; None for a multimodal slot
        self._resident: dict[int, Optional[list[int]]] = {}
        # speculative decoding: slot operations route through the spec
        # engine so the drafter mirrors the target. After any plain
        # dispatch the drafts are stale (_spec_dirty: resync every slot
        # before the next window); a chunked admission bypasses
        # spec.admit, so its slot alone is resynced (_spec_stale)
        self.spec = spec
        self._spec_dirty = False
        self._spec_stale: set[int] = set()
        self._engine = spec if spec is not None else runner
        self.last_dispatch_steps = 0
        # host cost of constrained decoding: seconds spent advancing
        # constraints, looking up mask rows and writing bias rows, and the
        # constrained tokens it was spent on
        self.constraint_host_s = 0.0
        self.constrained_tokens = 0
        # a request the block pool couldn't cover yet (FIFO: it blocks the
        # queue until blocks free)
        self._held: Optional[GenHandle] = None
        # two-lane admission: interactive requests drain strictly before
        # the background batch lane (see _next_pending)
        self._pending: "queue.Queue[GenHandle]" = queue.Queue()
        self._pending_batch: "queue.Queue[GenHandle]" = queue.Queue()
        self._admit_seq = 0
        self._slots: dict[int, _SlotCtx] = {}
        self._ids = itertools.count()
        self._wake = threading.Event()
        self._stopping = False
        self._lock = threading.Lock()
        self._dispatch_seq = 0
        # self-healing (faults.supervisor): rebuild() bumps _epoch so a
        # wedged engine thread — parked in a round-trip that may never
        # return — is fenced off and exits when it unblocks, while a fresh
        # thread takes over the runner's fresh state. rebuild() and
        # mark_failed() run only on the supervisor's single recovery
        # thread, the sole owner of the engine structures while the fenced
        # thread is parked. failed latches after the supervisor exhausts
        # its rebuild budget: submit() then fails fast and the manager's
        # dead-engine reload takes over.
        self._epoch = 0
        self.failed = False
        self.rebuilds = 0
        self.supervisor = None          # set by EngineSupervisor
        # the last rebuild's wall and its probe's (seconds)
        self.last_rebuild_s: Optional[float] = None
        self.last_probe_s: Optional[float] = None
        # NaN/inf decode guard: a slot whose logits row went non-finite
        # fails only its own request and is held out of admission for a
        # fixed number of dispatches (localai_nan_rows_total counts them)
        self._quarantined: dict[int, int] = {}  # slot -> release dispatch
        # each released slot's hold: (slot, dispatch sequence when it was
        # poisoned, when it was released)
        self.quarantine_log: deque = deque(maxlen=64)
        self.nan_rows = 0
        try:
            self._nan_quarantine = int(os.environ.get(
                "LOCALAI_NAN_QUARANTINE_DISPATCHES", "16") or 16)
        except ValueError:
            self._nan_quarantine = 16
        # block-leak invariant sweep (BlockAllocator.check_invariants) at
        # every drain — debug runs and fault drills only; a drill may turn
        # it on for a live engine
        self.kv_check = os.environ.get("LOCALAI_KV_CHECK", "") == "1"
        self.kv_invariant_violations = 0
        self._thread = threading.Thread(target=self._run, args=(0,),
                                        name="engine", daemon=True)
        self._thread.start()

    # -- public API ------------------------------------------------------

    def submit(self, req: GenRequest) -> GenHandle:
        handle = GenHandle(req, next(self._ids))
        handle.trace = self.telemetry.queued(handle)
        # the failed check and the enqueue are one step against
        # mark_failed(), which flips the flag under the same lock before
        # draining: a handle reaches a queue only while that drain is
        # still obliged to pop it
        with self._lock:
            rejected = self.failed
            if not rejected:
                lane = (self._pending_batch
                        if req.priority >= PRIORITY_BATCH
                        else self._pending)
                lane.put(handle)
        if rejected:
            # the supervisor exhausted its rebuild budget: a clean, instant
            # error instead of a queue on a dead engine
            self._fail_handle(handle, preempted=False)
            return handle
        self._wake.set()
        return handle

    def generate(self, req: GenRequest, timeout: float = 600.0) -> GenHandle:
        return self.submit(req).result(timeout)

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stopping = True
        self._wake.set()
        if self.supervisor is not None:
            self.supervisor.detach()
        self.watchdog.remove_context(f"flight:{self._wd_channel}")
        obs_profiler.PROFILER.unwatch_flight(
            self.telemetry.model or "engine")
        self._thread.join(timeout)
        if self._pc_thread is not None:
            self._pc_queue.put(None)  # the writer drains the queue first
            self._pc_thread.join(timeout)
            self._pc_thread = None

    def attach_prompt_cache(self, prompt_cache: Optional[Any],
                            *, layer: bool = False) -> None:
        """Attach a prompt KV cache and start the writer thread for a
        writable one. A no-op for None or when a cache is attached —
        unless ``layer=True`` and the attached cache lacks the
        store-signalling surface the fleet's prefix export waits on
        (``wait_for``): then the new cache fronts it (``fallthrough``), so
        a configured disk prompt cache keeps working under a fleet
        replica's in-memory prefix cache (``fleet.prefix``). Safe while
        the engine thread runs: it reads the attribute once an admission
        or release."""
        if prompt_cache is None:
            return
        if self.prompt_cache is not None:
            if not layer or hasattr(self.prompt_cache, "wait_for"):
                return
            prompt_cache.fallthrough = self.prompt_cache
        self.prompt_cache = prompt_cache
        if not prompt_cache.read_only and self._pc_thread is None:
            self._pc_thread = threading.Thread(
                target=self._pc_writer, name="prompt-cache", daemon=True)
            self._pc_thread.start()

    def _pc_writer(self) -> None:
        """Writer loop: bring each snapshot to the host and store it."""
        while True:
            item = self._pc_queue.get()
            if item is None:
                return
            tokens, snapshot = item
            try:
                t0 = time.perf_counter()
                self.prompt_cache.store(tokens,
                                        self.runner.pack_prefix(snapshot))
                self.pc_seconds["store_s"] += time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — cache ≠ serving
                log.warning("prompt-cache store failed: %s", e)

    # -- self-healing (faults.supervisor drives these) -------------------

    def _fail_handle(self, handle: GenHandle, reason: str = "error",
                     *, preempted: bool = True) -> None:
        self.telemetry.finished(handle.trace, handle, reason,
                                preempted=preempted)
        handle._finish(reason)

    def rebuild(self, probe_timeout: float = 30.0) -> None:
        """Tear down and re-initialize the engine after a suspected-wedged
        dispatch (the EngineSupervisor calls it off-thread while the engine
        thread is presumed parked in a round-trip that may never return).

        Fences the old engine thread off (epoch bump: it exits whenever
        its blocked call returns, checking the epoch after every drain and
        before every launch), fails every request holding engine state
        with a clean ``error`` (the API answers 5xx), has the runner (and a
        speculating engine's drafter) allocate fresh device state — new
        tensors, never the old ones reused —, probes the device from an
        abandonable thread, then starts a fresh engine thread that resumes
        the queued requests. Raises if the probe fails or times out — the
        supervisor escalates.

        Runs only on the supervisor's single recovery thread, the sole
        owner of the engine structures while the fenced thread is parked
        (``_lock`` still guards the cross-thread ``_slots`` views)."""
        if self.spec is not None and not getattr(
                self.spec, "supports_rebuild", False):
            raise RuntimeError(
                "engine rebuild is not supported with this speculative "
                "engine")
        if self._stopping:
            raise RuntimeError("scheduler is shutting down")
        t0 = time.monotonic()
        self._epoch += 1
        epoch = self._epoch
        with self._lock:
            failed = list(self._slots.items())
            self._slots.clear()
            self.total_preemptions += len(failed) + len(self._prefills)
        log.warning("engine rebuild: fencing old engine thread "
                    "(epoch %d), draining %d active slots",
                    epoch - 1, len(failed))
        for _slot, ctx in failed:
            self._fail_handle(ctx.handle)
        for pf in list(self._prefills):
            self._fail_handle(pf.handle)
        self._prefills.clear()
        # the held request has no engine state (its reservation is only
        # attempted at admit): it survives and is retried against the
        # fresh pool, like the queued requests
        self._resident.clear()
        self._quarantined.clear()
        self._spec_dirty = False
        self._spec_stale.clear()
        self._last_drain_t = None
        self._anat_sched_s = self._anat_launch_s = self._anat_overlap_s = 0.0
        # the fenced thread never leaves its wedged guard, so its arm() has
        # no disarm(): drop the channel, or the leaked armed count fires a
        # spurious stall (and rebuild) every idle gap
        self.watchdog.reset(self._wd_channel)
        self.runner.reinit()
        if self.spec is not None:
            # the drafter's state referenced the old pool: reset it too
            self.spec.reinit()
        self._probe(probe_timeout)
        self.rebuilds += 1
        self.last_rebuild_s = time.monotonic() - t0
        self._thread = threading.Thread(target=self._run, args=(epoch,),
                                        name="engine", daemon=True)
        self._thread.start()
        self._wake.set()

    def _probe(self, timeout: float) -> None:
        """One real admit + release on the rebuilt runner, in a side thread
        (on the runner's device, named explicitly: a new thread's current
        CUDA device is not the engine's), so a still-dead device costs
        ``timeout`` seconds and an abandoned daemon instead of wedging the
        supervisor."""
        done = threading.Event()
        err: list = []
        runner = self.runner

        def probe() -> None:
            slot = None
            try:
                import torch

                scope = (torch.cuda.device(runner.device)
                         if runner.device.type == "cuda"
                         else contextlib.nullcontext())
                with scope:
                    slot = runner.acquire_slot()
                    if slot is None:
                        raise RuntimeError("no free slot after reinit")
                    runner.admit(slot, [1, 2, 3], temperature=0.0)
                    runner.release(slot)
            except Exception as e:  # noqa: BLE001 — reported to the waiter
                err.append(e)
                if slot is not None:
                    try:
                        runner.release(slot)
                    except Exception:  # noqa: BLE001
                        pass
            finally:
                done.set()

        t0 = time.monotonic()
        t = threading.Thread(target=probe, name="engine-probe", daemon=True)
        t.start()
        if not done.wait(timeout):
            raise RuntimeError(
                f"probe dispatch made no progress in {timeout}s")
        if err:
            raise RuntimeError(f"probe dispatch failed: {err[0]}")
        self.last_probe_s = time.monotonic() - t0

    def mark_failed(self) -> None:
        """Terminal state: the supervisor exhausted its rebuild budget.
        Every queued, held or active request resolves with a clean error,
        later submits fail fast, and the engine thread is fenced off (it
        exits, so ``alive()`` goes false and the manager's dead-engine
        reload takes over)."""
        self._epoch += 1  # fence whatever engine thread still exists
        with self._lock:
            # the flag flip and the slot collection share the lock
            # submit()'s check-and-enqueue holds: every handle that beat
            # the flip is already in a queue the drain below pops
            self.failed = True
            failed = list(self._slots.items())
            self._slots.clear()
            self.total_preemptions += len(failed)
        for _slot, ctx in failed:
            self._fail_handle(ctx.handle)
        for pf in list(self._prefills):
            self._fail_handle(pf.handle)
        self._prefills.clear()
        if self._held is not None:
            self._fail_handle(self._held, preempted=False)
            self._held = None
        while True:
            handle = self._next_pending()
            if handle is None:
                break
            self._fail_handle(handle, preempted=False)

    # -- fault injection (no-ops unless armed) ---------------------------

    def _inject_slot_faults(self) -> None:
        """decode.nan site: poison the bias row of the first active slot
        whose correlation/trace id matches an armed spec — its next logits
        row goes NaN on the device and the per-row guard must catch it.
        Runs only while faults.ACTIVE."""
        with self._lock:
            slots = {s: c.handle.request for s, c in self._slots.items()}
        for slot, req in slots.items():
            key = req.correlation_id or req.trace_id or str(slot)
            spec = _faults.fire("decode.nan", key=key)
            if spec is None:
                continue
            row = np.full(self.runner.cfg.vocab_size, np.nan, np.float32)
            self._engine.set_bias(slot, row)

    def _poisoned(self, slot: int, ctx: _SlotCtx) -> None:
        """The device-side per-row finite guard flagged this slot's logits
        (NAN_TOKEN in the sampled row): fail only the affected request with
        ``error`` and hold the slot out of admission for
        ``LOCALAI_NAN_QUARANTINE_DISPATCHES`` dispatches — co-batched slots
        keep streaming untouched."""
        self.nan_rows += 1
        self.telemetry.registry.nan_rows.inc(
            model=self.telemetry.model or "engine")
        log.error(
            "non-finite logits for slot %d (request %s): failing the "
            "request, quarantining the slot for %d dispatches",
            slot, ctx.handle.request.correlation_id or ctx.handle.id,
            self._nan_quarantine)
        # the ledger's waste class for this failure is nan_quarantine
        ctx.handle.nan_poisoned = True
        self._release(slot, ctx, "error")
        # _release returned the slot to the free list: pull it back out
        # until the quarantine window passes
        if self._engine.acquire_slot(slot) is not None:
            self._quarantined[slot] = (self._dispatch_seq
                                       + self._nan_quarantine)

    def _unquarantine(self) -> None:
        for slot, release_at in list(self._quarantined.items()):
            if self._dispatch_seq >= release_at:
                del self._quarantined[slot]
                self._engine.release(slot)
                self.quarantine_log.append(
                    (slot, release_at - self._nan_quarantine,
                     self._dispatch_seq))
                log.info("slot %d leaves NaN quarantine", slot)

    # -- engine thread ---------------------------------------------------

    def _run(self, epoch: int) -> None:
        """Engine-thread entry: the loop until shutdown — or until a
        rebuild fences this thread off (``_epoch`` moved past ours while we
        sat in a blocked round-trip); then exit silently: the replacement
        thread owns the state."""
        try:
            self._run_loop(epoch)
        except _EngineAbandoned:
            log.warning("engine thread (epoch %d) abandoned after rebuild",
                        epoch)

    def _fence(self, epoch: int) -> None:
        """Before a launch: a fenced thread must not touch the runner's
        fresh state (its tensors were rebound by the rebuild)."""
        if self._epoch != epoch:
            raise _EngineAbandoned

    def _run_loop(self, epoch: int) -> None:
        # each entry: (tokens, dispatch seq, steps, pipelined, issue time,
        # first dispatch of its shape)
        inflight: deque[tuple[Any, int, int, bool, float, bool]] = deque()

        def drain_one() -> None:
            toks, seq, k, pipelined, t_issue, fresh = inflight.popleft()
            t_sync = time.monotonic()  # anatomy: the result-fetch block
            with self.watchdog.guard(self._wd_channel):
                if _faults.ACTIVE:  # chaos: wedge/raise inside the guard
                    _faults.apply("engine.drain", key=self._wd_channel)
                rows = np.asarray(toks)  # waits on the copy started at
                                         # dispatch
            # a rebuild replaced this engine while we were parked in the
            # round-trip above: the state is no longer ours
            self._fence(epoch)
            now = time.monotonic()
            sync_s = now - t_sync
            # per-token timing for the adaptive streaming dispatch size: a
            # dispatch issued behind another in flight is measured from the
            # previous drain; the first dispatch of a shape is skipped
            dt = (now - self._last_drain_t
                  if pipelined and self._last_drain_t is not None
                  else now - t_issue)
            window = None
            k_eff = k
            if k == 0:  # a speculative window: rows carry SKIP sentinels
                window = self.spec.observe_window(rows)
                # its step count is its measured yield: mean emitted
                # tokens per active slot-window
                k_eff = (max(1, round(window["emitted"]
                                      / window["windows"]))
                         if window["windows"] else 0)
            if not fresh and k_eff > 0:
                self._observe_step_time(dt / k_eff)
                # measured dispatch latency for the program catalog
                obs_compile.note_latency(
                    "verify" if k == 0
                    else "decode_n" if k > 1 else "decode",
                    dt, steps=k_eff)
            self._last_drain_t = now
            if rows.ndim == 1:
                rows = rows[None]
            self._process_rows(rows, seq)
            self._flight_record(
                "spec" if k == 0 else ("decode_n" if k > 1 else "decode"),
                k_eff, dt, fresh,
                spec_proposed=window["proposed"] if window else 0,
                spec_accepted=window["accepted"] if window else 0,
                sync_s=sync_s)

        while not self._stopping and self._epoch == epoch:
            if _faults.ACTIVE:
                # decode.nan chaos: poison a matching active slot's bias
                # row so its next logits go non-finite — the device-side
                # guard must catch it
                self._inject_slot_faults()
            t_adm = time.monotonic()
            admitted = self._admit_pending()
            adm_s = time.monotonic() - t_adm
            if admitted and not self._chunked:
                # a one-shot admission dispatches and syncs a whole prefill
                # inside _admit_pending: device work, not scheduling, kept
                # out of the next record's gap as overlap
                self._anat_overlap_s += adm_s
            else:
                self._anat_sched_s += adm_s
            self._fence(epoch)
            chunked = self._step_prefill_chunk()
            if not self._slots:
                self._last_drain_t = None  # idle gap would pollute the EMA
                if inflight:
                    drain_one()
                    continue
                if self._prefills:
                    continue
                if not admitted and not chunked:
                    # true idle: the poll spans belong to no record
                    self._anat_sched_s = 0.0
                    self._anat_launch_s = 0.0
                    self._anat_overlap_s = 0.0
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            try:
                self._fence(epoch)
                if _faults.ACTIVE:  # chaos: a dispatch that raises/stalls
                    _faults.apply("engine.dispatch", key="decode")
                    self._fence(epoch)
                if self._constrained_slots():
                    # a constrained slot's bias row must follow its last
                    # token: drain the pipeline so the rows refreshed from
                    # processed tokens apply to the very next dispatch,
                    # which is synchronous
                    if self.spec is not None:
                        # plain dispatches leave the drafts behind the
                        # target: resync before the next window
                        self._spec_dirty = True
                    while inflight:
                        drain_one()
                    constrained = self._constrained_slots()
                    if self._slots and constrained:
                        self._dispatch_constrained(constrained)
                    continue
                # the cheap speculation pre-gate comes BEFORE any drain or
                # resync: a suppressed or no-candidate dispatch costs
                # exactly a plain pipelined one
                spec_ready = self._spec_ready()
                if spec_ready and self._spec_dirty and inflight:
                    # a resync must see the complete resident record
                    drain_one()
                    continue
                spec_rows = None
                if spec_ready and self._spec_usable():
                    if not self.spec.pipeline_safe:
                        # host drafters propose from drained history: the
                        # previous window is observed before the next
                        # proposal, so their windows serialize
                        while inflight:
                            drain_one()
                        if not self._slots:
                            continue
                    t_issue = time.monotonic()
                    # None: the drafter declined, decode plainly
                    spec_rows = self.spec.step_spec_async()
                    # anatomy: proposal + verify issue (the host drafter's
                    # work rides in launch); a declined proposal issued
                    # nothing, so its host work is scheduling
                    if spec_rows is not None:
                        self._anat_launch_s += time.monotonic() - t_issue
                    else:
                        self._anat_sched_s += time.monotonic() - t_issue
                if spec_rows is not None:
                    self._dispatch_seq += 1
                    fresh = "spec" not in self._seen_shapes
                    self._seen_shapes.add("spec")
                    self.last_dispatch_steps = self.spec.gamma + 1
                    # k=0 marks a window: the drain reads its yield
                    inflight.append((spec_rows, self._dispatch_seq, 0,
                                     bool(inflight), t_issue, fresh))
                    if len(inflight) >= self.pipeline_depth:
                        drain_one()
                    continue
                if self.spec is not None:
                    # plain steps leave the drafts behind the target
                    self._spec_dirty = True
                steps = self._effective_steps()
                self._dispatch_seq += 1
                fresh = steps not in self._seen_shapes
                self._seen_shapes.add(steps)
                t_issue = time.monotonic()
                if steps > 1:
                    tokens = self.runner.step_n_async(steps)
                else:
                    tokens = self.runner.step_async()
                self.last_dispatch_steps = steps
                # anatomy: the eager call's return — the host issuing every
                # kernel of the dispatch
                self._anat_launch_s += time.monotonic() - t_issue
                inflight.append((tokens, self._dispatch_seq, steps,
                                 bool(inflight), t_issue, fresh))
                if len(inflight) >= self.pipeline_depth:
                    drain_one()
            except _EngineAbandoned:
                raise
            except Exception:  # noqa: BLE001 — engine must not die silently
                if self._epoch != epoch:
                    # a rebuild raced this dispatch; the new engine owns
                    # the slots — do not fail them from the fenced thread
                    raise _EngineAbandoned from None
                # a verify window that raises fails the active requests
                # as a decode step that raises does
                log.exception("decode step failed; failing active requests")
                inflight.clear()
                with self._lock:
                    failed = list(self._slots.items())
                    self._slots.clear()
                    self.total_preemptions += len(failed)
                for slot, ctx in failed:
                    self._engine.release(slot)
                    self.telemetry.finished(ctx.handle.trace, ctx.handle,
                                            "error")
                    ctx.handle._finish("error")

    def _constrained_slots(self) -> set[int]:
        return {s for s, c in self._slots.items()
                if c.handle.request.constraint is not None}

    def _dispatch_constrained(self, constrained: set[int]) -> None:
        """One synchronous dispatch while a constrained slot is live: a
        single ``step()`` when every live slot is constrained (or the
        dispatch size is 1), else ``step_frozen_n``, where the
        constrained slots take part in the first step only and every
        other slot decodes the full dispatch."""
        steps = self._effective_steps()
        self._dispatch_seq += 1
        frozen = None
        if len(constrained) == len(self._slots) or steps == 1:
            shape: Any = 1
            program = "decode"
            t0 = time.monotonic()
            rows = self.runner.step()[None]
        else:
            freeze = np.zeros(self.runner.num_slots, bool)
            freeze[list(constrained)] = True
            frozen = constrained
            shape = ("frozen", steps)
            program = "decode_frozen_n"
            t0 = time.monotonic()
            rows = self.runner.step_frozen_n(freeze, steps)
        dt = time.monotonic() - t0
        # anatomy: the runner split its own wall into issue vs the blocking
        # read (last_launch_ms / last_sync_ms)
        self._anat_launch_s += self.runner.last_launch_ms * 1e-3
        fresh = shape not in self._seen_shapes
        n = rows.shape[0]
        if not fresh:
            self._observe_step_time(dt / n)
            obs_compile.note_latency(program, dt, steps=n)
        self._seen_shapes.add(shape)
        self.last_dispatch_steps = n
        self._process_rows(rows, self._dispatch_seq, frozen=frozen)
        self._flight_record(program, n, dt, fresh,
                            sync_s=self.runner.last_sync_ms * 1e-3)
        self._last_drain_t = None  # sync path: the drain clock is stale

    def _spec_ready(self) -> bool:
        """The cheap speculation pre-gate, before any pipeline drain or
        drafter resync: not suppressed by the backoff, and the drafter
        has a candidate for at least one active slot (checked against the
        live resident records, the data a resync would seed)."""
        if self.spec is None or self.spec.suppressed_tick():
            return False
        with self._lock:
            residents = {s: self._resident.get(s) for s in self._slots}
        return self.spec.has_candidate(residents)

    def _spec_usable(self) -> bool:
        """A window needs every active slot far enough from the context
        edge (it writes gamma+1 rows) and fresh drafts (resynced here if
        plain dispatches or chunked admissions intervened)."""
        gamma = self.spec.gamma
        with self._lock:
            slots = {s: c.handle.prompt_tokens + c.generated
                     for s, c in self._slots.items()}
        if any(n + gamma + 2 >= self.runner.max_ctx
               for n in slots.values()):
            return False
        if self._spec_dirty:
            # the drafts are stale for every active slot: rebuild them from
            # the resident records (a multimodal slot has none: wait until
            # it finishes)
            if any(self._resident.get(s) is None for s in slots):
                return False
            for s in slots:
                self.spec.resync_draft(s, self._resident[s])
            self._spec_dirty = False
            self._spec_stale.clear()
        elif self._spec_stale:
            if any(self._resident.get(s) is None
                   for s in self._spec_stale if s in slots):
                return False  # a multimodal slot: no record to seed from
            for s in list(self._spec_stale):
                if s in slots:
                    self.spec.resync_draft(s, self._resident[s])
                self._spec_stale.discard(s)
        return True

    @property
    def busy(self) -> bool:
        """Work in flight: an occupied slot, a prefill, a held or a
        queued request."""
        return (bool(self._slots) or bool(self._prefills)
                or self._held is not None or not self._pending.empty()
                or not self._pending_batch.empty())

    def alive(self) -> bool:
        """The engine thread runs and the engine is not marked failed
        (dead or failed → the manager reloads)."""
        return self._thread.is_alive() and not self.failed

    def handles_older_than(self, timeout: float) -> list[GenHandle]:
        """The handles in a slot that were submitted more than ``timeout``
        seconds ago (the busy watchdog cancels them)."""
        now = time.monotonic()
        with self._lock:
            return [ctx.handle for ctx in self._slots.values()
                    if now - ctx.handle.t_submit > timeout]

    def metrics(self) -> dict:
        """Live engine metrics in the JAX package's keys and shapes (its
        ``Scheduler.metrics()``): slots, occupancy, KV utilization, the
        paged pool and chunked prefill, both admission lanes, lifetime
        token / prefix-reuse / preemption totals, dispatches, the
        self-healing and NaN-guard counters, the prompt cache and the
        spec_* series; plus the port's constrained decoding counters. Host reads only: ``step_time_ema`` is seconds
        per decoded token."""
        num_slots = self.runner.num_slots
        pct = self.flight.percentiles()
        anat = obs_anatomy.summarize(self.flight)
        with self._lock:
            active = [
                {
                    "slot": s,
                    "prompt_tokens_processed": c.handle.prompt_tokens,
                    "tokens_generated": c.handle.completion_tokens,
                    "tokens_per_second": c.handle.tokens_per_second,
                    "correlation_id": c.handle.request.correlation_id,
                }
                for s, c in self._slots.items()
            ]
            kv_utilization = self._kv_utilization()
            batch_slots = self._batch_slots()
            # one snapshot: a scrape must not mix half-updated totals
            totals = {
                "prompt": self.total_prompt_tokens,
                "generated": self.total_generated_tokens,
                "preemptions": self.total_preemptions,
                "prefill_chunks": self.total_prefill_chunks,
                "shed": self.shed_total,
                "failed": self.failed,
            }
        paged_stats = {}
        alloc = self.runner.allocator
        if alloc is not None:
            st = alloc.stats()
            paged_stats = {
                "kv_block_tokens": self.runner.block_tokens,
                # "kernel" (K1 on the card) | "torch" (its plain version):
                # the localai_paged_kernel_impl one-hot
                "paged_attn_impl": self.runner.paged_attn_impl,
                "kv_dtype": str(self.runner.kv_dtype),
                "kv_blocks_total": st.total,
                # free = immediately free + reclaimable prefix-pool cache
                "kv_blocks_free": st.free + st.cached,
                "kv_blocks_used": st.used,
                "kv_blocks_cached": st.cached,
                "kv_block_watermark": st.high_watermark,
                "kv_blocks_spec_reserved": st.spec_reserved,
                "kv_overcommit_ratio": self.runner.kv_overcommit,
                "kv_shared_tokens": alloc.shared_tokens_total,
                "prefill_chunks": totals["prefill_chunks"],
                "prefill_chunk_queue_depth": sum(
                    p.adm.chunks_remaining for p in list(self._prefills)),
            }
            ts = alloc.tier_stats()
            if ts is not None:
                paged_stats.update({
                    "kv_tier_blocks": ts["entries"],
                    "kv_tier_bytes": ts["bytes"],
                    "kv_tier_budget_bytes": ts["budget_bytes"],
                    "kv_tier_spills": ts["spills_total"],
                    "kv_tier_reloads": ts["reloads_total"],
                })
        out = {
            "active_slots": active,
            "num_slots": num_slots,
            "occupancy": len(active) / num_slots if num_slots else 0.0,
            "kv_utilization": kv_utilization,
            **paged_stats,
            "queue_depth": self._pending.qsize(),
            "batch_queue_depth": self._pending_batch.qsize(),
            "batch_slots": batch_slots,
            "total_prompt_tokens": totals["prompt"],
            "total_generated_tokens": totals["generated"],
            "prefix_tokens_reused": self.runner.total_prefix_reused,
            "last_dispatch_steps": self.last_dispatch_steps,
            "dispatches": self._dispatch_seq,
            "preemptions": totals["preemptions"],
            "shed_total": totals["shed"],
            # self-healing + NaN-guard surface (faults)
            "engine_state": "failed" if totals["failed"] else "serving",
            "rebuilds": self.rebuilds,
            "nan_rows": self.nan_rows,
            "quarantined_slots": len(self._quarantined),
            "kv_invariant_violations": self.kv_invariant_violations,
            "step_time_ema": self._step_ema,  # seconds per decoded token
            "step_ms_p50": pct["step_ms_p50"],
            "step_ms_p99": pct["step_ms_p99"],
            # dispatch anatomy (obs.anatomy) over the same ring
            "host_overhead_fraction": anat["host_overhead_fraction"],
            "device_bubble_fraction": anat["device_bubble_fraction"],
            "dispatch_phase_ms": obs_anatomy.phase_quantiles(anat),
            "frozen_dispatches": self.runner.frozen_dispatches,
            "constrained_tokens": self.constrained_tokens,
            "constraint_host_s": self.constraint_host_s,
        }
        if self.prompt_cache is not None:
            out["prompt_cache"] = {**self.prompt_cache.stats(),
                                   **self.pc_seconds}
        if self.spec is not None:
            out.update({
                "spec_acceptance_rate": self.spec.acceptance_rate,
                "spec_windows": self.spec.total_windows,
                "spec_accept_rate": self.spec.accept_rate,
                "spec_draft_tokens": self.spec.total_proposed,
                "spec_accepted_tokens": self.spec.total_accepted,
                "spec_tokens_per_dispatch": self.spec.tokens_per_dispatch,
                "spec_suppressed": self.spec.total_suppressed,
                "spec_drafter": self.spec.drafter.name,
                "spec_gamma": self.spec.gamma})
        return out

    def _batch_slots(self) -> int:
        """Occupied slots serving background batch-lane requests."""
        return sum(1 for c in self._slots.values()
                   if c.handle.request.priority >= PRIORITY_BATCH)

    def _kv_utilization(self) -> float:
        """Fraction of KV capacity holding live context: the paged pool's
        used / allocatable blocks (reservations included), or on the
        contiguous layout the live rows of the host token record over
        slots x context. The caller holds ``_lock`` or is the engine thread
        (the only writer of ``_slots``)."""
        alloc = self.runner.allocator
        if alloc is not None:
            return alloc.stats().utilization
        num_slots, max_ctx = self.runner.num_slots, self.runner.max_ctx
        if not num_slots:
            return 0.0
        rows = sum(min(c.handle.prompt_tokens + c.generated, max_ctx)
                   for c in self._slots.values())
        return rows / (num_slots * max_ctx)

    def note_shed(self) -> None:
        """Record one SLO admission-control refusal against this engine
        (the API calls it when it answers 429 for this model)."""
        with self._lock:
            self.shed_total += 1

    def _take_anat(self, dt: float, sync_s: float) -> dict:
        """Take and reset the anatomy accumulators into phase ms for a
        record accounting the wall interval ``dt`` (seconds). Clamp order
        is by trust: the measured ``sync`` first, then the measured
        ``launch``, then the accumulated ``sched``, then the wall other
        records already account (``overlap``); ``gap`` is the remainder,
        so gap + sched + launch + sync <= dispatch_ms for every record.
        Engine thread only."""
        wall = max(0.0, dt)
        sync = min(max(0.0, sync_s), wall)
        launch = min(self._anat_launch_s, wall - sync)
        sched = min(self._anat_sched_s, wall - sync - launch)
        overlap = min(self._anat_overlap_s, wall - sync - launch - sched)
        gap = max(0.0, wall - sync - launch - sched - overlap)
        self._anat_sched_s = 0.0
        self._anat_launch_s = 0.0
        self._anat_overlap_s = 0.0
        return {"gap_ms": gap * 1e3, "sched_ms": sched * 1e3,
                "launch_ms": launch * 1e3, "sync_ms": sync * 1e3}

    def _flight_record(self, program: str, steps: int, dt: float,
                       fresh: bool, spec_proposed: int = 0,
                       spec_accepted: int = 0, sync_s: float = 0.0,
                       phases: Optional[dict] = None) -> None:
        """One flight-ring record at a drain point, after the rows were
        processed (occupancy and tokens are the dispatch's end state): a
        handful of host reads and one in-place ring row. ``phases``
        pre-built (prefill chunks) leave the accumulators to the next
        decode record. Engine thread only."""
        emitted = self._tokens_emitted
        num_slots = self.runner.num_slots
        if phases is None:
            phases = self._take_anat(dt, sync_s)
        self.flight.record(
            program=program,
            steps=steps,
            dispatch_ms=dt * 1e3,
            occupancy=len(self._slots) / num_slots if num_slots else 0.0,
            batch_slots=self._batch_slots(),
            queue_depth=self._pending.qsize(),
            kv_utilization=self._kv_utilization(),
            tokens=emitted - self._flight_mark,
            preemptions=self.total_preemptions,
            spec_accept=(self.spec.acceptance_rate
                         if self.spec is not None else None),
            spec_proposed=spec_proposed,
            spec_accepted=spec_accepted,
            gap_ms=phases["gap_ms"],
            sched_ms=phases["sched_ms"],
            launch_ms=phases["launch_ms"],
            sync_ms=phases["sync_ms"],
            compile=fresh,
        )
        self._flight_mark = emitted
        if spec_proposed > spec_accepted:
            # rejected draft tokens: device work the ring never counts as
            # emitted (the waste decomposition's spec_rejected class)
            obs_ledger.LEDGER.note_waste(
                "spec_rejected", tokens=spec_proposed - spec_accepted,
                model=self.telemetry.model or "engine")
        if self.kv_check:
            self._check_kv_invariants()

    def _check_kv_invariants(self) -> None:
        """Debug-flag drain sweep: the block allocator must conserve its
        pool (free + used + cached == total, refcount sanity) after every
        dispatch. Violations log, count, and feed
        localai_kv_invariant_violations_total — they mean a leak."""
        alloc = self.runner.allocator
        if alloc is None:
            return
        problems = alloc.check_invariants()
        if problems:
            self.kv_invariant_violations += len(problems)
            self.telemetry.registry.kv_invariant_violations.inc(
                len(problems), model=self.telemetry.model or "engine")
            log.error("KV block invariants violated: %s", problems)

    def _flight_forensics(self) -> dict:
        """Watchdog context provider: the last engine records, attached to
        every ``kind="stall"`` trace (host only)."""
        return {
            "channel": self._wd_channel,
            "records": self.flight.snapshot(limit=32),
            **self.flight.percentiles(),
        }

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
        could be allocated now (allocate() stays authoritative); always
        True for a contiguous runner, which reserves nothing."""
        if not self._chunked:
            return True
        alloc = self.runner.allocator
        # a spec engine reserves a gamma+1 lookahead on top of the decode
        # worst case (begin_admit spec_tokens): mirror it, or a full pool
        # would loop begin_admit → None on every iteration
        look = self.spec.gamma + 1 if self.spec is not None else 0
        reserve = min(self.runner.max_ctx,
                      len(req.prompt) + (req.max_new_tokens
                                         or self.default_max_tokens)
                      + 1 + look)
        need = alloc.blocks_for(reserve) - len(alloc.match_prefix(req.prompt))
        return alloc.stats().available >= need

    def _next_pending(self) -> Optional[GenHandle]:
        """Two-lane admission pop: the interactive lane drains strictly
        first; a batch request is handed out only when the interactive
        queue is empty at this instant."""
        try:
            return self._pending.get_nowait()
        except queue.Empty:
            pass
        try:
            return self._pending_batch.get_nowait()
        except queue.Empty:
            return None

    def _hold(self, handle: GenHandle) -> None:
        """Park a request the block pool cannot cover yet: an interactive
        one holds its place (FIFO); a batch one goes back to its own lane,
        so it never blocks an interactive admission behind a full pool."""
        if handle.request.priority >= PRIORITY_BATCH:
            self._pending_batch.put(handle)
        else:
            self._held = handle

    def _admit_pending(self) -> bool:
        if self._quarantined:
            self._unquarantine()
        admitted = False
        while self._engine.free_slots():
            if self._held is not None:
                if (not self._held.cancelled
                        and not self._reservation_fits(self._held.request)):
                    return admitted
                handle, self._held = self._held, None
            else:
                handle = self._next_pending()
                if handle is None:
                    return admitted
            if handle.cancelled:
                # abandoned while still queued: not a slot exit, so not a
                # preemption
                self.telemetry.finished(handle.trace, handle, "cancelled",
                                        preempted=False)
                handle._finish("cancelled")
                continue
            if not self._reservation_fits(handle.request):
                self._hold(handle)
                return admitted
            positions = None
            if self._chunked:
                slot = self._engine.acquire_slot()
            else:
                # one batched [S] positions read serves the ranking and the
                # admit: free slots' frontiers stay frozen until prefilled
                positions = self.runner.slot_positions()
                slot = self._engine.acquire_slot(
                    self._best_slot(handle.request.prompt, positions))
            try:
                if not self._start(slot, handle, positions):
                    self._engine.release(slot)
                    self._hold(handle)
                    return admitted
                admitted = True
            except Exception as e:  # noqa: BLE001 — bad request ≠ dead engine
                log.warning("admit failed: %s", e)
                self._engine.release(slot)
                with self._lock:
                    self.total_preemptions += 1
                self.telemetry.finished(handle.trace, handle, "error")
                handle._finish("error")
        return admitted

    def _start(self, slot: int, handle: GenHandle,
               positions: Optional[np.ndarray] = None) -> bool:
        """Paged: reserve blocks and queue the chunked prefill of
        ``handle`` in ``slot``; False when the pool can't cover the
        reservation now. Contiguous: prefill the prompt (reusing the
        slot's resident prefix where it can, ``positions`` being the
        batched frontier read) and activate the slot."""
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
        # the constraint's first mask is in the bias row before the
        # prefill samples, so the first token is already constrained
        mask = (req.constraint.allowed_mask()
                if req.constraint is not None else None)
        resident = self._resident.get(slot)
        # a paged runner keeps no rows past release (only rows loaded
        # below count), so it needs no frontier read
        valid_n = self.runner.resident_rows(
            slot, self.runner.max_ctx if positions is None
            else int(positions[slot]))
        if self.prompt_cache is not None and req.mm_embeds is None:
            mem_lcp = (self.runner.reusable_prefix(slot, resident, req.prompt,
                                                   valid_n=valid_n)
                       if resident else 0)
            t0 = time.perf_counter()
            hit = self.prompt_cache.lookup(req.prompt)
            t1 = time.perf_counter()
            self.pc_seconds["lookup_s"] += t1 - t0
            # the disk hit is scored through the same feasibility gates as
            # the resident record (validity: its own row count)
            disk_lcp = (self.runner.reusable_prefix(
                slot, hit.tokens, req.prompt, valid_n=hit.n)
                if hit is not None else 0)
            if (disk_lcp > mem_lcp
                    and self.runner.load_prefix(slot, hit.arrays, hit.n)):
                resident, valid_n = hit.tokens, hit.n
                self.pc_seconds["load_s"] += time.perf_counter() - t1
        sampling = dict(
            resident=resident, valid_n=valid_n,
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            min_p=req.min_p, repeat_penalty=req.repeat_penalty,
            presence_penalty=req.presence_penalty,
            frequency_penalty=req.frequency_penalty, seed=req.seed,
            bias_row=self._compose_bias(base, mask),
            mm_embeds=req.mm_embeds, mm_positions=req.mm_positions)
        background = req.priority >= PRIORITY_BATCH
        if not self._chunked:
            handle.admit_index = self._admit_seq  # engine thread writes it
            self._admit_seq += 1
            self.telemetry.admitted(
                handle.trace, slot=slot,
                queue_wait=time.monotonic() - handle.t_submit,
                background=background)
            first = self._engine.admit(slot, req.prompt, **sampling)
            self.telemetry.prefill_done(
                handle.trace, path=self.runner.last_prefill_path,
                prefix_reused=self.runner.last_prefix_reused)
            self._activate_slot(slot, handle, first, base, mask is not None)
            return True
        # reserve the worst case so decode can never run out of blocks
        reserve = len(req.prompt) + (req.max_new_tokens
                                     or self.default_max_tokens) + 1
        adm = self._engine.begin_admit(slot, req.prompt,
                                       reserve_tokens=reserve, **sampling)
        if adm is None:
            return False
        handle.admit_index = self._admit_seq
        self._admit_seq += 1
        self.telemetry.admitted(
            handle.trace, slot=slot,
            queue_wait=time.monotonic() - handle.t_submit,
            background=background)
        self._prefills.append(_PendingPrefill(slot=slot, handle=handle,
                                              adm=adm, base=base,
                                              mask_set=mask is not None))
        return True

    def _best_slot(self, prompt: list[int],
                   positions: np.ndarray) -> Optional[int]:
        """Free slot with the longest reusable token prefix (None: FIFO),
        ranked by the runner's own feasibility gates so the choice cannot
        collapse to no reuse at admit time."""
        best, best_lcp = None, 0
        for s in self.runner.free_slots():
            r = self._resident.get(s)
            if not r:
                continue
            lcp = self.runner.reusable_prefix(s, r, prompt,
                                              valid_n=int(positions[s]))
            if lcp > best_lcp:
                best, best_lcp = s, lcp
        return best

    def _activate_slot(self, slot: int, handle: GenHandle, first: int,
                       base: Optional[np.ndarray], mask_set: bool) -> None:
        """Prefill finished (one-shot or final chunk): install the live
        slot context (``base``: its bias row without a constraint mask),
        record the resident tokens (the runner's empty-prompt
        normalization [0] keeps the record aligned with the cache rows)
        and consume the first token."""
        # multimodal KV mixes injected embeddings with token ids, so the
        # token record alone can't prove prefix equality: never reuse it
        self._resident[slot] = (
            None if handle.request.mm_embeds is not None
            else list(handle.request.prompt) or [0])
        ctx = _SlotCtx(
            handle=handle,
            detok=IncrementalDetokenizer(self.tokenizer.decode),
            stopper=StopChecker(handle.request.stop),
            base_bias=base,
            mask_set=mask_set,
            admit_seq=self._dispatch_seq,
        )
        with self._lock:
            self._slots[slot] = ctx
            self.total_prompt_tokens += handle.prompt_tokens
        if self.spec is not None and self._chunked:
            # a chunked admission bypassed spec.admit: seed this slot's
            # drafter from its resident record before the next window
            self._spec_stale.add(slot)
        self._consume(slot, ctx, first)

    def _step_prefill_chunk(self) -> bool:
        """Dispatch ONE pending prefill chunk (FIFO across admissions) and
        activate the slot on its final chunk. True if a chunk ran."""
        if not self._prefills:
            return False
        pf = self._prefills[0]
        if pf.handle.cancelled:
            self._prefills.popleft()
            pf.adm.abort()   # frees the blocks, slot returns to free list
            with self._lock:
                self.total_preemptions += 1
            self.telemetry.finished(pf.handle.trace, pf.handle, "cancelled")
            pf.handle._finish("cancelled")
            return True
        t0 = time.monotonic()
        try:
            first = pf.adm.step_chunk()
        except Exception as e:  # noqa: BLE001 — fail this request only
            log.warning("prefill failed: %s", e)
            self._prefills.popleft()
            pf.adm.abort()
            with self._lock:
                self.total_preemptions += 1
            self.telemetry.finished(pf.handle.trace, pf.handle, "error")
            pf.handle._finish("error")
            return True
        dt = time.monotonic() - t0
        with self._lock:
            self.total_prefill_chunks += 1
        # anatomy: the admission split its own wall into issue vs the final
        # chunk's first-token read; the rest of this span is chunk staging
        # (sched). Pre-built phases leave the accumulators to the next
        # decode record, and the whole span is overlap there
        wall_ms = max(0.0, dt) * 1e3
        sync_ms = min(pf.adm.last_sync_ms, wall_ms)
        launch_ms = min(pf.adm.last_launch_ms, wall_ms - sync_ms)
        self._flight_record(
            "prefill_chunk", 0, dt, False,
            phases={"gap_ms": 0.0,
                    "sched_ms": wall_ms - sync_ms - launch_ms,
                    "launch_ms": launch_ms, "sync_ms": sync_ms})
        self._anat_overlap_s += dt
        if first is None:
            return True
        self._prefills.popleft()
        self.telemetry.prefill_done(pf.handle.trace, path=pf.adm.path,
                                    prefix_reused=pf.adm.prefix_reused)
        self._activate_slot(pf.slot, pf.handle, first, pf.base, pf.mask_set)
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

    def _compose_bias(self, base: Optional[np.ndarray],
                      mask: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """The slot's bias row: ``base`` plus the constraint ``mask``. A
        mask covers the tokenizer's vocab; the ids a wider model vocab
        pads on are disallowed (-1e30), so no mask can resurrect them."""
        base = self._fit_vocab(base, 0.0)
        mask = self._fit_vocab(mask, -1e30)
        if base is None:
            return mask
        if mask is None:
            return base
        return base + mask

    def _fit_vocab(self, row: Optional[np.ndarray],
                   fill: float) -> Optional[np.ndarray]:
        if row is None:
            return None
        V = self.runner.cfg.vocab_size
        if len(row) == V:
            return row
        out = np.full(V, fill, np.float32)
        out[:min(len(row), V)] = row[:V]
        return out

    def _process_rows(self, rows: np.ndarray, seq: int,
                      frozen: Optional[set[int]] = None) -> None:
        """Consume [steps, S] sampled rows in temporal order. The seq guard
        drops tokens of dispatches issued before a slot's admission; a slot
        released at row i ignores the rows after it; SKIP entries (a
        speculative window that ended earlier) carry no token; ``frozen``
        slots took part in the first step of the dispatch only, so only
        row 0 is theirs."""
        for i in range(rows.shape[0]):
            for slot, ctx in list(self._slots.items()):
                if seq <= ctx.admit_seq:
                    continue
                if i > 0 and frozen is not None and slot in frozen:
                    continue
                tok = int(rows[i, slot])
                if tok == NAN_TOKEN:
                    # per-row NaN/inf guard sentinel: fail THIS request,
                    # quarantine the slot, keep the rest of the batch
                    self._poisoned(slot, ctx)
                    continue
                if tok < 0:  # SKIP: this slot's window ended earlier
                    continue
                self._consume(slot, ctx, tok)

    def _consume(self, slot: int, ctx: _SlotCtx, token_id: int) -> None:
        """Handle one sampled token for one slot: stream, stop, constrain,
        release."""
        r = self._resident.get(slot)
        if r is not None:
            r.append(token_id)
        handle = ctx.handle
        req = handle.request
        if handle.cancelled:
            self._release(slot, ctx, "cancelled")
            return
        if (not req.ignore_eos) and token_id in getattr(
                self.tokenizer, "eos_ids", set()):
            handle._emit(ctx.stopper.flush(), None)
            self._release(slot, ctx, "stop")
            return
        ctx.generated += 1
        self._tokens_emitted += 1  # the flight ring's per-record tokens
        delta = ctx.detok.push(token_id)
        handle._emit(ctx.stopper.push(delta), token_id)
        if ctx.stopper.stopped is not None:
            self._release(slot, ctx, "stop")
            return
        if req.constraint is not None:
            t0 = time.perf_counter()
            req.constraint.advance(token_id)
            if req.constraint.done:
                self._count_constraint(t0)
                handle._emit(ctx.stopper.flush(), None)
                self._release(slot, ctx, "stop")
                return
            mask = req.constraint.allowed_mask()
            if mask is not None or ctx.mask_set:
                # refresh whenever a mask was ever set, so an FSM entering
                # a free-text region (mask None) clears the stale row
                self._engine.set_bias(
                    slot, self._compose_bias(ctx.base_bias, mask))
                ctx.mask_set = mask is not None
            self._count_constraint(t0)
        limit = req.max_new_tokens or self.default_max_tokens
        if (ctx.generated >= limit
                or handle.prompt_tokens + ctx.generated
                >= self.runner.max_ctx - 1):
            # max_tokens, or context exhausted (no silent context shift)
            handle._emit(ctx.stopper.flush(), None)
            self._release(slot, ctx, "length")

    def _count_constraint(self, t0: float) -> None:
        self.constraint_host_s += time.perf_counter() - t0
        self.constrained_tokens += 1

    def _release(self, slot: int, ctx: _SlotCtx, reason: str) -> None:
        with self._lock:
            self._slots.pop(slot, None)
            self.total_generated_tokens += ctx.handle.completion_tokens
            if reason in ("cancelled", "error"):
                self.total_preemptions += 1
        pc = self.prompt_cache
        r = self._resident.get(slot)
        # a live migration cancels the request but exports its KV
        migrating = reason == "cancelled" and ctx.handle.migrate_export
        if (pc is not None and not pc.read_only and r
                and (reason in ("stop", "length") or migrating)):
            # the prompt's rows, or with prompt_cache_all the generation's
            # too (the last sampled token has no KV row); the length comes
            # from the host record, so no device read. A migration export
            # always keeps the generation: the destination resumes from
            # the full token record's frontier
            pos = min(len(r) - 1, self.runner.max_ctx - 1)
            keep = (pos if (self.prompt_cache_all or migrating)
                    else min(ctx.handle.prompt_tokens, pos))
            if keep >= pc.min_prefix:
                try:
                    self._pc_queue.put((list(r[:keep]),
                                        self.runner.snapshot_prefix(
                                            slot, keep)))
                except Exception as e:  # noqa: BLE001 — cache ≠ serving
                    log.warning("prompt-cache snapshot failed: %s", e)
        self._engine.release(slot)
        # retire the trace before _finish unblocks the client: a traces
        # query racing the response must not see a half-annotated trace
        self.telemetry.finished(ctx.handle.trace, ctx.handle, reason)
        ctx.handle._finish(reason)
        if reason in ("stop", "length") and self.supervisor is not None:
            # a natural completion closes any open incident: the
            # supervisor's rebuild budget refills
            self.supervisor.note_healthy()
