"""FleetServingModel: one model served by N replicas behind one facade.

Port of ``localai_tpu/fleet/serving.py``. The serving-model surface the API already speaks (tokenizer and templates
local, ``scheduler.submit`` → GenHandle), but submit() routes each
request across the replica fleet:

  * placement: prompt-prefix affinity over a consistent-hash ring, the
    prefix directory's record before it, least-loaded fallback and
    per-replica burn-rate route-around (``fleet.router``);
  * retry with failover: a replica dying mid-request is marked dead, and
    the request re-dispatches to the next candidate as long as nothing
    was streamed to the client yet (a half-streamed completion finishes
    ``error``, a clean 5xx);
  * disaggregation: a prompt of at least ``disagg_threshold`` tokens
    prefills on a dedicated prefill replica, whose packed KV prefix moves
    into the decode replica's prefix cache; the decode replica's
    admission then resumes past it (``load_prefix``), so long prompts
    never hold decode slots for their prefill;
  * the KV economy: sibling prefix fetches against the directory, live
    migration of an in-flight request (``migrate_inflight``, ``drain``).

Every request records lifecycle spans under its API trace id (queued →
route → prefix_transfer? → rpc); in-process replicas record their engine
spans in the same trace store under their replica ids, worker and remote
replicas under the same trace id in their own processes (the call's
metadata carries it). Remote workers (``fleet_hosts``, or
``adopt_remote`` on a ``POST /federated/register``) join the same
pool."""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Callable, Optional

from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.fleet import net
from localai_tpu_torch.fleet.kveconomy import MigrationTicket, PrefixDirectory
from localai_tpu_torch.fleet.kveconomy.migration import continuation_request
from localai_tpu_torch.fleet.pool import ReplicaPool
from localai_tpu_torch.fleet.router import FleetUnavailable, Router, affinity_key
from localai_tpu_torch.obs import EngineTelemetry
from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.obs import watchdog as obs_watchdog
from localai_tpu_torch.obs.metrics import REGISTRY
from localai_tpu_torch.obs.slo import SLOTracker, targets_from_config
from localai_tpu_torch.worker.serving import (WorkerGenHandle, consume_stream,
                                        predict_options)

log = logging.getLogger(__name__)


class FleetScheduler:
    """The scheduler-shaped surface of a replica fleet: submit() routes,
    dispatches on a daemon thread, and fails over on replica death."""

    def __init__(self, owner: "FleetServingModel", pool: ReplicaPool,
                 router: Router, slo: SLOTracker,
                 *, disagg_threshold: int = 512, max_failovers: int = 2,
                 rpc_timeout_s: Optional[float] = None):
        self._owner = owner
        self.pool = pool
        self.router = router
        self.slo = slo                      # per-REPLICA observatory
        self.disagg_threshold = disagg_threshold
        self.max_failovers = max_failovers
        # per-reply inactivity deadline on every cross-replica stream
        # (fleet.net.bounded_stream): a partitioned peer never RSTs, so
        # silence — not an error — is how a dead remote presents; the
        # deadline turns it into a prompt failover instead of a hung
        # dispatch thread (0 disables)
        self.rpc_timeout_s = (net.rpc_timeout_s() if rpc_timeout_s is None
                              else rpc_timeout_s)
        self._ids = itertools.count()
        self._inflight = 0
        self._lock = threading.Lock()
        # autoscale cold-start hook (AutoscaleController.request_capacity):
        # when routing finds no healthy replica, the dispatch thread calls
        # this and, on True, re-routes — a scaled-to-zero model serves the
        # held request off its cold re-onboard instead of erroring
        self.on_cold: Optional[Callable[[], bool]] = None
        # fleet prefix directory (shared with the router, which probes it
        # for placement; the scheduler writes it and fetches against it)
        self.directory: Optional[PrefixDirectory] = router.directory
        # handle.id → (handle, replica currently serving it): the live-
        # migration surface (migrate_inflight/drain) finds in-flight
        # requests here. Plain dict — per-key insert/pop from the owning
        # dispatch thread, point get() from callers — GIL-atomic.
        self._active: dict[int, tuple] = {}
        self.telemetry = EngineTelemetry(model=owner.name)
        self.watchdog = obs_watchdog.WATCHDOG
        self._wd_channel = f"fleet:{owner.name}"
        self.watchdog.start()
        self.shed_total = 0                 # API-tier SLO 429 mirror
        self.failovers = 0
        self.prefix_transfers = 0
        self.prefix_transfer_bytes = 0
        self.disagg_fallbacks = 0
        self.sibling_transfers = 0          # directory-driven KV pulls
        self.sibling_transfer_bytes = 0
        self.sibling_fallbacks = 0          # stale entry → re-prefill
        self.migrations = 0                 # live slot moves completed
        self.migration_fallbacks = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def note_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    def submit(self, gr: GenRequest) -> GenHandle:
        handle = WorkerGenHandle(gr, next(self._ids))
        if not gr.correlation_id:
            # migration must be able to address the replica-side stream of
            # any request (replica._streaming keys on correlation id) —
            # mint one when the API tier didn't; never overwrite a
            # caller-set id
            gr.correlation_id = f"fleet:{self._owner.name}:{handle.id}"
        handle._migration = None            # staked by migrate_inflight
        handle.trace = self.telemetry.queued(handle)
        if gr.mm_embeds is not None:
            self.telemetry.finished(handle.trace, handle, "error")
            handle._finish("error")
            log.error("fleet-served models do not support multimodal input")
            return handle
        with self._lock:
            self._inflight += 1
        threading.Thread(
            target=self._run, args=(handle,), daemon=True,
            name=f"fleet-req-{handle.id}",
        ).start()
        return handle

    # -- dispatch ----------------------------------------------------------

    def _run(self, handle: WorkerGenHandle) -> None:
        tr = handle.trace
        req = handle.request
        self.watchdog.arm(self._wd_channel)
        try:
            if tr is not None:
                tr.end("queued")
            exclude: set = set()
            attempt = 0
            cold_started = False
            while True:
                try:
                    if tr is not None:
                        tr.begin("route")
                    replica, reason = self.router.route(
                        req.prompt, exclude=exclude,
                        failover=attempt > 0)
                    if tr is not None:
                        tr.end("route", replica=replica.id, reason=reason)
                        # trace-level replica id (overwritten on failover
                        # → the replica that actually served): the
                        # telemetry harvest reads this to know WHOSE pane
                        # holds the other half of the waterfall
                        tr.annotate(replica=replica.id)
                except FleetUnavailable as e:
                    # scale-to-zero wakeup: the autoscaler parks a hook
                    # here; the held request waits out the cold boot (one
                    # attempt) and re-routes instead of erroring
                    if not cold_started and self.on_cold is not None:
                        cold_started = True
                        if tr is not None:
                            tr.end("route", error=str(e), cold_start=True)
                        if self.on_cold():
                            continue
                    elif tr is not None:
                        tr.end("route", error=str(e))
                    log.error("fleet %s: %s", self._owner.name, e)
                    self.telemetry.finished(tr, handle, "error")
                    handle._finish("error")
                    return
                REGISTRY.fleet_routed.inc(
                    model=self._owner.name, reason=reason)
                # submit() already rejected multimodal requests, so every
                # request here is plain-text and disagg-eligible by length
                if (attempt == 0
                        and len(req.prompt) >= self.disagg_threshold):
                    self._disaggregate(req, replica, tr)
                    if replica.state != "healthy":
                        # the handoff exposed a dead decode replica —
                        # re-route now instead of burning a dispatch on it
                        exclude.add(replica.id)
                        attempt += 1
                        with self._lock:
                            self.failovers += 1
                        self._note_failover_waste(req)
                        continue
                elif reason not in ("affinity", "directory"):
                    # placement could not follow the warm KV (queue
                    # override, failover, ring miss): if the directory
                    # knows a sibling holding this prefix, pull it over
                    # TransferPrefix instead of re-prefilling here
                    self._sibling_fetch(req, replica, tr)
                t_dispatch = time.monotonic()
                self._active[handle.id] = (handle, replica)
                try:
                    finish = self._dispatch(handle, replica, tr)
                except Exception as e:  # noqa: BLE001 — replica ≠ fleet
                    if isinstance(e, net.RpcDeadlineExceeded):
                        # silence past the inactivity bound — a partition
                        # or a link too slow to serve from
                        REGISTRY.fleet_rpc_deadlines.inc(
                            model=self._owner.name)
                    self.slo.observe(replica.id, error=True)
                    self.pool.note_failure(replica)
                    ticket = getattr(handle, "_migration", None)
                    if ticket is not None:
                        # the donor died mid-migration: resolve the ticket
                        # so migrate_inflight's wait returns instead of
                        # timing out; the normal failover path takes over
                        ticket.ready.set()
                        ticket.finish("error")
                        handle._migration = None
                    streamed = handle.t_first_token is not None
                    log.warning(
                        "fleet %s: replica %s failed request %d (%s); "
                        "%s", self._owner.name, replica.id, handle.id, e,
                        "failing (already streamed)" if streamed
                        else "failing over" if attempt < self.max_failovers
                        else "out of failover attempts")
                    if not streamed and attempt < self.max_failovers:
                        exclude.add(replica.id)
                        attempt += 1
                        with self._lock:
                            self.failovers += 1
                        self._note_failover_waste(req)
                        continue
                    self.telemetry.finished(tr, handle, "error")
                    handle._finish("error")
                    return
                ticket = getattr(handle, "_migration", None)
                if finish == "cancelled" and ticket is not None:
                    # not a client cancel: migrate_out cancelled the donor
                    # stream — finish the request on the destination
                    finish = self._migrate_continue(
                        handle, ticket, tr, donor=replica)
                    handle._migration = None
                elif finish in ("stop", "length"):
                    # the replica now holds this prompt's prefix KV (the
                    # engine stores it at release) — record the fact so
                    # later placement follows it
                    self._note_prefix(req.prompt, replica.id)
                now = time.monotonic()
                self.slo.observe(
                    replica.id,
                    ttft_ms=((handle.t_first_token - t_dispatch) * 1e3
                             if handle.t_first_token is not None else None),
                    e2e_ms=(now - t_dispatch) * 1e3,
                    error=finish == "error",
                )
                self.telemetry.finished(tr, handle, finish)
                handle._finish(finish)
                return
        finally:
            self._active.pop(handle.id, None)
            self.watchdog.disarm(self._wd_channel)
            with self._lock:
                self._inflight -= 1

    def _note_failover_waste(self, req: GenRequest) -> None:
        """Waste decomposition (obs.ledger): a failover throws away the
        failed replica's prefill work — the re-dispatch re-prefills the
        whole prompt somewhere else. Charged in prompt tokens to the
        request's tenant (which also stamps the front-door feed, so this
        drill-down never double-counts delivered tokens)."""
        obs_ledger.LEDGER.note_waste(
            "failover_reprefill", tokens=len(req.prompt),
            model=self._owner.name, tenant=req.tenant, requests=1)

    def _dispatch(self, handle: WorkerGenHandle, replica, tr,
                  req: Optional[GenRequest] = None) -> str:
        """One streaming attempt against one replica. Raises on transport
        failure (the caller decides whether failover is still safe).
        ``req`` overrides the handle's request (migration continuations
        dispatch a rewritten request through the original handle)."""
        req = handle.request if req is None else req
        opts = predict_options(req)
        replica.begin()
        error = True
        try:
            if tr is not None:
                tr.begin("rpc", replica=replica.id)
            # every dispatch stream — local or remote — runs through the
            # bounded pump: explicit per-reply deadline, and the
            # fleet.transport chaos site fires at the same layer a real
            # NIC would fail
            finish, got_final = consume_stream(
                handle,
                net.bounded_stream(
                    replica.predict_stream(
                        opts, trace_id=req.trace_id or req.correlation_id,
                        tenant=req.tenant),
                    self.rpc_timeout_s, rid=replica.id),
                watchdog=self.watchdog, channel=self._wd_channel, tr=tr)
            if not got_final:
                # the stream went away without a final usage reply — a
                # dying replica, not a completed generation
                raise RuntimeError(
                    f"stream from {replica.id} ended without a final reply")
            error = finish == "error"
            return finish
        finally:
            if tr is not None:
                tr.end("rpc")
            replica.done(error=error)

    def _disaggregate(self, req: GenRequest, decode, tr) -> bool:
        """Prefill replica → TransferPrefix → decode replica's cache. Best
        effort: any failure falls back to a plain dispatch (the decode
        replica prefills itself, exactly as without disaggregation)."""
        pre = self.pool.least_loaded("prefill")
        if pre is None:
            return False
        opts = predict_options(req)
        trace_id = req.trace_id or req.correlation_id
        nbytes = 0
        if tr is not None:
            tr.begin("prefix_transfer", prefill=pre.id, decode=decode.id)
            # disagg requests span TWO replicas — record the prefill half
            # so the harvest stitches both panes into one waterfall
            tr.annotate(prefill_replica=pre.id)
        ok = False
        # the export is materialized before the decode-side call so a
        # failure is charged to the replica that actually failed: lazy
        # relaying would surface a dying prefill iterator as a transfer
        # RPC error on the decode side (and vice versa). The buffered
        # chunks are the same arrays the prefill replica already holds in
        # its prefix cache — one transient copy, bounded by the export.
        blame = pre
        try:
            pre.begin()
            pre_err = True
            try:
                chunks = []
                # bounded pump: a partitioned prefill replica surfaces as
                # RpcDeadlineExceeded here (charged to `pre`), never as a
                # silently hung handoff
                for c in net.bounded_stream(
                        pre.prefill_prefix(opts, trace_id=trace_id),
                        self.rpc_timeout_s, rid=pre.id):
                    nbytes += len(
                        c["data"] if isinstance(c, dict) else c.data)
                    self.watchdog.pulse(self._wd_channel)
                    chunks.append(c)
                pre_err = False
            finally:
                pre.done(error=pre_err)
            blame = decode
            # importing a prefix is idempotent (a re-store of the same
            # rows is a no-op on the peer), so the transfer gets the
            # bounded jittered retry a flaky link deserves — the buffered
            # chunk list re-streams cleanly
            res = net.call_with_retries(
                lambda: decode.transfer_prefix(iter(chunks),
                                               trace_id=trace_id,
                                               timeout=self.rpc_timeout_s),
                rid=decode.id, what="transfer_prefix")
            ok = bool(getattr(res, "success", False))
        except Exception as e:  # noqa: BLE001 — disagg is an optimization
            if isinstance(e, net.RpcDeadlineExceeded):
                REGISTRY.fleet_rpc_deadlines.inc(model=self._owner.name)
            log.warning(
                "fleet %s: disaggregated prefill %s→%s failed on %s (%s); "
                "falling back to direct dispatch",
                self._owner.name, pre.id, decode.id, blame.id, e)
            self.slo.observe(blame.id, error=True)
            self.pool.note_failure(blame)
        finally:
            if tr is not None:
                tr.end("prefix_transfer", ok=ok, bytes=nbytes)
        if ok:
            with self._lock:
                self.prefix_transfers += 1
                self.prefix_transfer_bytes += nbytes
            REGISTRY.fleet_prefix_transfers.inc(model=self._owner.name)
            REGISTRY.fleet_prefix_transfer_bytes.inc(
                nbytes, model=self._owner.name)
            # the decode replica now holds the transferred prefix
            self._note_prefix(req.prompt, decode.id)
        else:
            with self._lock:
                self.disagg_fallbacks += 1
        return ok

    # -- KV economy: directory, sibling fetch, live migration -------------

    def _note_prefix(self, prompt: list, rid: str) -> None:
        """Record in the fleet directory that ``rid`` holds ``prompt``'s
        prefix KV (same key granularity the router's affinity uses)."""
        if self.directory is None:
            return
        self.directory.note(
            affinity_key(prompt, block_tokens=self.router.block_tokens,
                         blocks=self.router.affinity_blocks), rid)

    def _sibling_fetch(self, req: GenRequest, target, tr) -> bool:
        """Directory-driven warm-up: when placement lands a request away
        from its warm KV, pull the prefix from the holding sibling over
        TransferPrefix before dispatching — one bulk copy instead of a
        re-prefill. Best effort: a stale directory entry (replica-side
        LRU eviction, a dying donor) costs one failed fetch, after which
        the entry is dropped and the plain dispatch prefills as usual —
        never a request error."""
        if self.directory is None:
            return False
        key = affinity_key(req.prompt, block_tokens=self.router.block_tokens,
                           blocks=self.router.affinity_blocks)
        if key is None:
            return False
        donor_id = self.directory.holder(
            key, (r.id for r in self.pool.healthy("decode")),
            exclude=(target.id,))
        if donor_id is None:
            return False
        donor = self.pool.get(donor_id)
        if donor is None or donor.state != "healthy":
            return False
        trace_id = req.trace_id or req.correlation_id
        nbytes = 0
        ok = False
        if tr is not None:
            tr.begin("sibling_fetch", donor=donor.id, target=target.id)
        try:
            if _faults.ACTIVE:
                # chaos: the donor dies mid-fetch — this leg must degrade
                # to a plain re-prefill, never fail the request
                _faults.apply("fleet.sibling", key=donor.id)
            chunks = donor.export_cached(req.prompt, trace_id=trace_id)
            if chunks is None:
                # no cache-peek surface (client-backed donor) or the
                # cached entry diverged: re-prefill ON THE DONOR — its
                # paged prefix pool makes this mostly block reuse — and
                # stream the rows over, same as the disagg export
                opts = predict_options(req)
                donor.begin()
                derr = True
                try:
                    chunks = []
                    for c in net.bounded_stream(
                            donor.prefill_prefix(opts, trace_id=trace_id),
                            self.rpc_timeout_s, rid=donor.id):
                        self.watchdog.pulse(self._wd_channel)
                        chunks.append(c)
                    derr = False
                finally:
                    donor.done(error=derr)
            if not chunks:
                raise RuntimeError("donor exported no prefix chunks")
            nbytes = sum(len(c["data"] if isinstance(c, dict) else c.data)
                         for c in chunks)
            res = net.call_with_retries(
                lambda: target.transfer_prefix(iter(chunks),
                                               trace_id=trace_id,
                                               timeout=self.rpc_timeout_s),
                rid=target.id, what="transfer_prefix")
            ok = bool(getattr(res, "success", False))
            if not ok:
                raise RuntimeError("target refused the prefix transfer")
        except Exception as e:  # noqa: BLE001 — the fetch is an optimization
            if isinstance(e, net.RpcDeadlineExceeded):
                REGISTRY.fleet_rpc_deadlines.inc(model=self._owner.name)
            log.warning(
                "fleet %s: sibling prefix fetch %s→%s failed (%s); "
                "dropping directory entry, falling back to local prefill",
                self._owner.name, donor.id, target.id, e)
            self.directory.drop(key, donor.id)
            with self._lock:
                self.sibling_fallbacks += 1
            REGISTRY.fleet_sibling_fallbacks.inc(model=self._owner.name)
        finally:
            if tr is not None:
                tr.end("sibling_fetch", ok=ok, bytes=nbytes)
        if ok:
            with self._lock:
                self.sibling_transfers += 1
                self.sibling_transfer_bytes += nbytes
            REGISTRY.fleet_sibling_transfers.inc(model=self._owner.name)
            REGISTRY.fleet_sibling_transfer_bytes.inc(
                nbytes, model=self._owner.name)
            self.directory.note(key, target.id)
        return ok

    def migrate_inflight(self, handle: WorkerGenHandle,
                         dest_id: Optional[str] = None,
                         timeout: float = 30.0) -> bool:
        """Move an in-flight request to another replica at its next
        dispatch boundary (operator drain, rebalancing, chaos drills).
        Blocks until the migration resolves; True only when the request
        actually continued on the destination. Safe to call from any
        thread — the dispatch thread owns the request lifecycle
        throughout."""
        req = handle.request
        if req.constraint is not None:
            # the destination would recompile the grammar FSM from
            # position 0 over a prompt that already contains donor
            # generations — constrained requests stay put
            return False
        entry = self._active.get(handle.id)
        if entry is None or handle.finish_reason is not None:
            return False
        donor = entry[1]
        dests = [r for r in self.pool.healthy("decode") if r.id != donor.id]
        if dest_id is not None:
            dests = [r for r in dests if r.id == dest_id]
        if not dests:
            return False
        dest = min(dests, key=lambda r: r.load)
        ticket = MigrationTicket(dest.id)
        # stake BEFORE cancelling: the dispatch thread must find the
        # ticket when the donor's "cancelled" final reply unwinds
        handle._migration = ticket
        out = None
        try:
            out = donor.migrate_out(req.correlation_id, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — donor export ≠ request
            ticket.fail(str(e))
        if out is not None:
            ticket.chunks = out.get("chunks")
            ticket.full_tokens = out.get("tokens")
            ticket.donor_tokens = int(out.get("generated") or 0)
            ticket.ready.set()
        elif not ticket.error:
            # the donor doesn't know this request (already finished, or a
            # replica kind without a migration surface) and nothing was
            # cancelled: unstake so a later genuine client cancel isn't
            # misread as a migration
            handle._migration = None
            return False
        if not ticket.completed.wait(timeout):
            return False
        return ticket.outcome == "migrated"

    def drain(self, rid: str, timeout: float = 30.0) -> dict:
        """Migrate every in-flight request off replica ``rid`` (drain-free
        shutdown / rebalancing). Returns {"moved": n, "failed": n}."""
        moved = failed = 0
        for _, entry in list(self._active.items()):
            handle, replica = entry
            if replica.id != rid or handle.finish_reason is not None:
                continue
            if self.migrate_inflight(handle, timeout=timeout):
                moved += 1
            else:
                failed += 1
        return {"moved": moved, "failed": failed}

    def _migrate_continue(self, handle: WorkerGenHandle,
                          ticket: MigrationTicket, tr, donor) -> str:
        """Dispatch-thread half of a live migration: the donor stream just
        unwound "cancelled" with ``ticket`` staked. Transfer the exported
        KV into the destination and re-dispatch a continuation (full token
        record as prompt, remaining budget); every failure leg falls back
        to a correct full re-prefill — slow, never lossy. Returns the
        request's final finish reason."""
        req = handle.request
        if tr is not None:
            tr.begin("migrate", donor=donor.id, dest=ticket.dest_id)
        try:
            if not ticket.ready.wait(30.0) or ticket.error \
                    or not ticket.full_tokens:
                return self._migration_fallback(
                    handle, ticket, tr,
                    ticket.error or "donor export timed out")
            cont = continuation_request(req, ticket.full_tokens,
                                        ticket.donor_tokens)
            if cont.max_new_tokens <= 0:
                # the donor spent the whole budget before the boundary:
                # the move is complete with nothing left to generate
                self._finish_migration(handle, ticket, req, 0)
                return "length"
            dest = self.pool.get(ticket.dest_id)
            targets = ([dest] if dest is not None
                       and dest.state == "healthy" else [])
            # the continuation is self-contained (full token record), so
            # any healthy sibling can finish it if the preferred
            # destination died between staking and transfer
            targets += [r for r in self.pool.healthy("decode")
                        if r.id != donor.id
                        and all(r.id != t.id for t in targets)]
            trace_id = req.trace_id or req.correlation_id
            for dest in targets[:2]:
                n_text = len(handle.text)
                try:
                    if ticket.chunks:
                        # best effort: a failed import only costs the
                        # destination a re-prefill of the token record
                        try:
                            dest.transfer_prefix(
                                iter(ticket.chunks), trace_id=trace_id,
                                timeout=self.rpc_timeout_s)
                        except Exception as e:  # noqa: BLE001
                            log.warning(
                                "fleet %s: migration KV transfer to %s "
                                "failed (%s); destination will re-prefill",
                                self._owner.name, dest.id, e)
                    self._active[handle.id] = (handle, dest)
                    finish = self._dispatch(handle, dest, tr, req=cont)
                    self._finish_migration(
                        handle, ticket, req,
                        getattr(handle, "_completion_override", None) or 0)
                    self._note_prefix(req.prompt, dest.id)
                    return finish
                except Exception as e:  # noqa: BLE001 — dest ≠ request
                    self.slo.observe(dest.id, error=True)
                    self.pool.note_failure(dest)
                    log.warning(
                        "fleet %s: migration continuation on %s failed "
                        "(%s)", self._owner.name, dest.id, e)
                    if len(handle.text) > n_text:
                        # this continuation streamed deltas before dying —
                        # a retry would replay text
                        ticket.finish("error")
                        return "error"
            return self._migration_fallback(
                handle, ticket, tr, "no destination could continue")
        finally:
            if tr is not None:
                tr.end("migrate", outcome=ticket.outcome)

    def _finish_migration(self, handle: WorkerGenHandle,
                          ticket: MigrationTicket, req: GenRequest,
                          cont_tokens: int) -> None:
        """Splice usage across the boundary: the client sees ONE request
        — donor tokens + destination tokens, and the ORIGINAL prompt
        length (the continuation's inflated prompt is an implementation
        detail)."""
        handle._completion_override = ticket.donor_tokens + cont_tokens
        handle.prompt_tokens = len(req.prompt)
        with self._lock:
            self.migrations += 1
        REGISTRY.fleet_migrations.inc(model=self._owner.name)
        ticket.finish("migrated")

    def _migration_fallback(self, handle: WorkerGenHandle,
                            ticket: MigrationTicket, tr, why: str) -> str:
        """The migration could not complete. If nothing reached the
        client yet the original request re-dispatches from scratch
        (correct, just slower); a half-streamed request cannot be
        replayed and finishes ``error``."""
        with self._lock:
            self.migration_fallbacks += 1
        REGISTRY.fleet_migration_fallbacks.inc(model=self._owner.name)
        # waste decomposition (obs.ledger): the fallback throws the
        # donor's exported KV away and re-prefills the prompt from scratch
        obs_ledger.LEDGER.note_waste(
            "migration_reprefill", tokens=len(handle.request.prompt),
            model=self._owner.name, tenant=handle.request.tenant,
            requests=1)
        log.warning("fleet %s: live migration of request %d fell back "
                    "(%s)", self._owner.name, handle.id, why)
        ticket.finish("fallback")
        if handle.t_first_token is not None:
            return "error"
        try:
            replica, _ = self.router.route(handle.request.prompt,
                                           failover=True)
            REGISTRY.fleet_routed.inc(model=self._owner.name,
                                      reason="failover")
            self._active[handle.id] = (handle, replica)
            return self._dispatch(handle, replica, tr)
        except Exception as e:  # noqa: BLE001
            log.warning("fleet %s: post-migration re-dispatch failed (%s)",
                        self._owner.name, e)
            return "error"

    # -- observability / lifecycle ----------------------------------------

    def metrics(self) -> dict:
        """Aggregate engine metrics across healthy replicas (the shape
        update_engine_gauges understands) + the fleet's own stats. Pulls
        one stats RPC per replica — scrape-path only, never the dispatch
        path."""
        totals = {"total_prompt_tokens": 0, "total_generated_tokens": 0,
                  "queue_depth": 0, "dispatches": 0, "preemptions": 0,
                  "prefix_tokens_reused": 0}
        # host-RAM KV tier roll-up (only exported when some replica has a
        # tier attached — worker dicts without the keys stay invisible)
        tier = {"kv_tier_blocks": 0, "kv_tier_bytes": 0,
                "kv_tier_spills": 0, "kv_tier_reloads": 0}
        tiered = False
        occ = []
        kvu = []
        per_replica: dict[str, dict] = {}
        for r in self.pool.members():
            if r.state != "healthy":
                per_replica[r.id] = {"state": r.state}
                continue
            m = r.metrics()
            per_replica[r.id] = m
            if "error" in m and len(m) == 1:
                continue
            for k in totals:
                totals[k] += m.get(k, 0) or 0
            if "kv_tier_spills" in m:
                tiered = True
                for k in tier:
                    tier[k] += m.get(k, 0) or 0
            if m.get("occupancy") is not None:
                occ.append(m["occupancy"])
            if m.get("kv_utilization") is not None:
                kvu.append(m["kv_utilization"])
        if tiered:
            totals.update(tier)
        with self._lock:
            fleet = {
                "replicas": self.pool.states(),
                "respawns": self.pool.respawns,
                "failovers": self.failovers,
                "prefix_transfers": self.prefix_transfers,
                "prefix_transfer_bytes": self.prefix_transfer_bytes,
                "disagg_fallbacks": self.disagg_fallbacks,
                "sibling_transfers": self.sibling_transfers,
                "sibling_transfer_bytes": self.sibling_transfer_bytes,
                "sibling_fallbacks": self.sibling_fallbacks,
                "migrations": self.migrations,
                "migration_fallbacks": self.migration_fallbacks,
                **self.router.snapshot(),
            }
            shed = self.shed_total
        if self.directory is not None:
            fleet["directory"] = self.directory.stats()
        return {
            **totals,
            "occupancy": sum(occ) / len(occ) if occ else 0.0,
            "kv_utilization": sum(kvu) / len(kvu) if kvu else 0.0,
            "shed_total": shed,
            "fleet": fleet,
            "replica_metrics": per_replica,
        }

    def export_gauges(self) -> None:
        """Scrape-time refresh of the fleet gauge family."""
        states = self.pool.states()
        for state in ("starting", "healthy", "dead", "respawning",
                      "evicted"):
            REGISTRY.fleet_replicas.set(
                states.get(state, 0), model=self._owner.name, state=state)
        auto = getattr(self._owner, "autoscaler", None)
        if auto is not None:
            REGISTRY.fleet_target_replicas.set(
                auto.target, model=self._owner.name)
        if self.directory is not None:
            st = self.directory.stats()
            REGISTRY.fleet_directory_entries.set(
                st["entries"], model=self._owner.name)
            REGISTRY.fleet_directory_hits.set_total(
                st["hits"], model=self._owner.name)
            REGISTRY.fleet_directory_misses.set_total(
                st["misses"], model=self._owner.name)
            REGISTRY.fleet_directory_drops.set_total(
                st["drops"] + st["invalidations"],
                model=self._owner.name)

    def shutdown(self, timeout: float = 10.0) -> None:
        self.pool.shutdown()


class FleetServingModel:
    """The serving-model facade over a replica fleet (what the manager's
    ``_load_fleet`` returns in place of one engine's ServingModel)."""

    def __init__(self, mcfg: ModelConfig, app: AppConfig, factory,
                 *, replicas: int, prefill_replicas: int = 0,
                 disagg_threshold: Optional[int] = None,
                 rpc_timeout_s: Optional[float] = None,
                 remote_hosts: Optional[list[str]] = None):
        from localai_tpu_torch.fleet.replica import RemoteReplica
        from localai_tpu_torch.models.registry import resolve_tokenizer
        from localai_tpu_torch.templates.cache import TemplateCache

        self.name = mcfg.name
        self.config = mcfg
        self.app = app
        self.tokenizer = resolve_tokenizer(
            mcfg.model or mcfg.name, app.model_path)
        self.templates = TemplateCache(app.model_path)
        self.vision = None
        self.image_token_id = 0
        if mcfg.mmproj:
            log.warning(
                "model %s: mmproj is not supported on fleet-served models "
                "yet; images will be ignored", mcfg.name)
        # per-replica SLO observatory driving route-around: app-config
        # latency targets when set; otherwise an error-rate-only objective
        # (events are bad only on transport/engine errors, so a replica
        # sheds from routing when >threshold× its error budget burns)
        targets = targets_from_config(app) or {"e2e_ms": float("inf")}
        self.slo = SLOTracker(targets=targets)
        # decode-admission hint: affinity placement degrades to
        # least-loaded when the target replica's monitor-reported decode
        # queue depth exceeds LOCALAI_FLEET_QUEUE_OVERRIDE (0 = off)
        try:
            queue_override = int(os.environ.get(
                "LOCALAI_FLEET_QUEUE_OVERRIDE", "0") or 0)
        except ValueError:
            queue_override = 0
        # every host:port of remote_hosts (default: the app's fleet_hosts)
        # is adopted as a RemoteReplica: the same routing surface, but
        # evicted and redialed on failure instead of respawned
        hosts = (remote_hosts if remote_hosts is not None
                 else list(app.fleet_hosts or []))
        remotes = [RemoteReplica(f"{mcfg.name}/{host}", "decode", host,
                                 mcfg, app) for host in hosts]
        self.pool = ReplicaPool(
            mcfg.name, factory,
            replicas=replicas, prefill_replicas=prefill_replicas,
            track_queue_depth=queue_override > 0, remotes=remotes,
        )
        self.pool.start()
        from localai_tpu_torch.engine.paged import block_tokens_default

        bt = mcfg.engine.kv_block_tokens or block_tokens_default()
        # fleet prefix directory: the RECORD of which replica holds which
        # prefix blocks (kveconomy). The router probes it for placement;
        # the scheduler writes it and pulls KV from siblings against it;
        # replica death invalidates every entry naming the corpse (a
        # respawned engine boots cold — the old entries are lies)
        self.directory = PrefixDirectory()
        self.pool.add_death_listener(self.directory.drop_replica)
        self.router = Router(self.pool, self.slo, block_tokens=bt,
                             queue_override=queue_override,
                             directory=self.directory)
        self.scheduler = FleetScheduler(
            self, self.pool, self.router, self.slo,
            disagg_threshold=(disagg_threshold
                              if disagg_threshold is not None
                              else app.fleet_disagg_threshold),
            rpc_timeout_s=(rpc_timeout_s if rpc_timeout_s is not None
                           else getattr(app, "fleet_rpc_timeout_s", None)),
        )
        # hot-swap surface: the pool factory reads its model config
        # through this mutable holder (manager rebinds it here), so a
        # runtime spawn after a checkpoint swap boots the NEW weights;
        # the autoscaler is attached by the manager when enabled
        self.cfg_ref = {"mcfg": mcfg}
        self.autoscaler = None
        self.loaded_at = time.monotonic()
        self.last_used = time.monotonic()

    def adopt_remote(self, address: str, role: str = "decode") -> dict:
        """Adopt a remote worker at ``address`` into this fleet's pool (the
        ``POST /federated/register`` join). The dial and LoadModel run
        inline, so the caller gets the verdict; a peer that fails its
        first dial lands in the eviction and redial loop."""
        from localai_tpu_torch.fleet.replica import RemoteReplica

        rid = f"{self.name}/{address}"
        replica = RemoteReplica(rid, role, address, self.config, self.app)
        adopted = self.pool.adopt(replica, wait=True)
        current = self.pool.get(rid)
        return {
            "id": rid,
            "adopted": adopted,
            "state": current.state if current is not None else "unknown",
        }

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def alive(self) -> bool:
        """The fleet self-heals dead replicas; the facade only dies when
        its monitor is gone (manager then rebuilds the whole fleet)."""
        mon = self.pool._monitor
        return mon is not None and mon.is_alive()

    def engine_metrics(self) -> dict:
        return self.scheduler.metrics()

    def fleet_status(self) -> dict:
        """The /v1/fleet payload for this model."""
        return {
            **self.pool.snapshot(with_metrics=True),
            "router": self.router.snapshot(),
            "disagg_threshold": self.scheduler.disagg_threshold,
            "failovers": self.scheduler.failovers,
            "prefix_transfers": self.scheduler.prefix_transfers,
            "prefix_transfer_bytes": self.scheduler.prefix_transfer_bytes,
            "disagg_fallbacks": self.scheduler.disagg_fallbacks,
            "directory": self.directory.stats(),
            "sibling_transfers": self.scheduler.sibling_transfers,
            "sibling_transfer_bytes":
                self.scheduler.sibling_transfer_bytes,
            "sibling_fallbacks": self.scheduler.sibling_fallbacks,
            "migrations": self.scheduler.migrations,
            "migration_fallbacks": self.scheduler.migration_fallbacks,
            "shedding": {
                r.id: self.slo.shedding(r.id) for r in self.pool.members()
            },
            "autoscale": (self.autoscaler.snapshot()
                          if self.autoscaler is not None
                          else {"enabled": False}),
        }

    def swap(self, checkpoint: Optional[str] = None,
             *, timeout: float = 30.0) -> dict:
        """Hot weight swap (POST /v1/fleet/{model}/swap): boot fresh
        replicas — on ``checkpoint`` when given — shift traffic, drain
        and retire the old generation."""
        from localai_tpu_torch.fleet.autoscale import hot_swap

        return hot_swap(self, checkpoint, timeout=timeout)

    def close(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.pool.shutdown()
