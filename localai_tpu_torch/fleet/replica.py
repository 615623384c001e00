"""One engine replica: lifecycle state, dial bookkeeping, dispatch surface.

Port of ``localai_tpu/fleet/replica.py``. Three kinds behind one surface:

  * :class:`WorkerReplica` — a spawned worker process (``worker.process.
    WorkerProcess`` + ``worker.client.WorkerClient``): crash isolation a
    replica, device pinning through the spawn environment, KV prefixes
    crossing the wire as ``PrefixChunk`` streams;
  * :class:`RemoteReplica` — an externally managed worker dialed at
    ``host:port`` (``fleet_hosts`` or a ``POST /federated/register``
    join): the same client, but not respawnable, so a failed remote is
    evicted from routing and redialed on backoff;
  * :class:`InProcessReplica` — a full engine (``models.manager.
    build_serving_model``) inside this process, with the same reply and
    chunk schema (``worker.server.gen_request_from_options`` decodes
    every request). It holds its own weights and KV pool on the card;
    ``stop()`` drops them.

States: ``starting`` → ``healthy`` ⇄ ``dead`` → ``respawning`` →
``healthy`` for replicas this process owns; remotes flip ``healthy`` ⇄
``evicted`` (a redial instead of a respawn). "Shedding" is not a stored
state: it is derived per route from the fleet's per-replica SLO tracker
(``fleet.router``)."""

from __future__ import annotations

import gc
import logging
import queue
import threading
import time
from types import SimpleNamespace
from typing import Any, Iterator, Optional

from localai_tpu_torch.faults import registry as _faults

log = logging.getLogger(__name__)

STARTING = "starting"
HEALTHY = "healthy"
DEAD = "dead"
RESPAWNING = "respawning"
# a remote replica out of routing after failed dials: the pool redials it
# on backoff, never (re)spawns a process it does not own
EVICTED = "evicted"


class _Reply:
    """A ``Reply``-shaped stream element from an in-process replica."""

    __slots__ = ("message", "tokens", "prompt_tokens", "finish_reason")

    def __init__(self, message: bytes = b"", tokens: int = 0,
                 prompt_tokens: int = 0, finish_reason: str = ""):
        self.message = message
        self.tokens = tokens
        self.prompt_tokens = prompt_tokens
        self.finish_reason = finish_reason


class BaseReplica:
    """Shared lifecycle and accounting; subclasses provide transport."""

    # False on replicas whose process this server does not own (remotes):
    # the pool evicts and redials them instead of stop() + respawn
    respawnable = True

    def __init__(self, rid: str, role: str):
        self.id = rid
        self.role = role                  # "decode" | "prefill"
        self.state = STARTING
        self._lock = threading.Lock()
        self.inflight = 0
        self.dispatched = 0               # lifetime requests routed here
        self.errors = 0                   # request-level failures
        self.failures = 0                 # consecutive dial failures
        self.dial_seconds: Optional[float] = None
        self.checked_mono: Optional[float] = None
        self.started_at = time.monotonic()
        # removed from the pool on purpose (autoscale scale-in, hot swap):
        # an in-flight respawn thread parks it instead of resurrecting it
        self.retired = False
        # last-dispatch clocks: monotonic drives the idle_s policy signal,
        # wall time is the readable export of GET /v1/fleet. A replica
        # that never served reads idle since boot
        self.last_dispatch_mono = self.started_at
        self.last_dispatch_wall: Optional[float] = None
        # last reported decode queue depth (monitor-refreshed when the
        # pool tracks it; the router's queue-override hint reads it)
        self.queue_depth = 0

    # -- accounting (the router reads these for least-loaded) -------------

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1
            self.dispatched += 1
            self.last_dispatch_mono = time.monotonic()
            self.last_dispatch_wall = time.time()

    def done(self, *, error: bool = False) -> None:
        with self._lock:
            self.inflight -= 1
            if error:
                self.errors += 1

    @property
    def load(self) -> tuple[int, int]:
        """Least-loaded sort key: (inflight, lifetime dispatched)."""
        with self._lock:
            return (self.inflight, self.dispatched)

    # -- health dial (consecutive failures, dial timing) -------------------

    def dial(self, timeout: float = 2.0) -> bool:
        t0 = time.monotonic()
        try:
            if _faults.ACTIVE:
                # an unreachable peer as the monitor sees it, keyed by
                # replica id so a schedule can partition one peer
                _faults.apply("fleet.dial", key=self.id)
            ok = self._dial(timeout)
        except Exception:  # noqa: BLE001 — a dial failing IS the signal
            ok = False
        self.dial_seconds = round(time.monotonic() - t0, 4)
        self.checked_mono = time.monotonic()
        if ok:
            self.failures = 0
            if self.state in (STARTING, RESPAWNING):
                self.state = HEALTHY
        else:
            self.failures += 1
        return ok

    def idle_s(self) -> float:
        """Seconds since the last request was dispatched here (or since
        boot): the autoscale policy's scale-in signal. 0 while anything is
        in flight."""
        with self._lock:
            if self.inflight > 0:
                return 0.0
            return max(0.0, time.monotonic() - self.last_dispatch_mono)

    def snapshot(self) -> dict:
        with self._lock:
            inflight, dispatched = self.inflight, self.dispatched
            errors = self.errors
            last_wall = self.last_dispatch_wall
            idle = (0.0 if inflight > 0
                    else max(0.0, time.monotonic() - self.last_dispatch_mono))
        return {
            "id": self.id,
            "role": self.role,
            "state": self.state,
            "inflight": inflight,
            "dispatched": dispatched,
            "errors": errors,
            "idle_s": round(idle, 1),
            "last_dispatch": last_wall,
            "dial_failures": self.failures,
            "dial_seconds": self.dial_seconds,
            "checked_age_s": (
                round(time.monotonic() - self.checked_mono, 1)
                if self.checked_mono is not None else None),
            "age_s": round(time.monotonic() - self.started_at, 1),
        }

    # -- transport (subclass responsibility) -------------------------------

    def start(self) -> None:
        raise NotImplementedError

    def _dial(self, timeout: float) -> bool:
        raise NotImplementedError

    def predict_stream(self, opts: Any, trace_id: str = "",
                       tenant: str = "") -> Iterator:
        raise NotImplementedError

    def prefill_prefix(self, opts: Any, trace_id: str = "") -> Iterator:
        raise NotImplementedError

    def transfer_prefix(self, chunks: Iterator, trace_id: str = "",
                        timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def export_cached(self, prompt: list,
                      trace_id: str = "") -> Optional[list]:
        """Sibling-fetch donor half: this replica's already-cached prefix
        rows for ``prompt`` as prefix chunks, without a prefill, or None
        when nothing matching is cached (the fleet then re-prefills on
        the donor)."""
        return None

    def migrate_out(self, corr_id: str,
                    timeout: float = 30.0) -> Optional[dict]:
        """Live-migration donor half: cancel the in-flight request with
        the KV-export flag set and return ``{"tokens": full token record,
        "generated": n, "chunks": prefix chunks or None}``, or None when
        the request is unknown here."""
        return None

    def metrics(self) -> dict:
        raise NotImplementedError

    def telemetry(self, trace_id: str = "", since: float = 0.0,
                  limit: int = 256, recent: int = 20) -> dict:
        """This replica's observability pane (``obs.fleetview`` payload).
        Never raises: a dead replica returns ``{"error", "unreachable"}``
        so the caller degrades that pane, not the endpoint."""
        raise NotImplementedError

    def process_alive(self) -> bool:
        """Cheap liveness without a dial."""
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class _ClientReplica(BaseReplica):
    """The transport of every client-backed replica (spawned worker
    processes and adopted remotes): the streaming dispatch, both halves of
    the prefix handoff, bounded stats pulls and the LoadModel handshake.
    Subclasses own the lifecycle (spawn or dial) and set ``_client``."""

    mcfg = None
    app = None
    _client = None

    def _load_model(self) -> None:
        from localai_tpu_torch.worker.serving import config_yaml

        res = self._client.load_model(
            config_yaml=config_yaml(self.mcfg),
            model_path=str(self.app.model_path))
        if not res.success:
            raise RuntimeError(
                f"replica {self.id} LoadModel failed: {res.message}")

    def _dial(self, timeout: float) -> bool:
        return self._client is not None and self._client.health(timeout)

    def predict_stream(self, opts, trace_id: str = "",
                       tenant: str = "") -> Iterator:
        return self._client.predict_stream(opts, trace_id=trace_id,
                                           tenant=tenant)

    def prefill_prefix(self, opts, trace_id: str = "") -> Iterator:
        return self._client.prefill_prefix(opts, trace_id=trace_id)

    def transfer_prefix(self, chunks, trace_id: str = "",
                        timeout: Optional[float] = None):
        from localai_tpu_torch.fleet import net
        from localai_tpu_torch.worker import backend_pb2 as pb

        def as_messages():
            for c in chunks:
                yield pb.PrefixChunk(**c) if isinstance(c, dict) else c

        # the transfer moves bulk KV rows: 4x the per-reply bound, never
        # the 600 s stream default on a partitioned peer. The fleet passes
        # its configured timeout; the environment is the fallback
        t = net.rpc_timeout_s() if timeout is None else timeout
        return self._client.transfer_prefix(
            as_messages(), timeout=(t * 4 if t > 0 else 600.0),
            trace_id=trace_id)

    def metrics(self) -> dict:
        try:
            # the scrape path: a wedged replica costs seconds
            return self._client.metrics(timeout=3.0)
        except Exception as e:  # noqa: BLE001 — stats pull ≠ serving
            return {"error": str(e)}

    def telemetry(self, trace_id: str = "", since: float = 0.0,
                  limit: int = 256, recent: int = 20) -> dict:
        from localai_tpu_torch.fleet import net

        try:
            # one bounded pull, no retries: the next refresh is the retry
            t = net.rpc_timeout_s()
            return self._client.get_telemetry(
                trace_id=trace_id, since=since, limit=limit, recent=recent,
                timeout=t if t > 0 else 60.0)
        except Exception as e:  # noqa: BLE001 — telemetry pull ≠ serving
            return {"error": str(e), "unreachable": True}


class WorkerReplica(_ClientReplica):
    """A replica backed by its own spawned worker process."""

    def __init__(self, rid: str, role: str, mcfg, app,
                 *, env: Optional[dict] = None):
        super().__init__(rid, role)
        self.mcfg = mcfg
        self.app = app
        self._env = dict(env or {})
        self._wp = None
        self._client = None
        # the kernel launch counts each stopped process reported (a
        # process killed with SIGKILL reports nothing)
        self.launch_reports: list[dict] = []

    def start(self) -> None:
        from localai_tpu_torch.worker.process import WorkerProcess

        self._wp = WorkerProcess(self.id, env=self._env or None)
        self._client = self._wp.start()
        self._load_model()

    @property
    def pid(self) -> Optional[int]:
        return self._wp.pid if self._wp is not None else None

    def process_alive(self) -> bool:
        return self._wp is not None and self._wp.alive

    def kill(self) -> None:
        """SIGKILL the worker (tests and failover drills)."""
        if self._wp is not None and self._wp.proc is not None:
            self._wp.proc.kill()

    def stop(self) -> None:
        if self._wp is not None:
            self._wp.stop()
            if self._wp.launch_report is not None:
                self.launch_reports.append(self._wp.launch_report)
            self._wp = None
            self._client = None


class RemoteReplica(_ClientReplica):
    """A replica served by an externally managed worker at ``host:port``.
    This process does not own its lifecycle (``respawnable = False``): on
    failed dials the pool evicts it from routing and redials on backoff.
    ``stop()`` only closes the client."""

    respawnable = False

    def __init__(self, rid: str, role: str, address: str,
                 mcfg=None, app=None, *, dial_timeout: float = 5.0):
        super().__init__(rid, role)
        self.address = address
        self.mcfg = mcfg
        self.app = app
        self.dial_timeout = dial_timeout
        self._client = None

    def start(self) -> None:
        """Dial (or redial): a fresh client, a health gate, and, because a
        redial may find a rebooted, empty worker, a Status check that
        re-issues LoadModel when the peer lost the model. Raises when the
        peer is unreachable; the pool turns that into an eviction and a
        backed-off redial."""
        from localai_tpu_torch.worker.client import WorkerClient

        if self._client is not None:
            self._client.close()
        self._client = WorkerClient(self.address)
        if not self._client.health(self.dial_timeout):
            raise RuntimeError(
                f"remote replica {self.id} at {self.address} is "
                "unreachable")
        if self.mcfg is not None:
            self._ensure_loaded()

    def _ensure_loaded(self) -> None:
        from localai_tpu_torch.fleet import net
        from localai_tpu_torch.worker import backend_pb2 as pb

        # Status carries no model identity (a worker holds one model), so
        # READY is taken as "holds this pool's model": the registration
        # refuses a join that two fleets could claim
        st = net.call_with_retries(
            lambda: self._client.status(timeout=self.dial_timeout),
            rid=self.id, what="status")
        if st.state in (pb.StatusResponse.READY, pb.StatusResponse.BUSY):
            return
        self._load_model()

    def process_alive(self) -> bool:
        """No local process to poll: the health dial is the only truth
        about a peer across a network."""
        return self._client is not None

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


class InProcessReplica(BaseReplica):
    """A replica owning a full in-process engine (factory → a
    ``models.manager.ServingModel``)."""

    def __init__(self, rid: str, role: str, factory):
        super().__init__(rid, role)
        self._factory = factory
        self.sm = None
        self._killed = False
        # start() and stop() take turns: a respawn's stop() waits for a
        # boot in progress and frees what it built, never orphans it
        self._life = threading.Lock()
        self._starting = False
        # correlation id → inner GenHandle while its stream is pumped: the
        # live-migration surface (migrate_out) finds the request here
        self._streaming: dict = {}

    def start(self) -> None:
        from localai_tpu_torch.fleet.prefix import PrefixCache

        with self._life:
            self._starting = True
            try:
                self._killed = False
                sm = self._factory()
                # both halves of the disaggregated handoff run through
                # this cache (export at release on prefill replicas,
                # import at admission on decode replicas); a configured
                # disk cache is layered under it
                sm.scheduler.attach_prompt_cache(PrefixCache(
                    min_prefix=getattr(sm.runner, "prefix_reuse_min", 16)),
                    layer=True)
                self.sm = sm
            finally:
                self._starting = False

    def _cache(self):
        return self.sm.scheduler.prompt_cache

    def _dial(self, timeout: float) -> bool:
        return (not self._killed and self.sm is not None
                and self.sm.scheduler.alive())

    def predict_stream(self, opts, trace_id: str = "",
                       tenant: str = "") -> Iterator:
        from localai_tpu_torch.worker.server import gen_request_from_options

        if self._killed:
            raise RuntimeError(f"replica {self.id} is dead")
        sm = self.sm
        # ``tenant`` is dropped on purpose: the fleet's dispatch thread
        # already feeds the usage ledger for the front-door request, and
        # stamping the inner resubmit too would count every token twice
        gr = gen_request_from_options(opts, sm, trace_id=trace_id)
        handle = sm.scheduler.submit(gr)
        if gr.correlation_id:
            self._streaming[gr.correlation_id] = handle
        try:
            while True:
                try:
                    # a bounded wait, so a kill() mid-stream surfaces as a
                    # transport error instead of parking on a queue the
                    # dead engine thread will never feed
                    item = handle._q.get(timeout=0.25)
                except queue.Empty:
                    if self._killed:
                        raise RuntimeError(
                            f"replica {self.id} died mid-stream")
                    continue
                if self._killed:
                    raise RuntimeError(f"replica {self.id} died mid-stream")
                if _faults.ACTIVE:
                    # an injected error or slowdown mid-stream, keyed by
                    # the replica id
                    _faults.apply("worker.stream", key=self.id)
                if item.finish_reason is not None:
                    yield _Reply(b"", handle.completion_tokens,
                                 handle.prompt_tokens, item.finish_reason)
                    break
                if item.delta:
                    yield _Reply(item.delta.encode("utf-8"))
        finally:
            if gr.correlation_id:
                self._streaming.pop(gr.correlation_id, None)
            if handle.finish_reason is None:
                handle.cancel()

    def prefill_prefix(self, opts, trace_id: str = "") -> Iterator:
        from localai_tpu_torch.fleet.prefix import export_prefix, pack_chunks
        from localai_tpu_torch.worker.server import gen_request_from_options

        if self._killed:
            raise RuntimeError(f"replica {self.id} is dead")
        sm = self.sm
        gr = gen_request_from_options(opts, sm, trace_id=trace_id)
        prompt, arrays = export_prefix(sm, gr, self._cache())
        yield from pack_chunks(prompt, arrays)

    def transfer_prefix(self, chunks, trace_id: str = "",
                        timeout: Optional[float] = None):
        # ``timeout`` is taken for the surface the fleet calls; an
        # in-process import has no wire to bound
        from localai_tpu_torch.fleet.prefix import import_prefix

        if self._killed:
            raise RuntimeError(f"replica {self.id} is dead")
        n = import_prefix(self._cache(), chunks)
        return SimpleNamespace(success=True, message=f"{n} rows")

    def export_cached(self, prompt: list,
                      trace_id: str = "") -> Optional[list]:
        from localai_tpu_torch.fleet.prefix import pack_chunks

        if self._killed or self.sm is None:
            return None
        cache = self._cache()
        if cache is None:
            return None
        hit = cache.lookup(list(prompt))
        # the winner must be a true prefix of the prompt: lookup can
        # return an entry that diverges past the common prefix, and its
        # arrays cover the entry's rows, not the common prefix
        if hit is None or list(hit.tokens) != list(prompt)[:len(hit.tokens)]:
            return None
        return list(pack_chunks(hit.tokens, hit.arrays,
                                transfer_id=trace_id))

    def migrate_out(self, corr_id: str,
                    timeout: float = 30.0) -> Optional[dict]:
        from localai_tpu_torch.fleet.prefix import pack_chunks

        ih = self._streaming.get(corr_id)
        if ih is None or self._killed or self.sm is None:
            return None
        # flag first, then cancel: the engine's release reads the flag,
        # keeps the generated tail and snapshots prompt + generation KV
        # into this replica's prefix cache (Scheduler._release)
        ih.migrate_export = True
        ih.cancel()
        try:
            ih.result(timeout)
        except TimeoutError:
            return None
        full = list(ih.request.prompt) + list(ih.token_ids)
        out = {"tokens": full, "generated": len(ih.token_ids),
               "chunks": None}
        cache = self._cache()
        if cache is None or len(full) < cache.min_prefix:
            return out  # nothing exportable: the destination re-prefills
        # the export lands off-thread (the prompt-cache writer), keyed by
        # the full token record (a migration keeps the generation)
        arrays = cache.wait_for(full, timeout=min(timeout, 10.0))
        tokens = full
        if arrays is None:
            # context-cap edge (or a racing store): take the longest
            # cached true prefix; the destination re-prefills the rest
            hit = cache.lookup(full)
            if hit is not None and list(hit.tokens) == full[:len(hit.tokens)]:
                tokens, arrays = list(hit.tokens), hit.arrays
        if arrays is not None:
            out["chunks"] = list(pack_chunks(tokens, arrays))
        return out

    def metrics(self) -> dict:
        if self.sm is None:
            return {"error": "not started"}
        return self.sm.scheduler.metrics()

    def telemetry(self, trace_id: str = "", since: float = 0.0,
                  limit: int = 256, recent: int = 20) -> dict:
        # in-process engines share the front door's trace store: the
        # stitcher dedupes harvested traces it already holds
        from localai_tpu_torch.obs.fleetview import telemetry_payload

        if self._killed or self.sm is None:
            return {"error": f"replica {self.id} is dead",
                    "unreachable": True}
        try:
            payload = telemetry_payload(
                self.sm.scheduler, trace_id=trace_id, since=since,
                limit=limit, recent=recent)
            payload["shared_store"] = True
            return payload
        except Exception as e:  # noqa: BLE001 — telemetry pull ≠ serving
            return {"error": str(e), "unreachable": True}

    def process_alive(self) -> bool:
        """The engine answers, or is being built: a replica booting its
        model is alive as a worker process is while it loads (the pool's
        monitor then counts failed dials against the threshold instead of
        declaring it dead and starting a second engine beside it)."""
        return self._starting or self._dial(0.0)

    def kill(self) -> None:
        """Simulate a replica crash: in-flight streams raise, dials fail,
        the engine thread stops (tests and failover drills)."""
        self._killed = True
        if self.sm is not None:
            self.sm.scheduler.shutdown(timeout=2.0)

    def stop(self) -> None:
        """Stop the engine and drop its weights and KV pool (on the card,
        ``torch.cuda.memory_allocated`` falls by both once no request
        holds them)."""
        with self._life:
            if self.sm is not None:
                self.sm.scheduler.shutdown()
                self.sm = None
                gc.collect()
