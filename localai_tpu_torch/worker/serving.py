"""Worker-backed serving: a serving-model facade over a worker process.

Port of ``localai_tpu/worker/serving.py``:

  * ``PredictOptions`` — the wire message of ``worker.backend_pb2`` (an
    unset optional field is ``None``), which in-process replicas take as
    they are and worker replicas send as bytes;
  * :class:`WorkerGenHandle` — a ``GenHandle`` fed from a reply stream
    instead of the engine thread, counting completion tokens from the
    final reply (or the streamed deltas when a replica died first);
  * :func:`predict_options` — GenRequest → ``PredictOptions`` (the inverse
    of ``worker.server.gen_request_from_options``). A constraint crosses
    as its source regex only; a constraint without one decodes
    unconstrained inside the replica, with a warning, as on the JAX
    package;
  * :func:`consume_stream` — the one place a reply stream is read into a
    handle (single workers here, replica fleets in ``fleet.serving``);
  * :class:`WorkerScheduler` / :class:`WorkerServingModel` — the
    ``backend: worker`` and ``external_backends`` path of one model: the
    tokenizer and templates resolve in this process, generation runs in
    the worker (spawned and respawned by ``worker.process.WorkerPool``, or
    an external address). A worker that fails to spawn or load is an
    error, never an in-process engine.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Optional

from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.obs import EngineTelemetry
from localai_tpu_torch.obs import watchdog as obs_watchdog
from localai_tpu_torch.worker import backend_pb2 as pb
# the request options of every replica kind: the wire message itself
from localai_tpu_torch.worker.backend_pb2 import PredictOptions  # noqa: F401
from localai_tpu_torch.worker.process import spawn_env

log = logging.getLogger(__name__)

_SAMPLING_FIELDS = (
    "temperature", "top_k", "top_p", "min_p",
    "repeat_penalty", "presence_penalty", "frequency_penalty", "seed",
)


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


def predict_options(gr: GenRequest):
    """GenRequest → ``PredictOptions`` (inverse of
    ``gen_request_from_options``)."""
    opts = pb.PredictOptions(
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
    decides whether that is a failover signal or an error."""
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


def config_yaml(mcfg) -> str:
    """A model config as the YAML a worker's ``LoadModel`` reads: the
    fields set away from their defaults, the name and the weights ref, and
    no ``backend`` (the worker runs the engine in its own process)."""
    from localai_tpu_torch.config.yaml_subset import safe_dump

    doc = _non_defaults(mcfg)
    doc["name"] = mcfg.name
    doc["model"] = mcfg.model or mcfg.name
    doc.pop("backend", None)
    return safe_dump(doc)


def _non_defaults(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            sub = _non_defaults(v)
            if sub:
                out[f.name] = sub
            continue
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = dataclasses.MISSING
        if v is not None and v != default:
            out[f.name] = v
    return out


class WorkerScheduler:
    """The scheduler-shaped surface of a worker-backed model: submit() runs
    a PredictStream call on a daemon thread feeding a GenHandle."""

    def __init__(self, owner: "WorkerServingModel"):
        self._owner = owner
        self._ids = itertools.count()
        self._inflight = 0
        self._lock = threading.Lock()
        # this side's view of the worker's requests: queued → rpc spans
        # here, the engine's spans in the worker under the same trace id
        self.telemetry = EngineTelemetry(model=owner.name)
        # a wedged worker stops the reply stream; the stall watchdog sees
        # that silence like any other stall
        self.watchdog = obs_watchdog.WATCHDOG
        self._wd_channel = f"rpc:{owner.name}"
        self.watchdog.start()
        # SLO admission-control rejections happen at the API tier
        self.shed_total = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def submit(self, gr: GenRequest) -> GenHandle:
        handle = WorkerGenHandle(gr, next(self._ids))
        handle.trace = self.telemetry.queued(handle)
        if gr.mm_embeds is not None:
            # image embeddings do not cross the wire: fail loudly rather
            # than serve text only
            self.telemetry.finished(handle.trace, handle, "error")
            handle._finish("error")
            log.error("worker-backed models do not support multimodal input")
            return handle
        # busy before the thread starts: an eviction sweep between submit()
        # and the thread's first instruction must not kill the worker
        with self._lock:
            self._inflight += 1
        threading.Thread(
            target=self._run, args=(handle,), daemon=True,
            name=f"worker-req-{handle.id}",
        ).start()
        return handle

    def _run(self, handle: WorkerGenHandle) -> None:
        tr = handle.trace
        self.watchdog.arm(self._wd_channel)
        try:
            client = self._owner.client()
            opts = predict_options(handle.request)
            req = handle.request
            if tr is not None:
                tr.end("queued")
                tr.begin("rpc", worker=client.address)
            finish, got_final = consume_stream(
                handle,
                client.predict_stream(
                    opts, timeout=600.0,
                    trace_id=req.trace_id or req.correlation_id,
                    tenant=req.tenant),
                watchdog=self.watchdog, channel=self._wd_channel, tr=tr)
            if not got_final:
                # the worker died mid-generation: the handle fails, its
                # completion count falls back to the streamed deltas
                finish = "error"
                log.warning(
                    "worker request %d: stream ended without a final "
                    "reply after %d deltas", handle.id,
                    handle._streamed_deltas)
            self.telemetry.finished(tr, handle, finish)
            handle._finish(finish)
        except Exception as e:  # noqa: BLE001 — worker crash ≠ API crash
            log.warning("worker request %d failed: %s", handle.id, e)
            self.telemetry.finished(tr, handle, "error")
            handle._finish("error")
        finally:
            self.watchdog.disarm(self._wd_channel)
            with self._lock:
                self._inflight -= 1

    def note_shed(self) -> None:
        """Record one API-level SLO admission rejection for this model."""
        with self._lock:
            self.shed_total += 1

    def metrics(self) -> dict:
        try:
            m = self._owner.client().metrics()
        except Exception as e:  # noqa: BLE001
            return {"error": str(e)}
        m["shed_total"] = self.shed_total
        return m

    def shutdown(self, timeout: float = 10.0) -> None:
        self._owner.close()


class WorkerServingModel:
    """The serving-model counterpart whose engine lives in a worker.

    Tokenization and templating stay here; generation calls go to the
    worker. The pool health-checks and respawns on access, and
    ``client()`` re-issues LoadModel after any respawn."""

    def __init__(self, mcfg, app, pool, *,
                 external_address: Optional[str] = None):
        from localai_tpu_torch.models.registry import resolve_tokenizer
        from localai_tpu_torch.templates.cache import TemplateCache

        self.name = mcfg.name
        self.config = mcfg
        self.app = app
        self.pool = pool
        self.external_address = external_address
        self.tokenizer = resolve_tokenizer(mcfg.model or mcfg.name,
                                           app.model_path)
        self.templates = TemplateCache(app.model_path)
        self.vision = None
        self.image_token_id = 0
        if mcfg.mmproj:
            log.warning(
                "model %s: mmproj is not supported on worker-backed models "
                "yet; images will be ignored", mcfg.name,
            )
        self.scheduler = WorkerScheduler(self)
        self.loaded_at = time.monotonic()
        self.last_used = time.monotonic()
        self._client_lock = threading.Lock()
        self._loaded_client = None
        self.client()  # spawn and load now, so config errors surface now

    # -- lifecycle ---------------------------------------------------------

    def client(self):
        """A healthy client of this model's worker: spawns or respawns
        through the pool, and loads the model into a fresh process."""
        with self._client_lock:
            if self.external_address is not None:
                c = self.pool.register_external(self.name,
                                                self.external_address)
            else:
                c = self.pool.get(self.name, env=spawn_env(
                    self.app.device, self.app.worker_env))
            # the pool hands back the same client while the worker stays
            # healthy; a new one means a respawn (an empty process). The
            # load runs under the lock: concurrent callers wait for it
            if c is not self._loaded_client:
                self._ensure_loaded(c)
                self._loaded_client = c
            return c

    def _ensure_loaded(self, c) -> None:
        st = c.status()
        if st.state in (pb.StatusResponse.READY, pb.StatusResponse.BUSY):
            return
        res = c.load_model(config_yaml=config_yaml(self.config),
                           model_path=str(self.app.model_path))
        if not res.success:
            raise RuntimeError(
                f"worker LoadModel failed for {self.name}: {res.message}")

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def alive(self) -> bool:
        """Cheap liveness, without a call (this runs under the manager's
        lock): a spawned worker's process poll; an external worker is
        taken as alive, its failures surface per request."""
        if self.external_address is not None:
            return True
        wp = self.pool.process(self.name)
        return wp is not None and wp.alive

    def engine_metrics(self) -> dict:
        return self.scheduler.metrics()

    def close(self) -> None:
        self.pool.shutdown(self.name)
