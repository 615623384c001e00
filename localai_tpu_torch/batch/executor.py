"""Background batch executor: drains JSONL jobs through the engine's
batch lane.

Port of ``localai_tpu/batch/executor.py``. One daemon thread owns the
whole offline workload:

  * claims the oldest runnable job from the :class:`~localai_tpu_torch.
    batch.store.BatchStore`, parses its input JSONL, and validates every
    line: bad JSON, a missing or duplicate ``custom_id``, an unsupported
    URL, or a body the JAX package's request schema would refuse becomes
    a durable error-file record, never a crash. The port has no pydantic:
    a body is checked and coerced by ``api.openai.request_body``, the
    validator of the interactive routes (the schema's field types under
    pydantic's lax coercions), and the coerced body is what runs. The
    error records equal the JAX package's in ``custom_id``,
    ``status_code``, ``error.code`` and order; a message differs only
    where the JAX one is pydantic's own wording (ROADMAP §C);
  * submits valid lines through ``Scheduler.submit`` at
    ``PRIORITY_BATCH`` with bounded in-flight concurrency
    (``--batch-concurrency``), so batch work only ever fills slots the
    interactive lane left idle;
  * pauses entirely while the SLO observatory reports overload shedding
    for the job's model: in-flight lines are cancelled and requeued
    (their slots free at once, nothing is recorded as failed),
    ``localai_batch_lane_paused`` flips to 1, and the lane resumes on its
    own when the observatory recovers;
  * appends one result record per line (flush + fsync before counting it
    done), so a crash loses at most the in-flight lines and a restarted
    executor resumes from the durable done-set
    (:meth:`BatchStore.done_custom_ids`).

Each job leaves a ``kind="batch"`` trace (validate/run spans, line
counts) in the trace store, and every drained line counts into
``localai_batch_lines_total{result=...}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from localai_tpu_torch.engine.scheduler import PRIORITY_BATCH
from localai_tpu_torch.obs import slo as obs_slo
from localai_tpu_torch.obs import trace as obs_trace
from localai_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)

SUPPORTED_URLS = ("/v1/chat/completions", "/v1/completions")


class LineError(ValueError):
    """A per-line validation failure (becomes an error-file record).

    ``custom_id`` carries the line's real custom_id whenever the line got
    far enough to declare one, so clients can reconcile error records
    against the ids they submitted; empty only for lines that are not
    valid JSON objects (those get a synthetic ``line-N`` id)."""

    def __init__(self, message: str, custom_id: str = ""):
        super().__init__(message)
        self.custom_id = custom_id


@dataclasses.dataclass
class LineRequest:
    """A validated input line's request: the model it names and its body
    (``stream`` forced off: there is no client to stream to)."""

    model: str
    body: dict
    stream: bool = False


def _count_lines(path) -> int:
    try:
        return sum(1 for line in path.read_text().splitlines()
                   if line.strip())
    except FileNotFoundError:
        return 0


def parse_line(raw: str, lineno: int, endpoint: str,
               seen: set[str]) -> tuple[str, LineRequest, dict]:
    """One input JSONL line → (custom_id, validated request, body dict).
    The request's body is the line's as ``api.openai.request_body``
    coerces it, the one the interactive routes submit. Raises
    :class:`LineError` with a client-readable message."""
    from localai_tpu_torch.api import openai as oa

    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise LineError(f"line {lineno}: invalid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise LineError(f"line {lineno}: not a JSON object")
    cid = str(obj.get("custom_id") or "")
    if not cid:
        raise LineError(f"line {lineno}: custom_id is required")
    if cid in seen:
        # deliberately not tagged with the real id: the first occurrence
        # owns it, and an error record carrying it would poison the
        # done-set (done_custom_ids reads the error file too)
        raise LineError(f"line {lineno}: duplicate custom_id {cid!r}")
    if (obj.get("method") or "POST").upper() != "POST":
        raise LineError(f"line {lineno}: method must be POST",
                        custom_id=cid)
    url = obj.get("url") or endpoint
    if url != endpoint:
        raise LineError(
            f"line {lineno}: url {url!r} does not match batch endpoint "
            f"{endpoint!r}", custom_id=cid)
    body = obj.get("body")
    if not isinstance(body, dict):
        raise LineError(f"line {lineno}: body must be a JSON object",
                        custom_id=cid)
    try:
        req = oa.request_body(body)
    except oa.APIError as e:
        raise LineError(f"line {lineno}: {e.message}",
                        custom_id=cid) from None
    if isinstance(req.get("prompt"), list):
        raise LineError(
            f"line {lineno}: list prompts are not supported in batch "
            "(one prompt per line)", custom_id=cid)
    return cid, LineRequest(model=req.get("model", "") or "",
                            body={**req, "stream": False}), body


class BatchExecutor:
    """The background-lane drain thread (one per process)."""

    def __init__(self, store, get_serving: Callable[[str], tuple[Any, Any]],
                 *, concurrency: int = 2, poll_s: float = 0.25,
                 deadline_s: Optional[float] = None,
                 slo: Optional[obs_slo.SLOTracker] = None,
                 registry=None, trace_store=None):
        self.store = store
        # model name → (serving model, model config); blocking (a lazy
        # weight load) — only ever called from this executor's thread
        self.get_serving = get_serving
        self.concurrency = max(1, concurrency)
        self.poll_s = poll_s
        # per-line wall-clock deadline (the interactive tier's request
        # deadline): on expiry the handle is cancelled, the line records a
        # timeout error, and the drain moves on even if the engine itself
        # never responds
        self.deadline_s = (deadline_s if deadline_s and deadline_s > 0
                           else 600.0)
        self.slo = slo or obs_slo.SLO
        self.registry = registry or REGISTRY
        self.trace_store = trace_store or obs_trace.STORE
        self._wake = threading.Event()
        self._stopping = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.paused = False  # mirror of the lane-paused gauge

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Idempotent thread start (the server calls it at boot when jobs
        survived a restart, and on every job creation)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="batch-executor", daemon=True)
            self._thread.start()

    def wake(self) -> None:
        self._wake.set()

    def stop(self, timeout: float = 10.0) -> None:
        # flip the flag under the lock so a concurrent start() can't see
        # _stopping=False after this stop claimed the thread; join outside
        with self._lock:
            self._stopping = True
            t = self._thread
        self._wake.set()
        if t is not None:
            t.join(timeout)

    # -- main loop ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stopping:
            try:
                self.store.expire_due()
                job = self.store.runnable()
                if job is None:
                    self._wake.wait(timeout=self.poll_s * 4)
                    self._wake.clear()
                    continue
                self._run_job(job)
            except Exception:  # noqa: BLE001 — the executor must not die
                log.exception("batch executor iteration failed")
                time.sleep(self.poll_s)

    def _set_paused(self, paused: bool) -> None:
        if paused != self.paused:
            self.paused = paused
            log.info("batch lane %s", "paused (SLO shedding)" if paused
                     else "resumed")
        self.registry.batch_lane_paused.set(1 if paused else 0)

    def _job_live(self, bid: str) -> bool:
        job = self.store.get(bid)
        return (job is not None and not self._stopping
                and job["status"] == "in_progress")

    # -- one job -----------------------------------------------------------

    def _run_job(self, job: dict) -> None:
        bid = job["id"]
        tr = obs_trace.RequestTrace(f"batch-{bid}", bid, kind="batch",
                                    endpoint=job["endpoint"],
                                    input_file_id=job["input_file_id"])
        self.trace_store.start(tr)
        try:
            if job["status"] == "validating":
                tr.begin("validate")
                lines, n_invalid = self._validate(job)
                tr.end("validate", lines=len(lines), invalid=n_invalid)
                if not lines:
                    self._finish(job, tr, "failed")
                    return
                job = self.store.transition(bid, "in_progress")
            else:  # crash-resume: re-parse (errors are already durable)
                tr.begin("validate", resume=True)
                lines, n_invalid = self._validate(job, record_errors=False)
                tr.end("validate", lines=len(lines), invalid=n_invalid,
                       resume=True)
            tr.begin("run")
            self._drain(job, lines)
            tr.end("run")
            job = self.store.get(bid)
            if job["status"] == "in_progress":
                done = self.store.done_custom_ids(job)
                if {cid for cid, _, _ in lines} <= done:
                    self._finish(job, tr, "completed")
                # else: stopped by shutdown mid-job; stays in_progress and
                # resumes from the durable done-set at the next boot
            else:
                self._finish(job, tr, job["status"], transition=False)
        except Exception as e:  # noqa: BLE001 — a broken job must not wedge
            log.exception("batch job %s failed", bid)
            tr.annotate(error=str(e))
            try:
                self._finish(job, tr, "failed")
            except ValueError:
                pass  # already terminal (cancelled during the failure)
        finally:
            self._set_paused(False)
            self.store.export_gauges(self.registry)
            self.trace_store.finish(tr)

    def _validate(self, job: dict,
                  record_errors: bool = True) -> tuple[list, int]:
        """Parse + validate the input file. Invalid lines become durable
        error records (once — resume passes record_errors=False); returns
        (valid lines as (custom_id, request, body), invalid count)."""
        meta = self.store.registry.get(job["input_file_id"])
        path = self.store.registry.content_path(job["input_file_id"])
        if meta is None or path is None:
            raise ValueError(
                f"input file {job['input_file_id']!r} not found")
        if meta.get("purpose") != "batch":
            # the API checks this at create time; re-checked so a forged
            # job record can't point the executor at any registry file
            raise ValueError(
                f"input file {job['input_file_id']!r} has purpose "
                f"{meta.get('purpose')!r}, not 'batch'")
        text = path.read_text()
        lines: list[tuple[str, LineRequest, dict]] = []
        seen: set[str] = set()
        # already-durable records (a crash between error appends and the
        # in_progress transition re-enters the record_errors=True branch)
        durable = self.store.done_custom_ids(job) if record_errors else set()
        n_invalid = 0
        # physical lines (blank ones skipped in the loop, not filtered
        # first), so "line N" in error records is the client's line N
        for i, raw in enumerate(text.splitlines()):
            if not raw.strip():
                continue
            try:
                cid, req, body = parse_line(raw, i + 1, job["endpoint"],
                                            seen)
            except LineError as e:
                n_invalid += 1
                # the line's real custom_id when it declared one; records
                # falling back to a made-up line-N id are flagged so the
                # drain's resume filter ignores them
                rid = e.custom_id or f"line-{i + 1}"
                if record_errors and rid not in durable:
                    self._record_error(job, rid, 400, str(e),
                                       synthetic=not e.custom_id)
                continue
            seen.add(cid)
            lines.append((cid, req, body))
        # counts re-derive from the durable output/error files, so a
        # crash-resumed job reports its real progress
        self.store.update(job["id"], request_counts={
            "total": len(lines) + n_invalid,
            "completed": _count_lines(self.store.output_path(job)),
            "failed": _count_lines(self.store.error_path(job)),
        })
        return lines, n_invalid

    def _drain(self, job: dict, lines: list) -> None:
        """Submit lines through the batch lane, bounded in flight, pausing
        (and requeueing in-flight work) while the SLO observatory sheds."""
        bid = job["id"]
        # synthetic line-N error ids excluded: they must not shadow a real
        # custom_id that happens to spell "line-N"
        done = self.store.done_custom_ids(job, include_synthetic=False)
        pending = deque(
            (cid, req, body) for cid, req, body in lines if cid not in done)
        # cid → (handle, req, body, sm, response id, submit time)
        inflight: dict[str, tuple] = {}
        models = {req.model for _, req, _ in pending}

        def lane_paused() -> bool:
            return any(self.slo.shedding(m) for m in models if m)

        while (pending or inflight) and self._job_live(bid):
            # harvest finished generations before the pause check: a
            # completion can itself re-trip shedding, and throwing away
            # finished work on a pause would livelock the job
            now = time.monotonic()
            progressed = False
            for cid in list(inflight):
                handle, req, body, sm, rid, t_sub = inflight[cid]
                if handle._done.is_set():
                    del inflight[cid]
                    self._record_result(job, cid, handle, req, sm, rid)
                    progressed = True
                elif now - t_sub > self.deadline_s:
                    # per-line deadline: cancel and move on without waiting
                    # for the engine (a late result is discarded)
                    handle.cancel()
                    del inflight[cid]
                    self._record_error(
                        job, cid, 504,
                        f"generation exceeded the {self.deadline_s:.0f}s "
                        "deadline and was cancelled")
                    self._bump(job, failed=1)
                    progressed = True
            if lane_paused():
                # pause the whole lane: cancel in-flight generations (their
                # slots free for interactive traffic at once) and put their
                # lines back — requeued, never failed
                self._set_paused(True)
                for cid, (handle, req, body, *_rest) in inflight.items():
                    handle.cancel()
                    pending.appendleft((cid, req, body))
                inflight.clear()
                time.sleep(self.poll_s)
                continue
            self._set_paused(False)
            while pending and len(inflight) < self.concurrency:
                cid, req, body = pending.popleft()
                try:
                    handle, sm, rid = self._submit_line(job, req)
                except Exception as e:  # noqa: BLE001 — bad line ≠ dead job
                    self._record_error(job, cid, 500, _message(e))
                    self._bump(job, failed=1)
                    continue
                inflight[cid] = (handle, req, body, sm, rid,
                                 time.monotonic())
            if not progressed:
                time.sleep(self.poll_s / 5)
        if not self._job_live(bid):
            for handle, *_ in inflight.values():
                handle.cancel()
        # per-line counts were updated in memory; persist the final tally
        # once (they re-derive from the durable files on resume anyway)
        self.store.update(bid, request_counts=dict(
            self.store.get(bid)["request_counts"]))

    def _submit_line(self, job: dict, req: LineRequest):
        """Build the line's generation as the interactive route builds it
        (templates, sampling over the model's defaults, image parts) and
        submit it on the batch lane, keyed to the job."""
        from localai_tpu_torch.api import inference as inf
        from localai_tpu_torch.api import openai as oa
        from localai_tpu_torch.templates.chat import build_completion_prompt

        sm, _mcfg = self.get_serving(req.model)
        body = req.body
        mm = None
        if job["endpoint"] == "/v1/chat/completions":
            messages, mm = inf.prepare_multimodal(
                sm, oa.chat_messages(body.get("messages") or []))
            prompt = oa._chat_prompt(sm, messages, None)
            rid = oa.new_id("chatcmpl")
        else:
            prompt = build_completion_prompt(
                sm.templates, sm.config, str(body.get("prompt") or ""))
            rid = oa.new_id("cmpl")
        gr = oa._gen_request(sm, body, prompt, False, mm=mm, rid=rid)
        gr = dataclasses.replace(
            gr, correlation_id=job["id"], trace_id=f"batch-{job['id']}",
            priority=PRIORITY_BATCH)
        return sm.scheduler.submit(gr), sm, rid

    def _record_result(self, job: dict, cid: str, handle, req: LineRequest,
                       sm, rid: str) -> None:
        from localai_tpu_torch.api import openai as oa

        if handle.finish_reason == "cancelled":
            # the job was cancelled between the pause check and the drain's
            # exit: the line is neither completed nor failed — it re-runs
            # on resume
            return
        if handle.finish_reason == "error" and not handle.text:
            self._record_error(job, cid, 502,
                               "generation failed in the backend")
            self._bump(job, failed=1)
            return
        text = oa.finetune_result(sm.config, "", handle.text)
        usage = oa.usage(handle.prompt_tokens, handle.completion_tokens)
        finish = handle.finish_reason or "stop"
        if job["endpoint"] == "/v1/chat/completions":
            body = oa.chat_response(rid, req.model, [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }], usage)
        else:
            body = oa.completion_response(rid, req.model, [{
                "index": 0, "text": text, "finish_reason": finish,
            }], usage)
        self.store.append_line(self.store.output_path(job), {
            "id": oa.new_id("batch_req"),
            "custom_id": cid,
            "response": {"status_code": 200, "request_id": rid,
                         "body": body},
            "error": None,
        })
        self.registry.batch_lines.inc(result="completed")
        self._bump(job, completed=1)

    def _record_error(self, job: dict, cid: str, code: int,
                      message: str, synthetic: bool = False) -> None:
        from localai_tpu_torch.api import openai as oa

        rec = {
            "id": oa.new_id("batch_req"),
            "custom_id": cid,
            "response": {"status_code": code,
                         "body": error_body(message, code=code)},
            "error": {"code": str(code), "message": message},
        }
        if synthetic:
            # cid is a made-up line-N (the line never declared one):
            # flagged so resume filters don't treat it as a real id
            rec["synthetic_id"] = True
        self.store.append_line(self.store.error_path(job), rec)
        self.registry.batch_lines.inc(result="failed")

    def _bump(self, job: dict, completed: int = 0, failed: int = 0) -> None:
        """Per-line progress, in memory only (live for GET /v1/batches; the
        durable truth is the output/error files)."""
        counts = dict(self.store.get(job["id"])["request_counts"])
        counts["completed"] += completed
        counts["failed"] += failed
        self.store.update(job["id"], persist=False, request_counts=counts)

    def _finish(self, job: dict, tr, status: str,
                transition: bool = True) -> None:
        """Terminal bookkeeping: register the output/error files
        (purpose=batch_output → downloadable at /v1/files/{id}/content)
        and move the job to its terminal state."""
        updates = {}
        for key, path in (("output_file_id", self.store.output_path(job)),
                          ("error_file_id", self.store.error_path(job))):
            if job.get(key) is None and path.exists():
                updates[key] = self.store.registry.register_path(
                    path, "batch_output")["id"]
        if transition:
            job = self.store.transition(job["id"], status, **updates)
        elif updates:
            job = self.store.update(job["id"], **updates)
        tr.annotate(status=job["status"], **job["request_counts"])
        log.info("batch %s → %s (%s)", job["id"], job["status"],
                 job["request_counts"])


def error_body(message: str, *, kind: str = "invalid_request_error",
               code: Optional[int] = None) -> dict:
    """The JAX package's error JSON (``api/schema.py::error_body``)."""
    err: dict[str, Any] = {"message": message, "type": kind}
    if code is not None:
        err["code"] = code
    return {"error": err}


def _message(e: Exception) -> str:
    """An exception's text; an API error's own message."""
    return getattr(e, "message", None) or str(e)
