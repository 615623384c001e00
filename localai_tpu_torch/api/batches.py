"""OpenAI Batch API endpoints over the offline batch subsystem.

Port of ``localai_tpu/api/batches.py``. ``POST /v1/batches`` creates a
job from a JSONL file uploaded through ``/v1/files`` with
``purpose=batch`` (``api.assistants``); ``GET /v1/batches`` (``?limit=``,
newest first) and ``GET /v1/batches/{batch_id}`` read job state with its
progress counts; ``POST /v1/batches/{batch_id}/cancel`` stops a job (the
in-flight lines are abandoned, durable results kept). A finished job
carries ``output_file_id`` / ``error_file_id``, downloadable at
``GET /v1/files/{id}/content``. ``/v1`` only, as on the JAX package.

:class:`BatchState` is the server's batch half: the file registry and
the job store under ``upload_path``, and the background
:class:`~localai_tpu_torch.batch.executor.BatchExecutor`, started lazily
(at the first job, or at construction when a job survived a restart) and
stopped before the engines at shutdown, so an in-progress job stays
durable and resumes at the next boot.
"""

from __future__ import annotations

import json
import threading

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.batch import BatchExecutor, BatchStore, FileRegistry
from localai_tpu_torch.batch.executor import SUPPORTED_URLS


class BatchState:
    """The file registry, the job store and the lazily started executor
    of one server."""

    def __init__(self, app, manager):
        self.app = app
        self.manager = manager
        self.files = FileRegistry(app.upload_path)
        self.batches = BatchStore(app.upload_path, self.files,
                                  expiry_h=app.batch_expiry_h)
        self._lock = threading.Lock()
        self._service = None
        if self.batches.runnable() is not None:
            self.service.wake()

    def _serving_for(self, name: str):
        mcfg = self.manager.loader.get(name)
        if mcfg is None:
            raise ValueError(f"model {name!r} not found")
        return self.manager.get(name), mcfg

    @property
    def executor(self):
        """The executor if it has started, else None (never starts it)."""
        with self._lock:
            return self._service

    @property
    def service(self) -> BatchExecutor:
        """The batch executor; the first access starts its thread."""
        with self._lock:
            if self._service is None:
                self._service = BatchExecutor(
                    self.batches, self._serving_for,
                    concurrency=self.app.batch_concurrency,
                    deadline_s=self.app.request_deadline_s)
                self._service.start()
            return self._service

    def shutdown(self) -> None:
        service = self.executor
        if service is not None:
            service.stop()


def create_batch(manager, body: dict) -> dict:
    state = manager.batch_state
    endpoint = body.get("endpoint") or ""
    if endpoint not in SUPPORTED_URLS:
        raise APIError(400, f"endpoint must be one of {list(SUPPORTED_URLS)}")
    fid = body.get("input_file_id") or ""
    f = state.files.get(fid)
    if f is None:
        raise APIError(404, f"input file {fid!r} not found")
    if f.get("purpose") != "batch":
        raise APIError(400, f"input file {fid!r} has purpose "
                            f"{f.get('purpose')!r}; upload it with "
                            "purpose=batch")
    metadata = body.get("metadata")
    if metadata is not None and not isinstance(metadata, dict):
        raise APIError(400, "metadata must be an object")
    job = state.batches.create(
        endpoint=endpoint, input_file_id=fid,
        completion_window=str(body.get("completion_window") or "24h"),
        metadata=metadata)
    state.batches.export_gauges()
    created = json.loads(json.dumps(job))  # the record as created: the
    state.service.wake()  # executor (started on first use) moves the job
    return created


def list_batches(manager, query: dict) -> dict:
    jobs = manager.batch_state.batches.list()
    jobs.sort(key=lambda j: j.get("created_at", 0), reverse=True)
    try:
        limit = int(query.get("limit", "20"))
    except ValueError:
        raise APIError(400, "Invalid limit query value") from None
    if limit < 1:
        raise APIError(400, "limit must be >= 1")
    return {"object": "list", "data": jobs[:limit]}


def get_batch(manager, query: dict, bid: str) -> dict:
    job = manager.batch_state.batches.get(bid)
    if job is None:
        raise APIError(404, "Unable to find batch")
    return job


def cancel_batch(manager, body: dict, bid: str) -> dict:
    state = manager.batch_state
    job = state.batches.cancel(bid)
    if job is None:
        raise APIError(404, "Unable to find batch")
    state.batches.export_gauges()
    return job


POST = {"/v1/batches": create_batch}
GET = {"/v1/batches": list_batches}
GET_PARAM = (("/v1/batches/{batch_id}", get_batch),)
POST_PARAM = (("/v1/batches/{batch_id}/cancel", cancel_batch),)
