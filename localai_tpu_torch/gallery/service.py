"""Async gallery job runner: ops queue + status map.

Port of ``localai_tpu/gallery/service.py``: a queue of ``GalleryOp``s
consumed by one worker thread, a uuid → ``JobStatus`` map polled over HTTP
(``GET /models/jobs/{uuid}``), per-file download progress surfaced into
the status, and apply/delete op kinds whose ``on_installed`` /
``on_deleted`` hooks keep the config registry in step.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import uuid as uuidlib
from typing import Any, Optional

from localai_tpu_torch.gallery import models as gm
from localai_tpu_torch.gallery.index import Gallery, find_model

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GalleryOp:
    """One queued operation."""

    id: str
    kind: str                       # "apply" | "delete"
    gallery_ref: str = ""           # name / gallery@name
    model: Optional[gm.GalleryModel] = None  # inline definition
    install_name: str = ""
    overrides: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JobStatus:
    """Polled job state (``progress`` in percent)."""

    deletion: bool = False
    file_name: str = ""
    error: str = ""
    processed: bool = False
    message: str = ""
    progress: float = 0.0
    file_size: str = ""
    downloaded_size: str = ""
    gallery_model_name: str = ""

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _human(n: int) -> str:
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if size < 1024 or unit == "TiB":
            return f"{size:.1f} {unit}"
        size /= 1024
    return f"{n} B"


class GalleryService:
    """Single-worker job runner with a thread-safe status map."""

    def __init__(self, models_path: str, galleries: list[Gallery],
                 on_installed=None, on_deleted=None):
        self.models_path = models_path
        self.galleries = list(galleries)
        # hooks so the serving config registry tracks installs/deletes
        self.on_installed = on_installed    # fn(config_path: Path)
        self.on_deleted = on_deleted        # fn(name: str)
        self._q: "queue.Queue[Optional[GalleryOp]]" = queue.Queue()
        self._status: dict[str, JobStatus] = {}
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="gallery-jobs"
        )
        self._thread.start()

    # -- API ---------------------------------------------------------------

    def submit(self, op: GalleryOp) -> str:
        op.id = op.id or str(uuidlib.uuid4())
        with self._lock:
            self._status[op.id] = JobStatus(
                deletion=op.kind == "delete",
                gallery_model_name=op.install_name or op.gallery_ref,
                message="queued",
            )
        self._q.put(op)
        return op.id

    def status(self, job_id: str) -> Optional[JobStatus]:
        with self._lock:
            return self._status.get(job_id)

    def all_status(self) -> dict[str, dict]:
        with self._lock:
            return {k: v.as_dict() for k, v in self._status.items()}

    def shutdown(self) -> None:
        self._q.put(None)
        self._thread.join(10.0)

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            op = self._q.get()
            if op is None:
                return
            st = self.status(op.id) or JobStatus()
            try:
                if op.kind == "delete":
                    self._do_delete(op, st)
                else:
                    self._do_apply(op, st)
                st.processed = True
                st.progress = 100.0
                st.message = "completed"
            except Exception as e:  # noqa: BLE001 — job errors are data
                log.exception("gallery job %s failed", op.id)
                st.processed = True
                st.error = f"{type(e).__name__}: {e}"
                st.message = "error"

    def _do_apply(self, op: GalleryOp, st: JobStatus) -> None:
        model = op.model
        if model is None:
            model = find_model(self.galleries, op.gallery_ref)
            if model is None:
                raise FileNotFoundError(
                    f"no model {op.gallery_ref!r} in galleries "
                    f"{[g.name for g in self.galleries]}"
                )
        st.message = "processing"

        def progress(filename: str, done: int, total: int) -> None:
            st.file_name = filename
            st.downloaded_size = _human(done)
            st.file_size = _human(total)
            if total:
                st.progress = min(99.0, 100.0 * done / total)

        path = gm.install_model(
            model, self.models_path,
            install_name=op.install_name,
            overrides=op.overrides,
            progress=progress,
        )
        if self.on_installed is not None:
            self.on_installed(path)

    def _do_delete(self, op: GalleryOp, st: JobStatus) -> None:
        st.message = "deleting"
        name = op.install_name or op.gallery_ref
        if not gm.delete_model(name, self.models_path):
            raise FileNotFoundError(f"model {name!r} is not installed")
        if self.on_deleted is not None:
            self.on_deleted(name)
