"""Durable state for the offline batch subsystem: files + jobs.

A copy of ``localai_tpu/batch/store.py``. Two stores, both JSON-persisted
under ``AppConfig.upload_path`` with atomic writes (tmp + rename),
reloaded at boot:

**FileRegistry** — the ONE ``/v1/files`` registry (``uploadedFiles.json``)
with a ``purpose`` field (``assistants`` | ``batch`` | ``batch_output``),
so batch input uploads, assistant attachments and batch result downloads
all flow through the same metadata + traversal-guarded content path (the
assistants API that shares it waits for ROADMAP item 22).

**BatchStore** — OpenAI-Batch-shaped job records (``batches.json``) with
crash-safe state transitions::

    validating ──► in_progress ──► completed
        │               │      └─► failed
        └───────────────┴──────────► cancelled / expired

Transitions are validated (an illegal edge raises), stamped
(``in_progress_at``/``completed_at``/...), and persisted atomically.
Line-level durability is append-only JSONL: the executor appends one
result (or error) record per input line and flushes before counting it
done, so a crash mid-job loses at most the in-flight lines — on reload
the executor re-derives the done-set from the output/error files and
resumes from the first missing ``custom_id``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Optional

from localai_tpu_torch.utils.paths import verify_path

log = logging.getLogger(__name__)

UPLOADED_FILES_FILE = "uploadedFiles.json"
BATCHES_FILE = "batches.json"
# batch job state + per-line artifacts live under this subdirectory of
# the upload dir: register_bytes writes BASENAMES into the upload root,
# so a crafted upload can never collide with (and poison) job state
JOBS_SUBDIR = "batch_jobs"
# upload-root filenames a client may not claim (the registry's own
# persistence — an upload under this name would be clobbered by the next
# metadata save, or worse, parsed as state on reboot)
RESERVED_NAMES = frozenset({UPLOADED_FILES_FILE})

FILE_PURPOSES = ("assistants", "batch", "batch_output")

# legal lifecycle edges (OpenAI Batch states; "cancelling" is collapsed
# into an immediate cancel — the executor observes it within one poll)
TERMINAL_STATES = frozenset({"completed", "failed", "cancelled", "expired"})
_TRANSITIONS = {
    "validating": {"in_progress", "failed", "cancelled", "expired"},
    "in_progress": {"completed", "failed", "cancelled", "expired"},
}


def _id_num(s: str, prefix: str) -> int:
    try:
        return int(s.removeprefix(prefix))
    except ValueError:
        return 0


def _atomic_save(path: Path, data: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=2))
    tmp.replace(path)


def _load(path: Path) -> list[dict]:
    try:
        data = json.loads(path.read_text())
        return data if isinstance(data, list) else []
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as e:
        log.warning("cannot load %s: %s", path, e)
        return []


class FileRegistry:
    """The unified ``/v1/files`` metadata registry + content store."""

    def __init__(self, upload_dir: str | Path):
        self.upload_dir = Path(upload_dir)
        self._lock = threading.Lock()
        self.files: list[dict] = _load(self.upload_dir / UPLOADED_FILES_FILE)
        # ids continue past the largest persisted one, so restarts never
        # mint colliding file ids (same divergence as AssistantStore)
        self._next = 1 + max(
            [_id_num(f.get("id", ""), "file-") for f in self.files] + [0]
        )

    def _save(self) -> None:  # jaxlint: guarded-by(_lock)
        _atomic_save(self.upload_dir / UPLOADED_FILES_FILE, self.files)

    def next_id(self) -> str:
        with self._lock:
            n = self._next
            self._next += 1
            return f"file-{n}"

    # -- write -----------------------------------------------------------

    def register_bytes(self, filename: str, content: bytes,
                       purpose: str) -> dict:
        """Persist an upload: content under the upload dir (basename only,
        traversal-guarded), metadata in the registry. Raises ValueError on
        a bad filename or a name collision."""
        safe_name = Path(filename).name or "upload"
        if safe_name in RESERVED_NAMES or safe_name == JOBS_SUBDIR:
            raise ValueError(f"filename {safe_name!r} is reserved")
        save_path = verify_path(safe_name, self.upload_dir)
        if save_path.exists():
            raise ValueError("File already exists")
        self.upload_dir.mkdir(parents=True, exist_ok=True)
        save_path.write_bytes(content)
        return self._register(safe_name, len(content), purpose)

    def register_path(self, path: Path, purpose: str) -> dict:
        """Register a file ALREADY written inside the upload dir — at any
        depth (the batch executor's artifacts live in the ``batch_jobs``
        subdirectory). The stored filename is the path RELATIVE to the
        upload dir, so content lookups stay traversal-guarded."""
        rel = Path(path).resolve().relative_to(self.upload_dir.resolve())
        return self._register(rel.as_posix(),
                              Path(path).stat().st_size, purpose)

    def _register(self, name: str, size: int, purpose: str) -> dict:
        f = {
            "id": self.next_id(),
            "object": "file",
            "bytes": size,
            "created_at": int(time.time()),
            "filename": name,
            "purpose": purpose,
        }
        with self._lock:
            self.files.append(f)
            self._save()
        return f

    def delete(self, fid: str) -> bool:
        """Remove metadata + content; True when the id existed. Missing
        content is not an error (metadata cleanup proceeds — files.go
        parity)."""
        with self._lock:
            f = next((x for x in self.files if x["id"] == fid), None)
            if f is None:
                return False
            try:
                verify_path(f["filename"], self.upload_dir).unlink()
            except (FileNotFoundError, ValueError):
                pass
            self.files = [x for x in self.files if x["id"] != fid]
            self._save()
        return True

    # -- read ------------------------------------------------------------

    # lock-free readers: ``files`` only ever grows via append or is
    # rebound to a fresh list under the lock — a scan sees a complete
    # (possibly one-entry-stale) snapshot, which the HTTP tier tolerates
    def get(self, fid: str) -> Optional[dict]:  # jaxlint: disable=lock-guarded-attr
        return next((f for f in self.files if f["id"] == fid), None)

    def list(self, purpose: str = "") -> list[dict]:  # jaxlint: disable=lock-guarded-attr
        return [f for f in self.files
                if not purpose or f.get("purpose") == purpose]

    def content_path(self, fid: str) -> Optional[Path]:
        f = self.get(fid)
        if f is None:
            return None
        return verify_path(f["filename"], self.upload_dir)


class BatchStore:
    """Durable batch-job records with validated state transitions."""

    def __init__(self, upload_dir: str | Path, registry: FileRegistry,
                 *, expiry_h: float = 24.0):
        self.upload_dir = Path(upload_dir)
        # job state + artifacts in a subdir the upload API cannot name
        # (register_bytes strips paths to basenames): a crafted upload
        # can neither pre-seed an output file nor plant a batches.json
        self.jobs_dir = self.upload_dir / JOBS_SUBDIR
        self.registry = registry
        self.expiry_h = expiry_h
        self._lock = threading.Lock()
        self.jobs: list[dict] = _load(self.jobs_dir / BATCHES_FILE)
        self._next = 1 + max(
            [_id_num(j.get("id", ""), "batch_") for j in self.jobs] + [0]
        )

    def _save(self) -> None:  # jaxlint: guarded-by(_lock)
        _atomic_save(self.jobs_dir / BATCHES_FILE, self.jobs)

    # -- job lifecycle ----------------------------------------------------

    def create(self, *, endpoint: str, input_file_id: str,
               completion_window: str = "24h",
               metadata: Optional[dict] = None) -> dict:
        with self._lock:
            bid = f"batch_{self._next}"
            self._next += 1
            job = {
                "id": bid,
                "object": "batch",
                "endpoint": endpoint,
                "input_file_id": input_file_id,
                "completion_window": completion_window,
                "status": "validating",
                "output_file_id": None,
                "error_file_id": None,
                "created_at": int(time.time()),
                "in_progress_at": None,
                "completed_at": None,
                "failed_at": None,
                "cancelled_at": None,
                "expired_at": None,
                "request_counts": {"total": 0, "completed": 0, "failed": 0},
                "metadata": metadata or {},
            }
            self.jobs.append(job)
            self._save()
        return job

    # lock-free readers (same contract as FileRegistry): ``jobs`` only
    # appends, and job dicts are merged under the lock — pollers tolerate
    # a one-transition-stale view
    def get(self, bid: str) -> Optional[dict]:  # jaxlint: disable=lock-guarded-attr
        return next((j for j in self.jobs if j["id"] == bid), None)

    def list(self) -> list[dict]:  # jaxlint: disable=lock-guarded-attr
        return list(self.jobs)

    def transition(self, bid: str, status: str, **updates) -> dict:
        """Move a job along a legal lifecycle edge, stamp the matching
        ``<status>_at`` timestamp, merge ``updates``, persist atomically.
        Raises ValueError on an unknown job or an illegal edge — the state
        machine is the crash-safety contract, so it is enforced, not
        advisory."""
        with self._lock:
            job = self.get(bid)
            if job is None:
                raise ValueError(f"unknown batch {bid!r}")
            cur = job["status"]
            if status != cur:
                if status not in _TRANSITIONS.get(cur, ()):  # terminal too
                    raise ValueError(
                        f"illegal batch transition {cur!r} → {status!r}")
                job["status"] = status
                stamp = f"{status}_at"
                if stamp in job and job[stamp] is None:
                    job[stamp] = int(time.time())
            job.update(updates)
            self._save()
        return job

    def update(self, bid: str, persist: bool = True, **updates) -> dict:
        """Update non-state fields (request_counts, output_file_id, ...).
        ``persist=False`` touches only the in-memory record — the batch
        executor uses it for per-line progress counts, which re-derive
        from the durable output/error files on crash-resume, so a full
        ``batches.json`` rewrite per drained line would buy nothing."""
        with self._lock:
            job = self.get(bid)
            if job is None:
                raise ValueError(f"unknown batch {bid!r}")
            job.update(updates)
            if persist:
                self._save()
        return job

    def cancel(self, bid: str) -> Optional[dict]:
        """API-side cancel: non-terminal → cancelled (the executor notices
        within one poll and abandons in-flight lines). Terminal jobs are
        returned unchanged; unknown → None. Tolerates the executor racing
        this check into a terminal state — a cancel of a just-completed
        job returns its terminal record, never an error."""
        job = self.get(bid)
        if job is None:
            return None
        if job["status"] in TERMINAL_STATES:
            return job
        try:
            return self.transition(bid, "cancelled")
        except ValueError:
            # the executor finished the job between the check and the
            # transition; its terminal state stands
            return self.get(bid)

    def runnable(self) -> Optional[dict]:  # jaxlint: disable=lock-guarded-attr
        """Oldest non-terminal job (FIFO — one active job at a time keeps
        the background lane's footprint predictable)."""
        live = [j for j in self.jobs if j["status"] not in TERMINAL_STATES]
        return min(live, key=lambda j: j["created_at"]) if live else None

    def expire_due(self, now: Optional[float] = None) -> list[dict]:  # jaxlint: disable=lock-guarded-attr
        """Expire non-terminal jobs older than the expiry horizon."""
        now = time.time() if now is None else now
        horizon = self.expiry_h * 3600.0
        out = []
        for j in list(self.jobs):
            if (j["status"] not in TERMINAL_STATES
                    and now - j["created_at"] > horizon):
                out.append(self.transition(j["id"], "expired"))
        return out

    # -- line-level durability (append-only JSONL) ------------------------

    def output_path(self, job: dict) -> Path:
        return self.jobs_dir / f"{job['id']}_output.jsonl"

    def error_path(self, job: dict) -> Path:
        return self.jobs_dir / f"{job['id']}_error.jsonl"

    def append_line(self, path: Path, record: dict) -> None:
        """One durable result line: append + flush + fsync, so a line
        counted completed survives the process dying right after."""
        import os

        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def done_custom_ids(self, job: dict,
                        include_synthetic: bool = True) -> set[str]:
        """The crash-resume set: custom_ids already durably recorded in
        the output or error file (malformed lines are skipped — they were
        mid-write when the process died, and their line re-runs).

        Records flagged ``synthetic_id`` (validation failures on lines
        that never declared a custom_id — their id is a made-up
        ``line-N``) are excluded with ``include_synthetic=False``: the
        executor's drain filter must not let a synthetic id shadow a
        REAL custom_id that happens to spell ``line-N``."""
        done: set[str] = set()
        for path in (self.output_path(job), self.error_path(job)):
            try:
                text = path.read_text()
            except FileNotFoundError:
                continue
            for line in text.splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not include_synthetic and rec.get("synthetic_id"):
                    continue
                cid = rec.get("custom_id")
                if cid:
                    done.add(str(cid))
        return done

    # -- observability ----------------------------------------------------

    def export_gauges(self, registry=None) -> None:  # jaxlint: disable=lock-guarded-attr
        """Refresh ``localai_batch_jobs{state}`` at /metrics scrape time
        (every state gets a series, so dashboards can key on zeros)."""
        from localai_tpu_torch.obs.metrics import REGISTRY

        reg = registry or REGISTRY
        counts = {s: 0 for s in
                  ("validating", "in_progress", *sorted(TERMINAL_STATES))}
        for j in self.jobs:
            counts[j["status"]] = counts.get(j["status"], 0) + 1
        for state, n in counts.items():
            reg.batch_jobs.set(n, state=state)
