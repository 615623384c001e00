"""The OpenAI Assistants and Files APIs of the port.

Port of ``localai_tpu/api/assistants.py``, each route also under its
unversioned alias, as there:

  * ``/v1/assistants``: create (POST), list (GET: ``?order=asc|desc``,
    ``?after=`` / ``?before=`` cursors as ``asst_N`` or ``N``,
    ``?limit=``); ``/v1/assistants/{assistant_id}``: get, modify (POST:
    the definition is replaced, the id and ``created`` kept), delete;
    ``/v1/assistants/{assistant_id}/files``: attach a file (POST
    ``{"file_id"}``), list; ``.../files/{file_id}``: get, detach (DELETE).
    A body is validated as the JAX package validates it (the model must
    be configured; name, description and instructions lengths; at most
    128 tools of the three known types; at most 20 ``file_ids``), and the
    error bodies and status codes are the JAX package's.
  * ``/v1/files``: list (``?purpose=``), upload (``multipart/form-data``
    with ``file`` and ``purpose``, read by ``api.audio.parse_multipart``;
    at most ``upload_limit_mb``), get, content and delete, over the
    ``batch.store.FileRegistry`` the server keeps in ``upload_path``.
    Batch inputs are uploaded here with ``purpose=batch`` and batch
    results downloaded from here; an assistant attaches these files.

:class:`AssistantStore` keeps the assistants and their file attachments
as ``assistants.json`` and ``assistantsFile.json`` in ``config_path``,
saved atomically at every change and reloaded when the server starts.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.batch.store import (
    FileRegistry,
    _atomic_save,
    _id_num,
    _load,
)

ASSISTANTS_FILE = "assistants.json"
ASSISTANT_FILES_FILE = "assistantsFile.json"

# request-shape limits, the JAX package's
MAX_INSTRUCTIONS = 32768
MAX_DESCRIPTION = 512
MAX_NAME = 256
MAX_TOOLS = 128
MAX_FILE_IDS = 20
TOOL_TYPES = {"code_interpreter", "retrieval", "function"}
# a body of these routes that is not JSON answers this 400 (any JSON
# value reaches the handler, which refuses what is not an object)
PARSE_ERROR = "Cannot parse JSON"


class AssistantStore:
    """Assistants and assistant-file attachments, persisted as JSON and
    reloaded at construction. Uploaded-file metadata lives in the shared
    :class:`FileRegistry` (``registry``)."""

    def __init__(self, configs_dir, upload_dir,
                 registry: Optional[FileRegistry] = None):
        self.configs_dir = Path(configs_dir)
        self.registry = registry or FileRegistry(upload_dir)
        self._lock = threading.Lock()
        self.assistants: list[dict] = _load(self.configs_dir
                                            / ASSISTANTS_FILE)
        self.assistant_files: list[dict] = _load(self.configs_dir
                                                 / ASSISTANT_FILES_FILE)
        # ids continue past the largest persisted one, so a restart never
        # mints a colliding id (as the JAX package's store)
        self._next_id = 1 + max(
            [_id_num(a["id"], "asst_") for a in self.assistants] + [0])

    def save_assistants(self) -> None:  # jaxlint: guarded-by(_lock)
        _atomic_save(self.configs_dir / ASSISTANTS_FILE, self.assistants)

    def save_assistant_files(self) -> None:  # jaxlint: guarded-by(_lock)
        _atomic_save(self.configs_dir / ASSISTANT_FILES_FILE,
                     self.assistant_files)

    def next_id(self) -> int:
        with self._lock:
            n = self._next_id
            self._next_id += 1
            return n

    def assistant(self, aid: str) -> Optional[dict]:
        return next((a for a in self.assistants if a["id"] == aid), None)

    def file(self, fid: str) -> Optional[dict]:
        return self.registry.get(fid)


def _store(manager) -> AssistantStore:
    return manager.assistants


def _validate(manager, body) -> Optional[str]:
    """The JAX package's shape limits and model check: the refusal's
    message, or None."""
    if not isinstance(body, dict):
        return "body must be a JSON object"
    model = body.get("model", "")
    if not model:
        return "model is required"
    if model not in manager.loader.names():
        return f"Model {model} not found"
    if len(body.get("name") or "") > MAX_NAME:
        return "name exceeds maximum length"
    if len(body.get("description") or "") > MAX_DESCRIPTION:
        return "description exceeds maximum length"
    if len(body.get("instructions") or "") > MAX_INSTRUCTIONS:
        return "instructions exceed maximum length"
    tools = body.get("tools") or []
    if len(tools) > MAX_TOOLS:
        return "too many tools"
    for t in tools:
        if not isinstance(t, dict) or t.get("type") not in TOOL_TYPES:
            return f"invalid tool: {t!r}"
    if len(body.get("file_ids") or []) > MAX_FILE_IDS:
        return "too many file_ids"
    return None


def _from_request(store: AssistantStore, body: dict) -> dict:
    return {"id": f"asst_{store.next_id()}", "object": "assistant",
            "created": int(time.time()), "model": body.get("model", ""),
            "name": body.get("name", ""),
            "description": body.get("description", ""),
            "instructions": body.get("instructions", ""),
            "tools": body.get("tools") or [],
            "file_ids": body.get("file_ids") or [],
            "metadata": body.get("metadata") or {}}


def _limit(query: dict) -> int:
    try:
        return int(query.get("limit", "20"))
    except ValueError:
        raise APIError(400, "Invalid limit query value") from None


# -- /v1/assistants ----------------------------------------------------------

def create_assistant(manager, body) -> dict:
    err = _validate(manager, body)
    if err:
        raise APIError(400, err)
    store = _store(manager)
    assistant = _from_request(store, body)
    with store._lock:
        store.assistants.append(assistant)
        store.save_assistants()
    return assistant


def list_assistants(manager, query: dict) -> tuple:
    out = list(_store(manager).assistants)
    out.sort(key=lambda a: a.get("created", 0),
             reverse=query.get("order", "desc") != "asc")
    # a cursor is the bare number or the full id the API hands out
    after = query.get("after", "").removeprefix("asst_")
    before = query.get("before", "").removeprefix("asst_")
    if after.isdigit():
        out = [a for a in out if _id_num(a["id"], "asst_") > int(after)]
    if before.isdigit():
        out = [a for a in out if _id_num(a["id"], "asst_") < int(before)]
    return 200, out[:_limit(query)]


def get_assistant(manager, query: dict, aid: str) -> dict:
    a = _store(manager).assistant(aid)
    if a is None:
        raise APIError(404, "Unable to find assistant")
    return a


def modify_assistant(manager, body, aid: str) -> dict:
    err = _validate(manager, body)
    if err:
        raise APIError(400, err)
    store = _store(manager)
    # built before taking the lock: it mints an id under the same lock
    updated = _from_request(store, body)
    with store._lock:
        for i, a in enumerate(store.assistants):
            if a["id"] == aid:
                updated["id"] = aid
                updated["created"] = a.get("created", updated["created"])
                store.assistants[i] = updated
                store.save_assistants()
                return updated
    raise APIError(404, f"Unable to find assistant with id: {aid}")


def delete_assistant(manager, query: dict, aid: str) -> tuple:
    store = _store(manager)
    with store._lock:
        for i, a in enumerate(store.assistants):
            if a["id"] == aid:
                del store.assistants[i]
                store.assistant_files = [af for af in store.assistant_files
                                         if af["assistant_id"] != aid]
                store.save_assistants()
                store.save_assistant_files()
                return 200, {"id": aid, "object": "assistant.deleted",
                             "deleted": True}
    return 404, {"id": aid, "object": "assistant.deleted", "deleted": False}


# -- /v1/assistants/{assistant_id}/files -------------------------------------

def create_assistant_file(manager, body, aid: str) -> dict:
    store = _store(manager)
    fid = (body or {}).get("file_id", "")
    a = store.assistant(aid)
    if a is None:
        raise APIError(404, f"Unable to find assistant with id: {aid}")
    if store.file(fid) is None:
        raise APIError(404, f"Unable to find file_id with id: {fid}")
    af = {"id": fid, "object": "assistant.file",
          "created_at": int(time.time()), "assistant_id": aid}
    with store._lock:
        if fid not in a["file_ids"]:
            a["file_ids"].append(fid)
        store.assistant_files.append(af)
        store.save_assistants()
        store.save_assistant_files()
    return af


def list_assistant_files(manager, query: dict, aid: str) -> dict:
    store = _store(manager)
    if store.assistant(aid) is None:
        raise APIError(404, f"Unable to find assistant with id: {aid}")
    data = [af for af in store.assistant_files if af["assistant_id"] == aid]
    return {"object": "list", "data": data[:_limit(query)]}


def get_assistant_file(manager, query: dict, aid: str, fid: str) -> dict:
    for af in _store(manager).assistant_files:
        if af["assistant_id"] == aid and af["id"] == fid:
            return af
    raise APIError(404, f"Unable to find assistant file with id {fid} on "
                        f"assistant {aid}")


def delete_assistant_file(manager, query: dict, aid: str,
                          fid: str) -> tuple:
    store = _store(manager)
    with store._lock:
        for i, af in enumerate(store.assistant_files):
            if af["assistant_id"] == aid and af["id"] == fid:
                del store.assistant_files[i]
                a = store.assistant(aid)
                if a and fid in a.get("file_ids", []):
                    a["file_ids"].remove(fid)
                    store.save_assistants()
                store.save_assistant_files()
                return 200, {"id": fid, "object": "assistant.file.deleted",
                             "deleted": True}
    return 404, {"id": fid, "object": "assistant.file.deleted",
                 "deleted": False}


# -- /v1/files ---------------------------------------------------------------

def _registry(manager) -> FileRegistry:
    return manager.batch_state.files


def upload_file(manager, fields: dict, *, filenames: dict) -> dict:
    """POST /v1/files: store the ``file`` field under its basename and
    register it with its ``purpose``."""
    content = fields.get("file")
    if content is None:
        raise APIError(400, "file form field is required")
    purpose = fields.get("purpose", b"").decode("utf-8", "replace").strip()
    if not purpose:
        raise APIError(400, "Purpose is not defined")
    limit = manager.app.upload_limit_mb * 1024 * 1024
    if len(content) > limit:
        raise APIError(400, f"File size {len(content)} exceeds upload "
                            f"limit {limit}")
    try:
        return _registry(manager).register_bytes(
            filenames.get("file") or "upload", content, purpose)
    except ValueError as e:
        raise APIError(400, str(e)) from None


def list_files(manager, query: dict) -> dict:
    return {"object": "list",
            "data": _registry(manager).list(query.get("purpose", ""))}


def _file(manager, fid: str) -> dict:
    f = _registry(manager).get(fid)
    if f is None:
        raise APIError(404, f"unable to find file id {fid}")
    return f


def get_file(manager, query: dict, fid: str) -> dict:
    return _file(manager, fid)


def get_file_content(manager, query: dict, fid: str) -> tuple:
    f = _file(manager, fid)
    try:
        body = _registry(manager).content_path(f["id"]).read_bytes()
    except (OSError, ValueError) as e:
        raise APIError(500, str(e)) from None
    return "application/octet-stream", body


def delete_file(manager, query: dict, fid: str) -> dict:
    f = _file(manager, fid)
    _registry(manager).delete(f["id"])
    return {"id": f["id"], "object": "file", "deleted": True}


_BASES = ("/v1", "")
_ONE = "/assistants/{assistant_id}"
_FILE = _ONE + "/files/{file_id}"
GET = {path: fn for base in _BASES
       for path, fn in ((f"{base}/assistants", list_assistants),
                        (f"{base}/files", list_files))}
GET_PARAM = tuple(
    pair for base in _BASES
    for pair in ((f"{base}{_ONE}", get_assistant),
                 (f"{base}{_ONE}/files", list_assistant_files),
                 (f"{base}{_FILE}", get_assistant_file),
                 (f"{base}/files/{{file_id}}", get_file),
                 (f"{base}/files/{{file_id}}/content", get_file_content)))
POST = {f"{base}/assistants": create_assistant for base in _BASES}
POST_PARAM = tuple(
    pair for base in _BASES
    for pair in ((f"{base}{_ONE}", modify_assistant),
                 (f"{base}{_ONE}/files", create_assistant_file)))
UPLOAD = {f"{base}/files": upload_file for base in _BASES}
DELETE_PARAM = tuple(
    pair for base in _BASES
    for pair in ((f"{base}{_ONE}", delete_assistant),
                 (f"{base}{_FILE}", delete_assistant_file),
                 (f"{base}/files/{{file_id}}", delete_file)))
# the routes whose body is any JSON value (PARSE_ERROR when it is none)
JSON_ANY = {*POST, *(p for p, _ in POST_PARAM)}
