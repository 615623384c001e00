"""The ``/v1/files`` API over the batch subsystem's file registry.

Port of the ``/v1/files`` routes of ``localai_tpu/api/assistants.py``
(each also under its unversioned alias, as there): list (``?purpose=``),
upload (``multipart/form-data`` with ``file`` and ``purpose``, read by
``api.audio.parse_multipart``; at most ``upload_limit_mb``), get,
content and delete, over the ``batch.store.FileRegistry`` the server
keeps in ``upload_path``. Batch inputs are uploaded here with
``purpose=batch`` and batch results downloaded from here. The
``/v1/assistants*`` routes wait for ROADMAP item 22.
"""

from __future__ import annotations

from localai_tpu_torch.api.openai import APIError


def _registry(manager):
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


GET = {f"{base}/files": list_files for base in ("/v1", "")}
GET_PARAM = tuple(
    pair for base in ("/v1", "")
    for pair in ((f"{base}/files/{{file_id}}", get_file),
                 (f"{base}/files/{{file_id}}/content", get_file_content)))
UPLOAD = {f"{base}/files": upload_file for base in ("/v1", "")}
DELETE_PARAM = tuple((f"{base}/files/{{file_id}}", delete_file)
                     for base in ("/v1", ""))
