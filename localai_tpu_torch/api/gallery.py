"""Gallery HTTP endpoints: apply/delete models, job status, browse.

Port of ``localai_tpu/api/gallery.py``, with its bodies and statuses:
``POST /models/apply``, ``POST /models/delete/{name}``,
``GET /models/available``, ``GET /models/jobs/{uuid}``,
``GET /models/jobs``, and ``GET`` / ``POST`` / ``DELETE``
``/models/galleries``.

:class:`GalleryState` is the server's gallery half (``manager.gallery``):
the configured galleries (``AppConfig.galleries``) and the job runner,
started at the first job; an install registers its config with the
server's config registry and a delete removes it.
"""

from __future__ import annotations

import json
import logging
import threading

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.gallery import (
    EMBEDDED_MODELS,
    Gallery,
    GalleryModel,
    GalleryOp,
    GalleryService,
    available_models,
    resolve_ref,
)

log = logging.getLogger(__name__)


class GalleryState:
    """The configured galleries and the lazily started job runner of one
    server."""

    def __init__(self, app, loader):
        self.app = app
        self.loader = loader
        self.galleries: list[Gallery] = [
            Gallery(name=g.get("name", ""), url=g.get("url", ""))
            for g in app.galleries
        ]
        self._lock = threading.Lock()
        self._service = None

    @property
    def service(self) -> GalleryService:
        """The job runner; the first access starts its thread."""
        with self._lock:
            if self._service is None:
                self._service = GalleryService(
                    self.app.model_path, self.galleries,
                    on_installed=lambda p: self.loader.load_single(
                        p, context_size=self.app.context_size),
                    on_deleted=self.loader.remove,
                )
            return self._service

    def add_gallery(self, gallery: Gallery) -> None:
        with self._lock:
            self.galleries.append(gallery)
            if self._service is not None:
                self._service.galleries = list(self.galleries)

    def remove_gallery(self, name) -> bool:
        with self._lock:
            before = len(self.galleries)
            self.galleries = [g for g in self.galleries if g.name != name]
            if self._service is not None:
                self._service.galleries = list(self.galleries)
            return len(self.galleries) < before

    def shutdown(self) -> None:
        with self._lock:
            service, self._service = self._service, None
        if service is not None:
            service.shutdown()


def _json_list(items: list) -> tuple:
    return "application/json", json.dumps(items).encode("utf-8")


def apply_model(manager, body: dict) -> dict:
    """POST /models/apply — async install; returns a job uuid + status
    URL."""
    state = manager.gallery
    ref = body.get("id") or body.get("model") or ""
    op = GalleryOp(
        id="", kind="apply",
        install_name=body.get("name") or "",
        overrides=body.get("overrides") or {},
    )
    inline = None
    if body.get("url") or body.get("config_url"):
        inline = GalleryModel(
            name=op.install_name or ref or "model",
            url=body.get("url") or body.get("config_url"),
        )
    elif body.get("files") or body.get("config_file"):
        inline = GalleryModel.model_validate({
            "name": op.install_name or ref or "model",
            "files": body.get("files") or [],
            "config_file": body.get("config_file"),
        })
    elif ref:
        # the shared resolution chain (embedded → URL → shipped); gallery
        # refs resolve in the job worker, so a slow index never blocks here
        inline = resolve_ref([], ref, name=op.install_name)
        if inline is not None and not inline.url:
            op.install_name = op.install_name or ref
    else:
        raise APIError(400, "need one of: id (gallery@name), url, files")
    op.model = inline
    op.gallery_ref = ref
    job_id = state.service.submit(op)
    return {"uuid": job_id, "status": f"/models/jobs/{job_id}"}


def delete_model_endpoint(manager, body: dict, name: str) -> dict:
    op = GalleryOp(id="", kind="delete", install_name=name)
    job_id = manager.gallery.service.submit(op)
    # drop any loaded instance so its memory frees now
    try:
        manager.shutdown_model(name, force=True)
    except Exception:  # noqa: BLE001
        log.debug("no loaded instance of %s to shut down", name)
    return {"uuid": job_id, "status": f"/models/jobs/{job_id}"}


def job_status(manager, query: dict, uuid: str) -> dict:
    st = manager.gallery.service.status(uuid)
    if st is None:
        raise APIError(404, "no such job")
    return st.as_dict()


def all_jobs(manager, query: dict) -> dict:
    return manager.gallery.service.all_status()


def list_available(manager, query: dict) -> tuple:
    """GET /models/available — gallery models, the shipped index, and
    the embedded library's entries."""
    out = []
    for m in available_models(manager.gallery.galleries,
                              manager.app.model_path):
        out.append(m.model_dump(exclude={"config_file"}))
    for _name, m in sorted(EMBEDDED_MODELS.items()):
        d = m.model_dump(exclude={"config_file"})
        d["gallery"] = "embedded"
        out.append(d)
    return _json_list(out)


def list_galleries(manager, query: dict) -> tuple:
    return _json_list([{"name": g.name, "url": g.url}
                       for g in manager.gallery.galleries])


def add_gallery(manager, body: dict) -> dict:
    state = manager.gallery
    name, url = body.get("name"), body.get("url")
    if not name or not url:
        raise APIError(400, "need name and url")
    if any(g.name == name for g in state.galleries):
        raise APIError(409, f"gallery {name!r} already exists")
    state.add_gallery(Gallery(name=name, url=url))
    return {"name": name, "url": url}


def remove_gallery(manager, body: dict) -> dict:
    name = body.get("name")
    if not manager.gallery.remove_gallery(name):
        raise APIError(404, f"no gallery {name!r}")
    return {"removed": name}


POST = {"/models/apply": apply_model, "/models/galleries": add_gallery}
POST_PARAM = (("/models/delete/{name}", delete_model_endpoint),)
GET = {"/models/available": list_available, "/models/jobs": all_jobs,
       "/models/galleries": list_galleries}
GET_PARAM = (("/models/jobs/{uuid}", job_status),)
# a DELETE whose handler reads a JSON body (the JAX package's)
DELETE_BODY = {"/models/galleries": remove_gallery}
