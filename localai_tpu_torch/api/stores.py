"""Vector-store HTTP endpoints.

Port of ``localai_tpu/api/stores.py``: ``POST /stores/set``,
``/stores/get``, ``/stores/delete`` and ``/stores/find`` over the
server's ``stores.StoreRegistry`` (``manager.stores``, on the app's
device), with the JAX package's bodies, statuses and texts. A body's
``store`` names the store (default ``"default"``); values are strings or
``{"b64": ...}`` objects and come back as UTF-8 text; a store's
``ValueError`` (a key of another dimension) is a 400.
"""

from __future__ import annotations

import base64

from localai_tpu_torch.api.openai import APIError


def _store(manager, body: dict):
    return manager.stores.get(body.get("store") or "default")


def _decode_values(raw: list) -> list[bytes]:
    out = []
    for v in raw:
        if isinstance(v, str):
            out.append(v.encode("utf-8"))
        elif isinstance(v, dict) and "b64" in v:
            try:
                out.append(base64.b64decode(v["b64"]))
            except Exception:
                raise APIError(400, "invalid base64 value") from None
        else:
            raise APIError(
                400, "values must be strings or {\"b64\": ...} objects")
    return out


def _run(fn, *args):
    """A store call, its input errors mapped to 400."""
    try:
        return fn(*args)
    except ValueError as e:
        raise APIError(400, str(e)) from None


def stores_set(manager, body: dict) -> dict:
    keys = body.get("keys") or []
    values = _decode_values(body.get("values") or [])
    _run(_store(manager, body).set, keys, values)
    return {}


def stores_get(manager, body: dict) -> dict:
    keys, values = _run(_store(manager, body).get, body.get("keys") or [])
    found_keys, found_vals = [], []
    for k, v in zip(keys, values):
        if v is not None:
            found_keys.append(k)
            found_vals.append(v.decode("utf-8", "replace"))
    return {"keys": found_keys, "values": found_vals}


def stores_delete(manager, body: dict) -> dict:
    _run(_store(manager, body).delete, body.get("keys") or [])
    return {}


def stores_find(manager, body: dict) -> dict:
    key = body.get("key")
    if not key:
        raise APIError(400, "need key")
    try:
        top_k = int(body.get("topk") or body.get("top_k") or 10)
    except (TypeError, ValueError):
        raise APIError(400, "topk must be an integer") from None
    if top_k < 1:
        raise APIError(400, "topk must be >= 1")
    keys, values, sims = _run(_store(manager, body).find, key, top_k)
    return {
        "keys": keys,
        "values": [v.decode("utf-8", "replace") for v in values],
        "similarities": sims,
    }


POST = {"/stores/set": stores_set, "/stores/get": stores_get,
        "/stores/delete": stores_delete, "/stores/find": stores_find}
