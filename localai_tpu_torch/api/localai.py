"""LocalAI-specific endpoints of the port: health, version, metrics,
system info, tokenize, backend monitor/metrics/shutdown.

Port of the routes of ``localai_tpu/api/localai.py`` that the port can
serve, written, as ``api.openai`` is, as framework-free functions over
parsed JSON (``api.server`` maps HTTP onto them): GET handlers take
``(manager, query)``, POST handlers ``(manager, body)``. The JAX package's
fleet, SLO, usage and profiler routes wait for those subsystems (ROADMAP
items 15 part 2 and 23). ``/readyz`` stays in ``api.openai``.
"""

from __future__ import annotations

import torch

from localai_tpu_torch import __version__
from localai_tpu_torch.api.openai import APIError, _model_name, _serving
from localai_tpu_torch.obs.metrics import REGISTRY, update_engine_gauges
from localai_tpu_torch.obs.trace import STORE


def healthz(manager, query) -> dict:
    return {"status": "ok"}


def version(manager, query) -> dict:
    return {"version": __version__}


def metrics(manager, query) -> str:
    """GET /metrics: the OpenMetrics text. The engine series are refreshed
    here, at scrape time, from each model's ``metrics()`` dict (host reads
    only: counters are monotone totals, gauges point-in-time); the decode
    loop never touches the registry."""
    for name, m in manager.metrics().items():
        if isinstance(m, dict):
            update_engine_gauges(name, m)
    # trace-store sizing receipt (LOCALAI_TRACE_CAPACITY): dashboards can
    # tell "trace evicted from the ring" from "trace never recorded"
    REGISTRY.trace_ring_size.set(STORE.capacity)
    return REGISTRY.render()


def system(manager, query) -> dict:
    """GET /system: the device inventory (the JAX package lists its JAX
    devices; the port lists the server's torch device kind: every CUDA
    card, or the CPU)."""
    if torch.device(manager.app.device).type == "cuda":
        devices = [{"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "process_index": 0}
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [{"id": 0, "platform": "cpu", "kind": "cpu",
                    "process_index": 0}]
    return {
        "version": __version__,
        "devices": devices,
        "backends": ["torch"],
        "loaded_models": manager.loaded_names(),
        "configured_models": manager.loader.names(),
    }


def tokenize(manager, body: dict) -> dict:
    """POST {model, content} → {tokens}: the model's tokenizer, no BOS (the
    first configured model when ``model`` is absent)."""
    name = _model_name(manager, body)
    content = body.get("content") or body.get("prompt") or ""
    sm, _ = _serving(manager, {"model": name})
    return {"tokens": sm.tokenizer.encode(str(content), add_bos=False)}


def _model_arg(body: dict) -> str:
    name = body.get("model", "")
    if not name:
        raise APIError(400, "missing 'model'")
    return name


def backend_monitor(manager, body: dict) -> dict:
    """POST {model} → the engine's status and metrics."""
    return manager.monitor(_model_arg(body))


def backend_shutdown(manager, body: dict) -> dict:
    name = _model_arg(body)
    return {"shutdown": manager.shutdown_model(name), "model": name}


def engine_metrics(manager, query) -> dict:
    """GET /backend/metrics: every loaded model's ``metrics()`` dict."""
    return manager.metrics()
