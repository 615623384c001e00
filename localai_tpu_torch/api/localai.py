"""LocalAI-specific endpoints of the port: health, version, metrics,
system info, tokenize, backend monitor/metrics/shutdown/trace, the SLO
observatory (``/v1/slo``) and usage accounting (``/v1/usage``).

Port of the routes of ``localai_tpu/api/localai.py`` that the port can
serve, written, as ``api.openai`` is, as framework-free functions over
parsed JSON (``api.server`` maps HTTP onto them): GET handlers take
``(manager, query)``, POST handlers ``(manager, body)``. The JAX
package's fleet routes ``GET /v1/fleet``, ``POST
/v1/fleet/{model}/swap`` and the serving instance's ``POST
/federated/register`` (a remote worker adopted into a fleet) serve the
port's fleets; the two POST routes take the request's ``Authorization``
header and are guarded by ``peer_token``, as on the JAX package.
``/readyz`` stays in ``api.openai``.
"""

from __future__ import annotations

import hmac
import time

import torch

from localai_tpu_torch import __version__
from localai_tpu_torch.api.openai import APIError, _model_name, _serving
from localai_tpu_torch.obs import device as obs_device
from localai_tpu_torch.obs import profiler as obs_profiler
from localai_tpu_torch.obs import slo as obs_slo
from localai_tpu_torch.obs.history import HISTORY
from localai_tpu_torch.obs.ledger import LEDGER
from localai_tpu_torch.obs.metrics import REGISTRY, update_engine_gauges
from localai_tpu_torch.obs.trace import STORE
from localai_tpu_torch.utils.paths import verify_path


def healthz(manager, query) -> dict:
    return {"status": "ok"}


def version(manager, query) -> dict:
    return {"version": __version__}


def metrics(manager, query) -> str:
    """GET /metrics: the OpenMetrics text. The engine series are refreshed
    here, at scrape time, from each model's ``metrics()`` dict (host reads
    only: counters are monotone totals, gauges point-in-time); the decode
    loop never touches the registry. Every scrape is also a history tick,
    exports the usage ledger, refreshes the device-memory gauges (host
    metadata, never a kernel: the probe lives in /debug/devices), the
    SLO burn-rate and shedding gauges, and the batch lane's job-state and
    lane-paused gauges."""
    for name, m in manager.metrics().items():
        if isinstance(m, dict):
            update_engine_gauges(name, m)
            HISTORY.observe_engine(name, m)
    LEDGER.export(REGISTRY)
    HISTORY.observe_ledger(LEDGER)
    # the fleets' replica-state and directory gauges (host reads; the
    # routed / transfer counters are event-driven)
    for sm in manager.loaded_snapshot().values():
        export = getattr(getattr(sm, "scheduler", None), "export_gauges",
                         None)
        if export is not None:
            export()
    runners = [r for r in (getattr(sm, "runner", None)
                           for sm in manager.loaded_snapshot().values())
               if r is not None]
    obs_device.update_device_gauges(runners)
    obs_slo.SLO.export_gauges()
    # trace-store sizing receipt (LOCALAI_TRACE_CAPACITY): dashboards can
    # tell "trace evicted from the ring" from "trace never recorded"
    REGISTRY.trace_ring_size.set(STORE.capacity)
    # the batch lane: the job-state gauge and the lane-paused flag (host
    # reads of the job store and the executor)
    batch = getattr(manager, "batch_state", None)
    if batch is not None:
        batch.batches.export_gauges()
        svc = batch.executor
        REGISTRY.batch_lane_paused.set(
            1 if (svc is not None and svc.paused) else 0)
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


def slo_report(manager, query) -> dict:
    """GET /v1/slo: per-model sliding-window (1m/5m/30m) TTFT / TPOT /
    e2e / queue-wait percentiles, burn rates against the configured p95
    targets, and shedding state (``obs.slo``)."""
    return obs_slo.SLO.report()


def _float_query(query: dict, name: str):
    raw = query.get(name)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError:
        raise APIError(400, f"{name} must be a number") from None


def usage(manager, query) -> dict:
    """GET /v1/usage: the usage ledger's per-(tenant, model, lane) panes
    and the goodput/waste decomposition (``obs.ledger``). ``?since=<unix
    ts>`` or ``?window=<seconds>`` aggregate the bounded event ring
    instead of the lifetime totals (``coverage_start`` says how far back
    it reaches). Tenants are ``t-<sha256/12>`` buckets or ``anonymous`` —
    a raw API key never appears. ``?replicas=1`` adds the fleets'
    per-replica panes under ``replicas`` (``obs.fleetview.fleet_usage``;
    an in-process replica shares this process's ledger and says
    ``shared_ledger``)."""
    out = LEDGER.usage_payload(since=_float_query(query, "since"),
                               window=_float_query(query, "window"))
    if query.get("replicas") not in (None, "", "0"):
        from localai_tpu_torch.obs.fleetview import fleet_usage

        panes = {}
        for name, sm in manager.loaded_snapshot().items():
            if getattr(sm, "pool", None) is not None:
                panes[name] = fleet_usage(sm)
        out["replicas"] = panes
    return out


def fleet_status(manager, query) -> dict:
    """GET /v1/fleet: per-model replica states, dial health, routing
    counters by reason (affinity / directory / least_loaded / failover /
    queue_override, and route-around), prefix transfers, the directory,
    migrations, per-replica shedding and the autoscaler (``fleet``).
    Models served by one engine are listed with ``fleet: false``."""
    app = manager.app
    out: dict = {}
    for name, sm in manager.loaded_snapshot().items():
        status_fn = getattr(sm, "fleet_status", None)
        out[name] = ({"fleet": True, **status_fn()} if status_fn
                     else {"fleet": False})
    return {
        "configured_replicas": app.fleet_replicas,
        "configured_prefill_replicas": app.fleet_prefill_replicas,
        "backend": app.fleet_backend,
        "models": out,
    }


def _peer_refused(manager, authorization: str):
    """The 401 answer when ``peer_token`` is set and the bearer token is
    not it (compared in constant time), else None."""
    token = manager.app.peer_token
    if token and not hmac.compare_digest(
            authorization.removeprefix("Bearer ").strip(), token):
        return 401, {"error": "invalid peer token"}
    return None


def fleet_register(manager, body, authorization: str = ""):
    """POST /federated/register on the serving instance: a remote worker
    announces itself (``{"address": "host:port", "model": optional,
    "role": "decode" | "prefill"}``) and is adopted into the matching
    fleet's pool as a RemoteReplica (dialed and loaded before the answer;
    one that stops answering dials is evicted and redialed on backoff).
    The JAX package's statuses and bodies: 401 on a wrong peer token, 400
    without an address, on an unroutable one or an unknown role, 409 when
    no fleet, or more than one without ``model``, could take it."""
    from localai_tpu_torch.federation.server import (
        validate_advertised_address,
    )

    refused = _peer_refused(manager, authorization)
    if refused:
        return refused
    try:
        address = str(body["address"])
    except Exception:  # noqa: BLE001 — any unreadable body alike
        return 400, {"error": "address is required"}
    try:
        validate_advertised_address(address)
    except ValueError as e:
        return 400, {"error": str(e)}
    role = str(body.get("role", "decode"))
    if role not in ("decode", "prefill"):
        return 400, {"error": f"unknown role {role!r} (decode|prefill)"}
    model = body.get("model")
    targets = {name: sm for name, sm in manager.loaded_snapshot().items()
               if (not model or name == model)
               and hasattr(sm, "adopt_remote")}
    if not targets:
        return 409, {"error": (f"model {model!r} is not fleet-served"
                               if model else "no fleet-served model loaded")}
    if len(targets) > 1:
        # a worker holds one model: adopted into two pools, the second
        # would serve the first one's model under its own name
        return 409, {"error": "multiple fleet-served models are loaded "
                              f"({sorted(targets)}); pass \"model\" to say "
                              "which one the peer serves"}
    adopted = {name: sm.adopt_remote(address, role)
               for name, sm in targets.items()}
    return 200, {"address": address, "adopted": adopted}


def fleet_swap(manager, body: dict, model: str, authorization: str = ""):
    """POST /v1/fleet/{model}/swap: the hot weight swap — boot fresh
    replicas (``{"checkpoint": "ref"}`` switches weights; an empty body
    recycles the current ones), shift router traffic, drain and retire
    the old generation. 200 with the result, 409 when the swap did not
    happen or the model is not fleet-served, 404 when it is not
    loaded, 401 on a wrong peer token (it changes serving capacity)."""
    refused = _peer_refused(manager, authorization)
    if refused:
        return refused
    if not isinstance(body, dict):
        raise APIError(400, "invalid JSON body: body must be a JSON object")
    checkpoint = body.get("checkpoint")
    if checkpoint is not None and not isinstance(checkpoint, str):
        raise APIError(400, "checkpoint must be a string")
    sm = manager.loaded_snapshot().get(model)
    if sm is None:
        raise APIError(404, f"model {model!r} is not loaded")
    swap_fn = getattr(sm, "swap", None)
    if swap_fn is None:
        raise APIError(409, f"model {model!r} is not fleet-served")
    result = swap_fn(checkpoint)
    return (200 if result.get("ok") else 409), {"model": model, **result}


def backend_trace(manager, body: dict) -> dict:
    """POST {seconds?, dir?} → a ``torch.profiler`` capture (CPU and CUDA
    activity, a Chrome-trace JSON ``<trace_dir>/trace.json``) of
    ``seconds`` (0.1–60, default 3) while serving goes on, under
    ``<backend assets>/<dir>``
    (default ``traces``; ``dir`` must stay under the backend assets).
    One capture at a time, shared with the anomaly profiler: a second
    one is a 409."""
    try:
        seconds = float(body.get("seconds", 3.0))
    except (TypeError, ValueError):
        raise APIError(400, "seconds must be a number") from None
    if not 0.1 <= seconds <= 60.0:
        raise APIError(400, "seconds must be in [0.1, 60]")
    base = manager.app.backend_assets_path or "."
    try:
        out = verify_path(str(body.get("dir", "traces")), base)
    except ValueError as e:
        raise APIError(400, str(e)) from None
    prof = obs_profiler.PROFILER
    if not prof.acquire_capture():
        raise APIError(409, "a trace capture is already running")
    try:
        path = str(out / time.strftime("trace-%Y%m%d-%H%M%S"))
        obs_profiler.torch_capture(path, seconds)
    finally:
        prof.release_capture()
    return {"trace_dir": path, "seconds": seconds}
