"""Observability for the port: request traces, the metrics registry,
engine lifecycle telemetry and JSON logs (ROADMAP item 15, part 1).

  * ``obs.trace`` — a lock-protected span recorder with one bounded ring
    of finished traces per kind (``LOCALAI_TRACE_CAPACITY``, default 256).
    Every timestamp is ``time.monotonic()`` on the host: instrumentation
    adds no device work and no synchronisation to the step loop.
  * ``obs.metrics`` — the process-wide OpenMetrics registry (the families
    the port feeds, under the JAX package's names) and
    ``update_engine_gauges``, run at scrape time.
  * ``obs.engine`` — ``EngineTelemetry``, which turns a request's
    lifecycle (queued → admitted → prefill → decode → drained) into spans
    and the TTFT, TPOT and queue-wait observations.
  * ``obs.logging`` — the structured JSON log formatter with the request's
    trace id bound per handler thread.

HTTP surface: ``GET /metrics`` (``api.localai``), ``GET /v1/traces``,
``/v1/traces/{id}`` and ``/debug/timeline/{request_id}`` (``api.traces``),
fed by the request wrapper of ``api.server``. Copies of the JAX package's
``localai_tpu/obs`` modules of the same names (stdlib only, no import of
that package).
"""

from localai_tpu_torch.obs.engine import EngineTelemetry
from localai_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label_value,
    update_engine_gauges,
)
from localai_tpu_torch.obs.trace import (
    STORE,
    RequestTrace,
    Span,
    TraceStore,
    new_trace_id,
)

__all__ = [
    "REGISTRY",
    "STORE",
    "Counter",
    "EngineTelemetry",
    "Gauge",
    "Histogram",
    "Registry",
    "RequestTrace",
    "Span",
    "TraceStore",
    "escape_label_value",
    "new_trace_id",
    "update_engine_gauges",
]
