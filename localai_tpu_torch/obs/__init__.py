"""Observability for the port (ROADMAP item 15): request traces, the
metrics registry, engine lifecycle telemetry, JSON logs, the flight
recorder and dispatch anatomy, the stall watchdog, the SLO observatory,
the usage ledger, the metrics history, device health, the program cost
catalog and the anomaly profiler.

  * ``obs.trace`` — a lock-protected span recorder with one bounded ring
    of finished traces per kind (``LOCALAI_TRACE_CAPACITY``, default 256).
    Every timestamp is ``time.monotonic()`` on the host: instrumentation
    adds no device work and no synchronisation to the step loop.
  * ``obs.metrics`` — the process-wide OpenMetrics registry (the families
    the port feeds, under the JAX package's names) and
    ``update_engine_gauges``, run at scrape time.
  * ``obs.engine`` — ``EngineTelemetry``, which turns a request's
    lifecycle (queued → admitted → prefill → decode → drained) into spans,
    the TTFT, TPOT and queue-wait observations, one SLO event and one
    ledger entry.
  * ``obs.logging`` — the structured JSON log formatter with the request's
    trace id bound per handler thread.
  * ``obs.flight`` / ``obs.anatomy`` — a per-scheduler ring of
    per-dispatch records (``LOCALAI_FLIGHT_CAPACITY``) with windowed
    step-time percentiles, and the gap / sched / launch / sync split of
    each dispatch's wall time (``GET /debug/flight``, ``/debug/anatomy``).
  * ``obs.watchdog`` — no-progress detection around every blocking device
    read (``LOCALAI_STALL_DEADLINE_S``), with a ``kind="stall"`` trace of
    every thread's stack on a trip.
  * ``obs.slo`` — 1m/5m/30m latency windows per model, burn rates against
    the ``slo_*`` targets and burn-rate shedding (429 + ``Retry-After``;
    ``GET /v1/slo``).
  * ``obs.ledger`` — per-tenant usage panes (tenant = hashed API key) and
    the goodput / waste decomposition (``GET /v1/usage``).
  * ``obs.history`` — 1 s / 10 s / 5 m rings of the engine and usage
    series, snapshotted under ``LOCALAI_HISTORY_DIR``
    (``GET /debug/history``).
  * ``obs.device`` — the liveness probe, per-card memory stats, the memory
    census and the roofline (``GET /debug/devices``).
  * ``obs.compile`` — first-dispatch counts and the program cost catalog
    (``GET /debug/programs``).
  * ``obs.profiler`` — anomaly-triggered ``torch.profiler`` captures
    (``LOCALAI_PROFILE_*``, ``GET /debug/profiles``), sharing one
    single-flight lock with ``POST /backend/trace``.

Copies of the JAX package's ``localai_tpu/obs`` modules of the same names
(stdlib, numpy and torch only; no import of that package).
"""

from localai_tpu_torch.obs.engine import EngineTelemetry
from localai_tpu_torch.obs.flight import FlightRecorder
from localai_tpu_torch.obs.history import HISTORY, History
from localai_tpu_torch.obs.ledger import (
    LEDGER,
    TenantLedger,
    current_tenant,
    derive_tenant,
)
from localai_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label_value,
    update_engine_gauges,
)
from localai_tpu_torch.obs.profiler import PROFILER, ProfileManager
from localai_tpu_torch.obs.slo import SLO, SLOTracker
from localai_tpu_torch.obs.trace import (
    STORE,
    RequestTrace,
    Span,
    TraceStore,
    new_trace_id,
)
from localai_tpu_torch.obs.watchdog import WATCHDOG, StallEvent, Watchdog

__all__ = [
    "HISTORY",
    "LEDGER",
    "PROFILER",
    "REGISTRY",
    "SLO",
    "STORE",
    "WATCHDOG",
    "Counter",
    "EngineTelemetry",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "History",
    "ProfileManager",
    "Registry",
    "RequestTrace",
    "SLOTracker",
    "Span",
    "StallEvent",
    "TenantLedger",
    "TraceStore",
    "Watchdog",
    "current_tenant",
    "derive_tenant",
    "escape_label_value",
    "new_trace_id",
    "update_engine_gauges",
]
