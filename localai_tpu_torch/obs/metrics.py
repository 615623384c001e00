"""Minimal OpenMetrics/Prometheus registry (the process-wide metric set).

A copy of ``localai_tpu/obs/metrics.py``'s registry (``Histogram``,
``Counter``, ``Gauge``, ``render()``: the same text, label escaping and
buckets) holding the families the port feeds, under the JAX package's
names, help text and labels: the API-call histogram, per-request latency
histograms (TTFT, TPOT, queue wait), request and token counters, and the
engine's gauges and counters (batch occupancy, KV utilization, the paged
pool, chunked prefill, dispatches, prompt-cache and prefix reuse,
speculation). Event-time series are observed by
``obs.engine.EngineTelemetry``; point-in-time gauges are refreshed at
scrape time by ``update_engine_gauges`` from the scheduler's ``metrics()``
dict, so the decode loop never touches the registry. Families of the
subsystems the port does not have yet (flight recorder, SLO, batch lane,
fleet, faults, XLA compiles, device health, usage ledger, KV tiering) come
with them (ROADMAP item 15, part 2, and the items named there).
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
            30.0, 60.0)
# per-token decode latency lives orders of magnitude below API-call time
_TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5)


def escape_label_value(value: object) -> str:
    r"""OpenMetrics label-value escaping: ``\`` → ``\\``, ``"`` → ``\"``,
    newline → ``\n`` — in that order, so a backslash introduced by the
    quote/newline escapes is not itself re-escaped."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: tuple) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)


class Histogram:
    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] = _BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0, 0]  # counts, sum, n
                self._series[key] = s
            counts, _, _ = s
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += value
            s[2] += 1

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, total, n) in sorted(self._series.items()):
                base = _fmt_labels(key)
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += counts[i]
                    lbl = f"{base},le=\"{ub}\"" if base else f'le="{ub}"'
                    lines.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                cum += counts[-1]
                lbl = f"{base},le=\"+Inf\"" if base else 'le="+Inf"'
                lines.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                suffix = f"{{{base}}}" if base else ""
                lines.append(f"{self.name}_sum{suffix} {total}")
                lines.append(f"{self.name}_count{suffix} {n}")
        return "\n".join(lines)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._series: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def set_total(self, value: float, **labels: str) -> None:
        """Sync the series to an externally tracked monotone total."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._series[key] = max(self._series.get(key, 0.0), value)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key, val in sorted(self._series.items()):
                base = _fmt_labels(key)
                suffix = f"{{{base}}}" if base else ""
                lines.append(f"{self.name}{suffix} {val}")
        return "\n".join(lines)


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._series[key] = value


class Registry:
    """The process-wide metric set.

    Every Histogram/Counter/Gauge attribute set in ``__init__`` is part of
    the /metrics exposition, in definition order (the JAX package's order,
    less the families of unported subsystems)."""

    def __init__(self) -> None:
        self.api_call = Histogram(
            "localai_api_call_seconds", "API call duration by method/path"
        )
        self.tokens_generated = Counter(
            "localai_tokens_generated_total", "Completion tokens emitted"
        )
        self.tokens_prompt = Counter(
            "localai_prompt_tokens_total", "Prompt tokens processed"
        )
        self.active_slots = Gauge(
            "localai_active_slots", "Occupied decode slots per model"
        )
        # -- engine telemetry (obs subsystem) --------------------------
        self.ttft = Histogram(
            "localai_ttft_seconds",
            "Time from request submit to first sampled token",
        )
        self.tpot = Histogram(
            "localai_tpot_seconds",
            "Mean per-output-token decode latency per request",
            buckets=_TPOT_BUCKETS,
        )
        self.queue_wait = Histogram(
            "localai_queue_wait_seconds",
            "Time a request waited for a free decode slot",
        )
        self.requests = Counter(
            "localai_requests_total",
            "Finished generation requests by finish reason",
        )
        self.preemptions = Counter(
            "localai_preemptions_total",
            "Requests that left a decode slot before natural completion",
        )
        self.batch_occupancy = Gauge(
            "localai_batch_occupancy",
            "Occupied fraction of decode slots (continuous-batching load)",
        )
        self.queue_depth = Gauge(
            "localai_queue_depth", "Requests waiting for a decode slot"
        )
        self.kv_utilization = Gauge(
            "localai_kv_slot_utilization",
            "Fraction of KV-cache rows holding live context",
        )
        # -- paged KV cache (engine/paged.py block pool) -------------------
        self.kv_blocks_free = Gauge(
            "localai_kv_blocks_free",
            "Paged-KV blocks available for admission (immediately free + "
            "reclaimable prefix-pool cache)",
        )
        self.kv_blocks_used = Gauge(
            "localai_kv_blocks_used",
            "Paged-KV blocks referenced by live sequences (reservations "
            "included)",
        )
        self.kv_blocks_cached = Gauge(
            "localai_kv_blocks_cached",
            "Paged-KV blocks held only by the prefix-sharing pool "
            "(evicted on demand)",
        )
        self.kv_overcommit = Gauge(
            "localai_kv_overcommit_ratio",
            "Paged-KV pool size as a ratio of the contiguous-footprint "
            "default (LOCALAI_KV_OVERCOMMIT; <1 overcommits HBM, >1 "
            "grows the prefix-sharing pool)",
        )
        self.prefill_chunk_queue = Gauge(
            "localai_prefill_chunk_queue_depth",
            "Prompt chunks queued behind the chunked-prefill lane "
            "(dispatched one per engine iteration, interleaved with decode)",
        )
        self.prefill_chunks = Counter(
            "localai_prefill_chunks_total",
            "Chunked-prefill dispatches issued by the engine thread",
        )
        self.decode_dispatches = Counter(
            "localai_decode_dispatches_total",
            "Compiled decode programs dispatched by the engine thread",
        )
        self.prompt_cache_hits = Counter(
            "localai_prompt_cache_hits_total",
            "Disk prompt-KV cache lookups that returned a usable prefix",
        )
        self.prompt_cache_misses = Counter(
            "localai_prompt_cache_misses_total",
            "Disk prompt-KV cache lookups with no usable prefix",
        )
        self.prompt_cache_hit_rate = Gauge(
            "localai_prompt_cache_hit_rate",
            "hits / (hits + misses) of the disk prompt-KV cache",
        )
        self.prefix_reused = Counter(
            "localai_prefix_tokens_reused_total",
            "Prompt tokens served from reused KV prefixes instead of prefill",
        )
        self.spec_accept_rate = Gauge(
            "localai_speculative_accept_rate",
            "Emitted tokens per active slot-window over the gamma+1 ceiling",
        )
        self.spec_windows = Counter(
            "localai_speculative_windows_total",
            "Speculative draft+verify windows dispatched",
        )
        self.spec_accept_ratio = Gauge(
            "localai_spec_accept_rate",
            "Draft tokens accepted / proposed (lifetime ratio)",
        )
        self.spec_draft_tokens = Counter(
            "localai_spec_draft_tokens_total",
            "Draft tokens proposed to the speculative verify dispatch",
        )
        self.spec_accepted_tokens = Counter(
            "localai_spec_accepted_tokens_total",
            "Draft tokens accepted by the target's accept/sample scan",
        )
        self.spec_tokens_per_dispatch = Gauge(
            "localai_spec_tokens_per_dispatch",
            "Mean emitted tokens per active slot-window (>1 = the "
            "verify-k dispatch beats single-step decode)",
        )
        # the port's labels: its paged decode attention is the CUDA kernel
        # (K1) on the card and the kernel's plain version on the CPU
        self.paged_kernel_impl = Gauge(
            "localai_paged_kernel_impl",
            "1 for the paged decode attention implementation each engine "
            "selected (impl=kernel|torch)",
        )
        self.trace_ring_size = Gauge(
            "localai_trace_ring_size",
            "Finished-trace ring capacity per trace kind "
            "(LOCALAI_TRACE_CAPACITY; default 256)",
        )

    def _all(self) -> list:
        return [v for v in self.__dict__.values()
                if isinstance(v, (Histogram, Counter))]

    def render(self) -> str:
        return "\n".join(m.render() for m in self._all()) + "\n"


# the one-hot labels of localai_paged_kernel_impl: the CUDA kernel, the
# plain PyTorch version (the JAX package's are pallas / lax)
PAGED_IMPLS = ("kernel", "torch")


def update_engine_gauges(name: str, m: dict,
                         registry: Optional[Registry] = None) -> None:
    """Refresh the point-in-time engine series for one model from its
    scheduler's ``metrics()`` dict (the JAX package's function, less the
    feeds of unported subsystems). Called at /metrics scrape time —
    counters are synced with ``set_total`` (monotone), gauges
    overwritten."""
    reg = registry or REGISTRY
    if "error" in m and len(m) == 1:
        return  # an engine that could not answer: keep the last values
    active = m.get("active_slots") or []
    reg.tokens_prompt.set_total(m.get("total_prompt_tokens", 0), model=name)
    reg.tokens_generated.set_total(
        m.get("total_generated_tokens", 0), model=name
    )
    reg.active_slots.set(len(active), model=name)
    # preemptions are NOT synced here: EngineTelemetry.finished() is that
    # family's sole writer
    occupancy = m.get("occupancy")
    if occupancy is None and m.get("num_slots"):
        occupancy = len(active) / m["num_slots"]
    if occupancy is not None:
        reg.batch_occupancy.set(occupancy, model=name)
    reg.queue_depth.set(m.get("queue_depth", 0), model=name)
    if "kv_utilization" in m:
        reg.kv_utilization.set(m["kv_utilization"], model=name)
    if "kv_blocks_total" in m:  # paged KV engines only
        reg.kv_blocks_free.set(m.get("kv_blocks_free", 0), model=name)
        reg.kv_blocks_used.set(m.get("kv_blocks_used", 0), model=name)
        reg.kv_blocks_cached.set(m.get("kv_blocks_cached", 0), model=name)
        reg.kv_overcommit.set(
            m.get("kv_overcommit_ratio", 1.0), model=name)
        reg.prefill_chunk_queue.set(
            m.get("prefill_chunk_queue_depth", 0), model=name)
        reg.prefill_chunks.set_total(m.get("prefill_chunks", 0), model=name)
        impl = m.get("paged_attn_impl")
        if impl:
            # one-hot over the impl label, as the JAX package exports it
            for label in PAGED_IMPLS:
                reg.paged_kernel_impl.set(
                    1.0 if impl == label else 0.0, model=name, impl=label)
    reg.decode_dispatches.set_total(m.get("dispatches", 0), model=name)
    reg.prefix_reused.set_total(m.get("prefix_tokens_reused", 0), model=name)
    pc = m.get("prompt_cache")
    if pc:
        hits, misses = pc.get("hits", 0), pc.get("misses", 0)
        reg.prompt_cache_hits.set_total(hits, model=name)
        reg.prompt_cache_misses.set_total(misses, model=name)
        if hits + misses:
            reg.prompt_cache_hit_rate.set(hits / (hits + misses), model=name)
    if "spec_acceptance_rate" in m:
        reg.spec_accept_rate.set(m["spec_acceptance_rate"], model=name)
        reg.spec_windows.set_total(m.get("spec_windows", 0), model=name)
        reg.spec_accept_ratio.set(
            m.get("spec_accept_rate", 0.0), model=name)
        reg.spec_draft_tokens.set_total(
            m.get("spec_draft_tokens", 0), model=name)
        reg.spec_accepted_tokens.set_total(
            m.get("spec_accepted_tokens", 0), model=name)
        reg.spec_tokens_per_dispatch.set(
            m.get("spec_tokens_per_dispatch", 0.0), model=name)
    # the flight recorder's step-time percentiles and the dispatch
    # anatomy's phase gauges are synced here (ROADMAP item 15, part 2)


REGISTRY = Registry()
