"""Minimal OpenMetrics/Prometheus registry (the process-wide metric set).

A copy of ``localai_tpu/obs/metrics.py``'s registry (``Histogram``,
``Counter``, ``Gauge``, ``render()``: the same text, label escaping and
buckets) holding the families the port feeds, under the JAX package's
names, help text and labels: the API-call histogram, per-request latency
histograms (TTFT, TPOT, queue wait), request and token counters, the
engine's gauges and counters (batch occupancy, KV utilization, the paged
pool, chunked prefill, dispatches, prompt-cache and prefix reuse,
speculation), first-dispatch counts, the flight recorder's step times and
the dispatch anatomy, SLO burn rates and shedding, the batch lane, fault
injection and self-healing (injected faults, NaN rows and quarantined
slots, rebuilds, the failed latch, KV invariant violations), the stall
watchdog, device health and memory, anomaly profiles, and the usage
ledger's tenant, goodput and waste series, and the kernel tuning
table's lookups, entries and sweep seconds. Event-time series are observed by their
owners (``obs.engine``, ``obs.slo``, ``obs.watchdog``, ``obs.compile``,
``obs.profiler``); point-in-time gauges are refreshed at scrape time by
``update_engine_gauges`` from the scheduler's ``metrics()`` dict, so the
decode loop never touches the registry. Four help texts name the port's
machinery where the JAX package's name JAX's (first-dispatch counts,
profiler captures, the memory census). The fleet's families
(``localai_fleet_*``, the KV tier's four ``localai_kv_tier_*``, the
autoscaler's decisions and target, model swaps) are fed by ``fleet`` and
at scrape time; those of remote replicas (adoptions, evictions, redials,
their backoff) read 0 until the port has remote replicas (ROADMAP item
23, part 2).
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
        # the JAX package's names; on the port a "compilation" is the
        # first call of a program shape (obs.compile)
        self.compile_count = Counter(
            "localai_xla_compile_total",
            "Program first dispatches per shape (the port runs eagerly: "
            "the first call pays kernel loads and allocator growth)",
        )
        self.compile_seconds = Counter(
            "localai_xla_compile_seconds_total",
            "Wall seconds spent in first dispatches per program shape",
        )
        # -- flight recorder + SLO observatory (obs.flight / obs.slo) -----
        self.step_time_ms = Gauge(
            "localai_step_time_ms",
            "Per-token decode step time over the flight ring's resident "
            "dispatches — the last N, not a time window, so an idle "
            "engine reports its most recent activity (quantile label: "
            "p50/p99)",
        )
        self.dispatch_phase_ms = Gauge(
            "localai_dispatch_phase_ms",
            "Dispatch-anatomy phase time over the flight ring's recent "
            "window, compile rows excluded (phase label: gap/sched/"
            "launch/sync, quantile label: p50/p90/p99 — see obs.anatomy "
            "for phase semantics)",
        )
        self.host_overhead_fraction = Gauge(
            "localai_host_overhead_fraction",
            "Share of windowed dispatch wall time the host spent NOT "
            "blocked on the device (gap+sched+launch over dispatch "
            "wall) — the number fused multi-step dispatch must drive down",
        )
        self.device_bubble_fraction = Gauge(
            "localai_device_bubble_fraction",
            "Estimated share of windowed dispatch wall time the device "
            "sat idle: host phases not covered by a later result-fetch "
            "block (estimator — see obs.anatomy caveats)",
        )
        self.slo_burn_rate = Gauge(
            "localai_slo_burn_rate",
            "Error-budget burn rate per model and window "
            "(1.0 = burning exactly the error budget)",
        )
        self.overload_shedding = Gauge(
            "localai_overload_shedding",
            "1 while new generation work for the model is refused (429) "
            "by SLO burn-rate admission control",
        )
        self.requests_shed = Counter(
            "localai_requests_shed_total",
            "Generation requests refused with 429 by SLO burn-rate "
            "admission control",
        )
        # -- offline batch subsystem (localai_tpu_torch.batch) -------------
        self.batch_jobs = Gauge(
            "localai_batch_jobs",
            "Batch jobs by lifecycle state "
            "(validating/in_progress/completed/failed/cancelled/expired)",
        )
        self.batch_lines = Counter(
            "localai_batch_lines_total",
            "Batch input lines drained by result (completed/failed)",
        )
        self.batch_lane_paused = Gauge(
            "localai_batch_lane_paused",
            "1 while the background batch lane is paused because the SLO "
            "observatory reports overload shedding (in-flight lines are "
            "requeued, never failed)",
        )
        self.batch_queue_depth = Gauge(
            "localai_batch_queue_depth",
            "Requests waiting in the scheduler's background batch lane",
        )
        # -- fleet router (fleet) --------------------------------------
        self.fleet_replicas = Gauge(
            "localai_fleet_replicas",
            "Engine replicas per model by lifecycle state "
            "(starting/healthy/dead/respawning)",
        )
        self.fleet_routed = Counter(
            "localai_fleet_routed_total",
            "Requests placed by the fleet router by reason "
            "(affinity/directory/least_loaded/failover/queue_override)",
        )
        self.fleet_prefix_transfers = Counter(
            "localai_fleet_prefix_transfers_total",
            "Disaggregated prefill→decode KV-prefix handoffs completed",
        )
        self.fleet_prefix_transfer_bytes = Counter(
            "localai_fleet_prefix_transfer_bytes_total",
            "Packed KV-prefix bytes streamed between replicas over "
            "TransferPrefix",
        )
        # -- fleet KV economy (fleet.kveconomy) ----------------------------
        self.fleet_directory_entries = Gauge(
            "localai_fleet_directory_entries",
            "Prefix keys tracked by the fleet prefix directory "
            "(which replica holds which prefix blocks)",
        )
        self.fleet_directory_hits = Counter(
            "localai_fleet_directory_hits_total",
            "Routing probes the prefix directory answered with a live "
            "holder (request placed on known-warm KV)",
        )
        self.fleet_directory_misses = Counter(
            "localai_fleet_directory_misses_total",
            "Routing probes the prefix directory could not answer "
            "(unknown key or no eligible holder — ring heuristic decides)",
        )
        self.fleet_directory_drops = Counter(
            "localai_fleet_directory_drops_total",
            "Directory entries invalidated: stale holders dropped after "
            "a failed fetch + whole-replica invalidations on death",
        )
        self.fleet_sibling_transfers = Counter(
            "localai_fleet_sibling_transfers_total",
            "Directory-driven sibling KV-prefix fetches completed "
            "(prefix pulled over TransferPrefix instead of re-prefilled)",
        )
        self.fleet_sibling_transfer_bytes = Counter(
            "localai_fleet_sibling_transfer_bytes_total",
            "Packed KV bytes moved by sibling prefix fetches",
        )
        self.fleet_sibling_fallbacks = Counter(
            "localai_fleet_sibling_fallbacks_total",
            "Sibling fetches that failed (stale directory entry / dying "
            "donor) and fell back to a plain local prefill",
        )
        self.fleet_migrations = Counter(
            "localai_fleet_migrations_total",
            "Live in-flight slot migrations completed (request resumed "
            "on the destination replica mid-generation)",
        )
        self.fleet_migration_fallbacks = Counter(
            "localai_fleet_migration_fallbacks_total",
            "Live migrations that could not complete and fell back "
            "(full re-prefill re-dispatch, or error if already streamed)",
        )
        self.kv_tier_blocks = Gauge(
            "localai_kv_tier_blocks",
            "Cold prefix blocks currently resident in the host-RAM KV "
            "tier (spilled out of HBM)",
        )
        self.kv_tier_bytes = Gauge(
            "localai_kv_tier_bytes",
            "Host-RAM bytes held by the KV tier (bounded by "
            "LOCALAI_KV_TIER_MB)",
        )
        self.kv_tier_spills = Counter(
            "localai_kv_tier_spills_total",
            "Prefix blocks spilled HBM→host RAM at eviction instead of "
            "being discarded",
        )
        self.kv_tier_reloads = Counter(
            "localai_kv_tier_reloads_total",
            "Spilled prefix blocks re-onboarded host RAM→HBM on a "
            "prefix-match hit (a prefill saved by the tier)",
        )
        self.fleet_respawn_backoff = Gauge(
            "localai_fleet_respawn_backoff_s",
            "Current jittered-exponential respawn hold per dead replica "
            "(0 after a successful rejoin)",
        )
        # cross-host fleet (remote replica adoption + network faults):
        # remotes are evicted-with-redial, never respawned — this process
        # does not own a peer's lifecycle
        self.fleet_adoptions = Counter(
            "localai_fleet_adoptions_total",
            "Remote replicas adopted into a fleet pool (static "
            "LOCALAI_FLEET_HOSTS entries + federation-registry joins)",
        )
        self.fleet_evictions = Counter(
            "localai_fleet_evictions_total",
            "Remote replicas evicted from routing after consecutive "
            "failed health dials (partition / refused / flapping peer)",
        )
        self.fleet_redials = Counter(
            "localai_fleet_redials_total",
            "Evicted remote replicas successfully redialed back into "
            "the routing ring",
        )
        self.fleet_redial_backoff = Gauge(
            "localai_fleet_redial_backoff_s",
            "Current jittered-exponential redial hold per evicted remote "
            "replica (0 after a successful rejoin)",
        )
        self.fleet_rpc_retries = Counter(
            "localai_fleet_rpc_retries_total",
            "Bounded jittered retries of idempotent cross-host fleet "
            "RPCs, by rpc name (fleet.net.call_with_retries)",
        )
        self.fleet_rpc_deadlines = Counter(
            "localai_fleet_rpc_deadline_exceeded_total",
            "Cross-host fleet RPCs (dispatch/prefill stream inactivity "
            "or control-plane calls) that blew "
            "LOCALAI_FLEET_RPC_TIMEOUT_S",
        )
        # -- elastic capacity (fleet.autoscale) ----------------------------
        self.autoscale_decisions = Counter(
            "localai_autoscale_decisions_total",
            "Autoscale policy decisions applied per model by action "
            "(scale_out/scale_in/scale_to_zero/cold_start/swap/none)",
        )
        self.fleet_target_replicas = Gauge(
            "localai_fleet_target_replicas",
            "Decode replica count the autoscale controller is steering "
            "the fleet toward (0 while scaled to zero)",
        )
        self.model_swaps = Counter(
            "localai_model_swaps_total",
            "Hot weight swaps completed (fresh replicas booted on the "
            "new checkpoint, traffic shifted, old replicas drained)",
        )
        # -- fault injection + self-healing (localai_tpu_torch.faults) -----
        self.faults_injected = Counter(
            "localai_faults_injected_total",
            "Deterministic faults fired by injection site "
            "(LOCALAI_FAULT_* / POST /debug/faults — 0 in production)",
        )
        self.nan_rows = Counter(
            "localai_nan_rows_total",
            "Decode logits rows caught non-finite by the per-row NaN/inf "
            "guard (the affected request fails `error`, its slot is "
            "quarantined; co-batched requests keep streaming)",
        )
        self.quarantined_slots = Gauge(
            "localai_quarantined_slots",
            "Decode slots currently held out of admission by the NaN "
            "quarantine",
        )
        self.engine_rebuilds = Counter(
            "localai_engine_rebuilds_total",
            "Self-healing engine rebuilds completed (stall → drain → "
            "runner re-init → probe dispatch → engine thread restart)",
        )
        self.engine_failed = Gauge(
            "localai_engine_failed",
            "1 after the supervisor exhausted its bounded rebuild budget "
            "and marked the model failed (submits fail fast)",
        )
        # the tuning table (ops.tuning) and its sweep (tools.autotune)
        self.autotune_lookups = Counter(
            "localai_autotune_lookups_total",
            "Per-shape kernel tuning-table lookups (ops.tuning) by "
            "result=hit|miss — a fleet whose table stopped matching its "
            "serving shapes shows an all-miss ratio here",
        )
        self.autotune_entries = Gauge(
            "localai_autotune_table_entries",
            "Entries in the loaded kernel tuning table "
            "(LOCALAI_TUNE_CACHE; 0 = defaults everywhere)",
        )
        self.autotune_sweep_seconds = Gauge(
            "localai_autotune_sweep_seconds",
            "Wall seconds of the last tools/autotune.py sweep per shape "
            "key",
        )
        # the port's labels: its paged decode attention is the CUDA kernel
        # (K1) on the card and the kernel's plain version on the CPU
        self.paged_kernel_impl = Gauge(
            "localai_paged_kernel_impl",
            "1 for the paged decode attention implementation each engine "
            "selected (impl=kernel|torch)",
        )
        self.kv_invariant_violations = Counter(
            "localai_kv_invariant_violations_total",
            "BlockAllocator.check_invariants violations observed at "
            "scheduler drains (LOCALAI_KV_CHECK=1) — any nonzero value "
            "is a block leak",
        )
        self.trace_ring_size = Gauge(
            "localai_trace_ring_size",
            "Finished-trace ring capacity per trace kind "
            "(LOCALAI_TRACE_CAPACITY; default 256)",
        )
        self.profiles_captured = Counter(
            "localai_profiles_captured_total",
            "Anomaly-triggered torch.profiler captures by trigger "
            "(stall/slo_shed/step_p99_regression) — each one is listed "
            "with its triggering trace id at GET /debug/profiles",
        )
        # -- stall forensics + device health (obs.watchdog / obs.device) --
        self.engine_stalled = Gauge(
            "localai_engine_stalled",
            "1 while a guarded device round-trip has made no progress past "
            "the watchdog deadline (per channel)",
        )
        self.last_progress_age = Gauge(
            "localai_last_progress_age_seconds",
            "Seconds since the last heartbeat on an armed watchdog channel",
        )
        self.stalls = Counter(
            "localai_stalls_total",
            "Watchdog trips (stack-dump forensic spans recorded)",
        )
        self.device_ok = Gauge(
            "localai_device_ok",
            "1 when the last timeout-guarded device liveness probe succeeded",
        )
        self.device_probe_seconds = Gauge(
            "localai_device_probe_seconds",
            "Round-trip wall seconds of the last device liveness probe",
        )
        self.hbm_bytes_in_use = Gauge(
            "localai_hbm_bytes_in_use",
            "Device memory in use per device (memory_stats)",
        )
        self.hbm_peak_bytes = Gauge(
            "localai_hbm_peak_bytes_in_use",
            "Peak device memory in use per device (memory_stats)",
        )
        self.hbm_bytes_limit = Gauge(
            "localai_hbm_bytes_limit",
            "Device memory capacity per device (memory_stats)",
        )
        self.hbm_live_bytes = Gauge(
            "localai_hbm_live_bytes",
            "Device memory by category (kv_cache/weights: the loaded "
            "runners' tensors; other: the rest the allocator holds)",
        )
        # -- usage accounting plane (obs.ledger) ---------------------------
        # tenant labels are ALWAYS derive_tenant() outputs (hashed key /
        # anonymous / overflow) — never a raw API key; cardinality is
        # bounded by the ledger's tenant LRU
        self.tenant_requests = Counter(
            "localai_tenant_requests_total",
            "Finished generation requests per (tenant, model, lane) "
            "ledger pane (tenant = hashed API key bucket)",
        )
        self.tenant_tokens = Counter(
            "localai_tenant_tokens_total",
            "Delivered (goodput) completion tokens per tenant pane",
        )
        self.tenant_prompt_tokens = Counter(
            "localai_tenant_prompt_tokens_total",
            "Prompt tokens processed per tenant pane",
        )
        self.tenant_dispatch_ms = Counter(
            "localai_tenant_dispatch_ms_total",
            "Engine-resident service milliseconds (submit→done minus "
            "queue wait) attributed per tenant pane",
        )
        self.tenant_queue_wait_ms = Counter(
            "localai_tenant_queue_wait_ms_total",
            "Milliseconds requests waited for a decode slot per tenant "
            "pane",
        )
        self.tenant_kv_block_seconds = Counter(
            "localai_tenant_kv_block_seconds_total",
            "Paged-KV memory cost per tenant pane: context blocks × "
            "slot-resident seconds (PagedAttention block-seconds)",
        )
        self.tenant_lru_evictions = Counter(
            "localai_tenant_lru_evictions_total",
            "Tenant panes folded into the `overflow` bucket when the "
            "ledger's LRU exceeded LOCALAI_TENANT_MAX",
        )
        self.goodput_tokens = Counter(
            "localai_goodput_tokens_total",
            "Tokens delivered by naturally finished requests "
            "(stop/length) per model — the goodput side of the "
            "decomposition",
        )
        self.goodput_ratio = Gauge(
            "localai_goodput_ratio",
            "delivered / (delivered + waste) tokens per model (1.0 with "
            "no recorded waste)",
        )
        self.waste_tokens = Counter(
            "localai_waste_tokens_total",
            "Wasted work in tokens per model by reason (spec_rejected/"
            "failover_reprefill/migration_reprefill/cancelled/error/"
            "nan_quarantine — reprefill classes count prompt tokens)",
        )
        self.waste_requests = Counter(
            "localai_waste_requests_total",
            "Requests whose work was (partly) wasted, per model by "
            "reason (shed counts refused admissions)",
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
    scheduler's ``metrics()`` dict (the JAX package's function). Called
    at /metrics scrape time —
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
    if "batch_queue_depth" in m:
        reg.batch_queue_depth.set(m["batch_queue_depth"], model=name)
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
    if "kv_tier_spills" in m:
        # the host KV tier is attached (one engine, or a fleet's roll-up,
        # which carries the tier sums without the kv_blocks pane)
        reg.kv_tier_blocks.set(m.get("kv_tier_blocks", 0), model=name)
        reg.kv_tier_bytes.set(m.get("kv_tier_bytes", 0), model=name)
        reg.kv_tier_spills.set_total(m.get("kv_tier_spills", 0), model=name)
        reg.kv_tier_reloads.set_total(
            m.get("kv_tier_reloads", 0), model=name)
    reg.decode_dispatches.set_total(m.get("dispatches", 0), model=name)
    if m.get("shed_total"):
        # shed admissions are whole-request waste (no tokens were ever
        # generated); the requests_shed family stays owned by obs.slo —
        # this is the decomposition's view of the same monotone count
        reg.waste_requests.set_total(m["shed_total"], model=name,
                                     reason="shed")
    if "quarantined_slots" in m:
        # point-in-time NaN-quarantine census; the nan_rows/rebuilds
        # counter families are event-time (scheduler/supervisor are their
        # sole writers) and deliberately not synced here
        reg.quarantined_slots.set(m["quarantined_slots"], model=name)
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
        # waste decomposition (obs.ledger): rejected draft tokens are
        # device work the flight ring never counted; set_total max-merges
        # with the ledger's own export of the same cell
        rejected = (m.get("spec_draft_tokens", 0)
                    - m.get("spec_accepted_tokens", 0))
        if rejected > 0:
            reg.waste_tokens.set_total(rejected, model=name,
                                       reason="spec_rejected")
    # windowed step-time percentiles from the flight ring (absent until a
    # post-first-dispatch record lands)
    for q in ("p50", "p99"):
        v = m.get(f"step_ms_{q}")
        if v is not None:
            reg.step_time_ms.set(v, model=name, quantile=q)
    # dispatch anatomy (obs.anatomy): windowed phase percentiles + the
    # derived host/bubble fractions; absent keys leave the gauges alone
    for ph, qs in (m.get("dispatch_phase_ms") or {}).items():
        for q, v in qs.items():
            if v is not None:
                reg.dispatch_phase_ms.set(v, model=name, phase=ph,
                                          quantile=q)
    v = m.get("host_overhead_fraction")
    if v is not None:
        reg.host_overhead_fraction.set(v, model=name)
    v = m.get("device_bubble_fraction")
    if v is not None:
        reg.device_bubble_fraction.set(v, model=name)


REGISTRY = Registry()
