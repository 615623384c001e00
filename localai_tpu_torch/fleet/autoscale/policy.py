"""Pure capacity policy: per-replica telemetry in, one decision out.

Port of ``localai_tpu/fleet/autoscale/policy.py``. ``decide`` is a
function of (signals, now, cooldown state), thread-free and without side
effects, so the whole decision table is held against the JAX package's
without a fleet, a clock or a daemon (the controller owns those).
Scale-out and scale-in read different thresholds with separate
cooldowns: the hysteresis gap keeps a fleet near one threshold from
flapping a replica up and down every interval.

Signals (all harvested by the fleet already): queue depth and step-time
p99 (continuous-batching load), KV block utilization (paged pool
pressure), SLO burn windows (the per-replica observatory, ``obs.slo``)
and idle seconds (``BaseReplica.idle_s``, 0 while anything is in flight).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

#: every label ``localai_autoscale_decisions_total{action=...}`` can carry
#: (cold_start is controller-originated, swap is operator-originated; the
#: rest come out of ``decide``)
ACTIONS = ("scale_out", "scale_in", "scale_to_zero", "cold_start",
           "swap", "none")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class AutoscaleConfig:
    """Knobs. Replica bounds/idle horizons ride AppConfig (CLI +
    ``LOCALAI_AUTOSCALE_*`` via from_env); the overload thresholds are
    env-only tuning knobs with defaults that match the engine's own
    admission behaviour."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 5.0
    #: a replica this idle (and the fleet above min) is scale-in bait
    in_idle_s: float = 120.0
    #: ALL replicas this idle → scale the model to zero (0 disables)
    zero_idle_s: float = 0.0
    #: mean decode queue depth per healthy replica that means "add one"
    out_queue_depth: float = 4.0
    #: mean KV block-pool utilization that means "add one"
    out_kv_util: float = 0.85
    #: worst-replica step p99 that means "add one" (0 disables)
    out_step_p99_ms: float = 0.0
    #: worst-replica fast-window SLO burn that means "add one"
    out_burn: float = 2.0
    out_cooldown_s: float = 30.0
    in_cooldown_s: float = 60.0
    #: how long a held request waits for a cold re-onboard before erroring
    cold_timeout_s: float = 120.0
    #: HBM fraction above which the density reaper evicts the LRU model
    hbm_threshold: float = 0.92
    standby_hosts: list = field(default_factory=list)

    @classmethod
    def from_app(cls, app) -> "AutoscaleConfig":
        return cls(
            min_replicas=max(0, app.autoscale_min),
            max_replicas=max(1, app.autoscale_max),
            interval_s=max(0.05, app.autoscale_interval_s),
            in_idle_s=app.autoscale_in_idle_s,
            zero_idle_s=app.autoscale_zero_idle_s,
            standby_hosts=list(app.autoscale_standby_hosts or []),
            out_queue_depth=_env_float("LOCALAI_AUTOSCALE_OUT_QUEUE", 4.0),
            out_kv_util=_env_float("LOCALAI_AUTOSCALE_OUT_KV", 0.85),
            out_step_p99_ms=_env_float(
                "LOCALAI_AUTOSCALE_OUT_STEP_P99_MS", 0.0),
            out_burn=_env_float("LOCALAI_AUTOSCALE_OUT_BURN", 2.0),
            out_cooldown_s=_env_float(
                "LOCALAI_AUTOSCALE_OUT_COOLDOWN_S", 30.0),
            in_cooldown_s=_env_float(
                "LOCALAI_AUTOSCALE_IN_COOLDOWN_S", 60.0),
            cold_timeout_s=_env_float(
                "LOCALAI_AUTOSCALE_COLD_TIMEOUT_S", 120.0),
            hbm_threshold=_env_float(
                "LOCALAI_AUTOSCALE_HBM_THRESHOLD", 0.92),
        )


@dataclass
class ReplicaSignals:
    """One decode replica's slice of the policy input."""

    rid: str
    state: str = "healthy"
    inflight: int = 0
    idle_s: float = 0.0
    queue_depth: float = 0.0
    kv_util: float = 0.0
    step_p99_ms: float = 0.0
    burn_1m: float = 0.0
    burn_5m: float = 0.0


@dataclass
class Decision:
    action: str
    reason: str
    #: decode replica count the fleet should converge on
    target: int
    #: the replica to drain, for scale_in
    rid: Optional[str] = None


class AutoscalePolicy:
    """Holds the cooldown clocks; ``decide`` itself never mutates them —
    the controller calls ``note`` only after a decision actually applied,
    so a failed spawn doesn't burn the cooldown."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self.last_out_at = float("-inf")
        self.last_in_at = float("-inf")

    def note(self, action: str, now: float) -> None:
        if action == "scale_out":
            self.last_out_at = now
        elif action in ("scale_in", "scale_to_zero"):
            self.last_in_at = now

    # -- the decision table -------------------------------------------------

    def _overloaded(self, healthy: list) -> tuple[bool, str]:
        if not healthy:
            return False, ""
        cfg = self.cfg
        mean_q = sum(r.queue_depth for r in healthy) / len(healthy)
        if cfg.out_queue_depth > 0 and mean_q >= cfg.out_queue_depth:
            return True, "queue_depth"
        if cfg.out_burn > 0 \
                and max(r.burn_1m for r in healthy) >= cfg.out_burn:
            return True, "slo_burn"
        mean_kv = sum(r.kv_util for r in healthy) / len(healthy)
        if cfg.out_kv_util > 0 and mean_kv >= cfg.out_kv_util:
            return True, "kv_pressure"
        if cfg.out_step_p99_ms > 0 and max(
                r.step_p99_ms for r in healthy) >= cfg.out_step_p99_ms:
            return True, "step_p99"
        return False, ""

    def decide(self, replicas: list, now: float) -> Decision:
        """Map the decode fleet's signals to one action. Precedence:
        below-min floor (bypasses cooldown) > overload scale-out >
        overload holds capacity (burn overrides idle) > scale-to-zero >
        single idle scale-in > none."""
        cfg = self.cfg
        healthy = [r for r in replicas if r.state == "healthy"]
        booting = [r for r in replicas
                   if r.state in ("starting", "respawning")]
        n, pending = len(healthy), len(booting)
        total = n + pending

        if total < cfg.min_replicas:
            # self-heal below the floor regardless of load or cooldown
            return Decision("scale_out", "below_min", total + 1)

        overloaded, why = self._overloaded(healthy)
        if overloaded:
            if pending:
                return Decision("none", f"boot_pending:{why}", total)
            if total >= cfg.max_replicas:
                return Decision("none", f"at_max:{why}", total)
            if now - self.last_out_at < cfg.out_cooldown_s:
                return Decision("none", f"out_cooldown:{why}", total)
            return Decision("scale_out", why, total + 1)

        quiet = all(r.inflight == 0 and r.queue_depth == 0
                    for r in healthy)
        if (cfg.zero_idle_s > 0 and n > 0 and not pending and quiet
                and all(r.idle_s >= cfg.zero_idle_s for r in healthy)):
            if now - self.last_in_at < cfg.in_cooldown_s:
                return Decision("none", "in_cooldown", total)
            return Decision("scale_to_zero", "idle_to_zero", 0)

        # single-replica scale-in retires SURPLUS capacity only — the
        # last replica leaves through scale_to_zero or not at all
        if n > 0 and total > max(cfg.min_replicas, 1) \
                and cfg.in_idle_s > 0:
            idlest = max(healthy, key=lambda r: r.idle_s)
            if (idlest.inflight == 0 and idlest.queue_depth == 0
                    and idlest.idle_s >= cfg.in_idle_s):
                if now - self.last_in_at < cfg.in_cooldown_s:
                    return Decision("none", "in_cooldown", total)
                return Decision("scale_in", "idle", total - 1,
                                rid=idlest.rid)
        return Decision("none", "steady", total)
