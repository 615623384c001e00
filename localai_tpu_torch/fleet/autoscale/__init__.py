"""Elastic capacity for fleets (port of ``localai_tpu/fleet/autoscale``):
a closed-loop capacity controller over the ReplicaPool and
FleetScheduler — telemetry-driven scale out and in, scale-to-zero with a
cold re-onboard, the hot weight swap, and multi-model density under
device memory pressure."""

from localai_tpu_torch.fleet.autoscale.controller import AutoscaleController
from localai_tpu_torch.fleet.autoscale.density import (
    evict_lru_model,
    hbm_fraction,
    hot_swap,
)
from localai_tpu_torch.fleet.autoscale.policy import (
    ACTIONS,
    AutoscaleConfig,
    AutoscalePolicy,
    Decision,
    ReplicaSignals,
)

__all__ = [
    "ACTIONS",
    "AutoscaleConfig",
    "AutoscaleController",
    "AutoscalePolicy",
    "Decision",
    "ReplicaSignals",
    "evict_lru_model",
    "hbm_fraction",
    "hot_swap",
]
