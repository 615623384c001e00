"""Fleets: one model served by N engine replicas behind one facade.

Port of ``localai_tpu/fleet``: worker-process replicas (``run
--fleet-replicas N``, the default backend), in-process ones
(``--fleet-backend inprocess``) and adopted remote workers
(``--fleet-hosts``, ``POST /federated/register``):

  * :mod:`pool` — ReplicaPool: N replicas booted together, health dials,
    respawn on death with a jittered backoff, runtime spawn and removal;
  * :mod:`router` — prompt-prefix affinity (token-chain block hash →
    consistent-hash ring), the prefix directory's record, least-loaded
    fallback and per-replica burn-rate route-around;
  * :mod:`serving` — FleetServingModel / FleetScheduler: the serving-model
    facade the API serves through, with failover, the disaggregated
    prefill → decode handoff, sibling prefix fetches and live migration;
  * :mod:`prefix` — the in-memory prefix cache and the chunked npz codec
    between replicas (the JAX package's bytes);
  * :mod:`net` — deadlines (``LOCALAI_FLEET_RPC_TIMEOUT_S``), bounded
    jittered retries and the stream pump with the ``fleet.transport``
    fault site;
  * :mod:`replica` — ``WorkerReplica``, ``RemoteReplica`` and
    ``InProcessReplica``;
  * :mod:`pinning` — per-replica ``CUDA_VISIBLE_DEVICES`` slices
    (``--fleet-device-pinning``);
  * :mod:`kveconomy` — the prefix directory, the host KV tier under every
    paged engine (``LOCALAI_KV_TIER_MB``) and the migration ticket;
  * :mod:`autoscale` — the capacity controller, its pure policy, density
    and the hot swap.
"""

from localai_tpu_torch.fleet.net import RpcDeadlineExceeded, bounded_stream
from localai_tpu_torch.fleet.pool import ReplicaPool
from localai_tpu_torch.fleet.prefix import (
    PrefixCache,
    assemble_chunks,
    pack_chunks,
)
from localai_tpu_torch.fleet.replica import (
    InProcessReplica,
    RemoteReplica,
    WorkerReplica,
)
from localai_tpu_torch.fleet.router import Router, affinity_key
from localai_tpu_torch.fleet.serving import FleetScheduler, FleetServingModel

__all__ = [
    "FleetScheduler",
    "FleetServingModel",
    "InProcessReplica",
    "PrefixCache",
    "RemoteReplica",
    "ReplicaPool",
    "Router",
    "RpcDeadlineExceeded",
    "WorkerReplica",
    "affinity_key",
    "assemble_chunks",
    "bounded_stream",
    "pack_chunks",
]
