"""Fleets: one model served by N in-process engine replicas.

Port of ``localai_tpu/fleet`` over in-process replicas (``run
--fleet-backend inprocess --fleet-replicas N``; ROADMAP item 23 part 1):

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
  * :mod:`replica` — ``InProcessReplica``;
  * :mod:`kveconomy` — the prefix directory, the host KV tier under every
    paged engine (``LOCALAI_KV_TIER_MB``) and the migration ticket;
  * :mod:`autoscale` — the capacity controller, its pure policy, density
    and the hot swap.

Worker-process and remote replicas, federation and device pinning wait
for the port's own transport (ROADMAP item 23, part 2).
"""

from localai_tpu_torch.fleet.net import RpcDeadlineExceeded, bounded_stream
from localai_tpu_torch.fleet.pool import ReplicaPool
from localai_tpu_torch.fleet.prefix import (
    PrefixCache,
    assemble_chunks,
    pack_chunks,
)
from localai_tpu_torch.fleet.replica import InProcessReplica
from localai_tpu_torch.fleet.router import Router, affinity_key
from localai_tpu_torch.fleet.serving import FleetScheduler, FleetServingModel

__all__ = [
    "FleetScheduler",
    "FleetServingModel",
    "InProcessReplica",
    "PrefixCache",
    "ReplicaPool",
    "Router",
    "RpcDeadlineExceeded",
    "affinity_key",
    "assemble_chunks",
    "bounded_stream",
    "pack_chunks",
]
