"""Fleet-wide KV economy: prefix directory, HBM→host tiering, migration.

Port of ``localai_tpu/fleet/kveconomy``. Three cooperating pieces that
turn N replicas' private KV caches into one fleet-wide pool:

  * :mod:`directory` — the serving instance's map of which replica holds
    which prefix blocks (keyed by the token-chain hashes the router's
    affinity uses); the router places requests on known-warm KV with it,
    and the fleet scheduler fetches a prefix from a sibling instead of
    re-prefilling;
  * :mod:`tiering` — a host-RAM spill tier under the paged
    ``BlockAllocator``'s prefix pool (``LOCALAI_KV_TIER_MB``, on any
    paged engine): evicted pool blocks park in host memory and
    re-onboard on a later chain match;
  * :mod:`migration` — the ticket protocol that moves an in-flight slot
    between replicas mid-generation, over the layout-independent
    ``snapshot_prefix``/``load_prefix`` round trip.
"""

from localai_tpu_torch.fleet.kveconomy.directory import PrefixDirectory
from localai_tpu_torch.fleet.kveconomy.migration import MigrationTicket
from localai_tpu_torch.fleet.kveconomy.tiering import HostTier, tier_from_env

__all__ = ["PrefixDirectory", "HostTier", "tier_from_env",
           "MigrationTicket"]
