"""Federation: one front door over many instances of the port's server.

Port of ``localai_tpu/federation/``: the router (``server``) and the
discovery dashboard over routers (``explorer``), on the standard
library's HTTP server and client.
"""

from localai_tpu_torch.federation.server import (
    FederatedNode,
    FederatedServer,
    announce,
)

__all__ = ["FederatedNode", "FederatedServer", "announce"]
