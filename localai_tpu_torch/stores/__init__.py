"""Vector stores: cosine top-K over key matrices on the device.

Port of ``localai_tpu/stores``: the local-store backend's semantics
behind the ``/stores/*`` HTTP API (``api.stores``).
"""

from localai_tpu_torch.stores.store import StoreRegistry, VectorStore
