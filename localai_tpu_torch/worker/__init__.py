"""Process-isolated model workers speaking one narrow contract.

Port of ``localai_tpu/worker``: one worker process a model, spawned,
health-checked and respawned by the serving instance, all speaking the
JAX package's ``backend.proto`` messages (``backend_pb2``, the same
bytes) over the port's own transport (``rpc``: gRPC's message framing on
one TCP connection a call, not HTTP/2). External workers register by
address.
"""

from localai_tpu_torch.worker.client import WorkerClient
from localai_tpu_torch.worker.process import Watchdog, WorkerPool, WorkerProcess
