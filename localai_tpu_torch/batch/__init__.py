"""Offline batch-inference subsystem (OpenAI Batch API shape).

Port of ``localai_tpu/batch``. ``store`` holds the durable halves — the
``/v1/files`` :class:`~localai_tpu_torch.batch.store.FileRegistry` and
the crash-safe :class:`~localai_tpu_torch.batch.store.BatchStore` job
records —, ``executor`` drains jobs through the engine scheduler's
background lane (``engine.scheduler.PRIORITY_BATCH``), and
``api.batches`` exposes the HTTP surface.
"""

from localai_tpu_torch.batch.executor import BatchExecutor
from localai_tpu_torch.batch.store import BatchStore, FileRegistry

__all__ = ["BatchExecutor", "BatchStore", "FileRegistry"]
