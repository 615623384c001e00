"""In-memory vector store with top-K cosine similarity search.

Port of ``localai_tpu/stores/store.py``, line for line in its semantics:
keys live as one matrix on the device (the card unless the caller asks
for the CPU) and Find is one float32 product and a top-K there.

  * Set upserts by exact key bytes (float32); Get/Delete address by exact
    key. A value-only upsert leaves the matrix clean.
  * Deleted rows go to a free list that the next insert reuses from its
    end.
  * Find returns (keys, values, cosine similarities) of the top-K: stored
    keys are divided by their norms and the query by its own, so the
    product is the cosine.
  * The matrix is padded to the next power of two (rows past the live
    ones masked to -inf and filtered out), and the device-side K is
    rounded up to a power of two capped at the capacity.

The top-K ranks equal scores lower row first, as ``jax.lax.top_k`` does:
a stable descending sort of the scores on the device. The product runs
under ``utils.device.full_f32``, so a TF32 setting made for another model
cannot change the order.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from localai_tpu_torch.utils.device import full_f32, resolve_device


def topk_cosine(matrix: torch.Tensor, norms: torch.Tensor,
                query: torch.Tensor, valid: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """matrix [N, D] (unnormalized), norms [N], query [D], valid [N] bool
    → (scores [k], rows [k]) in descending score order, equal scores
    lower row first."""
    with full_f32():
        qn = query / torch.clamp(torch.linalg.vector_norm(query),
                                 min=1e-12)
        sims = (matrix @ qn) / torch.clamp(norms, min=1e-12)
    sims = torch.where(valid, sims, torch.full_like(sims, -torch.inf))
    scores, rows = torch.sort(sims, descending=True, stable=True)
    return scores[:k], rows[:k]


class VectorStore:
    """Thread-safe store: host dict for exact addressing, device matrix
    for similarity search."""

    def __init__(self, dim: Optional[int] = None,
                 device: str | torch.device | None = "cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._index: dict[bytes, int] = {}   # key bytes → row
        self._keys: list[np.ndarray] = []    # row → key vector
        self._values: list[bytes] = []       # row → payload
        self._free: list[int] = []
        self._matrix: Optional[torch.Tensor] = None   # [cap, D]
        self._norms: Optional[torch.Tensor] = None    # [cap]
        self._valid: Optional[torch.Tensor] = None    # [cap] bool
        self._cap = 0
        self._dirty = True
        self.last_rebuild_s = 0.0   # wall of the last matrix rebuild

    # -- internal ----------------------------------------------------------

    @staticmethod
    def _key_bytes(vec: np.ndarray) -> bytes:
        return np.ascontiguousarray(vec, dtype=np.float32).tobytes()

    def _check_dim(self, vec: np.ndarray) -> np.ndarray:
        v = np.asarray(vec, np.float32).reshape(-1)
        if self.dim is None:
            self.dim = v.shape[0]
        elif v.shape[0] != self.dim:
            raise ValueError(
                f"key dim {v.shape[0]} != store dim {self.dim}"
            )
        return v

    def _sync_device(self) -> None:
        """Rebuild the device matrix if rows changed (power-of-two cap)."""
        if not self._dirty:
            return
        t0 = time.monotonic()
        n = len(self._keys)
        cap = 1
        while cap < max(n, 1):
            cap *= 2
        host = np.zeros((cap, self.dim or 1), np.float32)
        valid = np.zeros(cap, bool)
        for i, kv in enumerate(self._keys):
            if kv is not None:
                host[i] = kv
                valid[i] = True
        self._matrix = None   # the old matrix frees before the new lands
        self._matrix = torch.from_numpy(host).to(self.device)
        with full_f32():
            self._norms = torch.linalg.vector_norm(self._matrix, dim=1)
        self._valid = torch.from_numpy(valid).to(self.device)
        self._cap = cap
        self._dirty = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_rebuild_s = time.monotonic() - t0

    def device_bytes(self) -> int:
        """Bytes the matrix, its norms and its mask hold on the device."""
        with self._lock:
            return sum(t.numel() * t.element_size() for t in (
                self._matrix, self._norms, self._valid) if t is not None)

    # -- API ---------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def set(self, keys: Sequence[Sequence[float]],
            values: Sequence[bytes]) -> None:
        if len(keys) != len(values):
            raise ValueError("keys and values must be the same length")
        with self._lock:
            for vec, val in zip(keys, values):
                v = self._check_dim(np.asarray(vec))
                kb = self._key_bytes(v)
                row = self._index.get(kb)
                if row is None:
                    if self._free:
                        row = self._free.pop()
                        self._keys[row] = v
                        self._values[row] = val
                    else:
                        row = len(self._keys)
                        self._keys.append(v)
                        self._values.append(val)
                    self._index[kb] = row
                    self._dirty = True  # value-only upserts don't touch keys
                else:
                    self._values[row] = val

    def _row_of(self, vec: np.ndarray) -> Optional[int]:
        """Exact-key lookup that never latches/asserts dimensions — reads
        against an empty or differently-sized store just miss."""
        v = np.asarray(vec, np.float32).reshape(-1)
        if self.dim is None or v.shape[0] != self.dim:
            return None
        return self._index.get(self._key_bytes(v))

    def get(self, keys: Sequence[Sequence[float]]
            ) -> tuple[list[list[float]], list[Optional[bytes]]]:
        out_k, out_v = [], []
        with self._lock:
            for vec in keys:
                v = np.asarray(vec, np.float32).reshape(-1)
                row = self._row_of(v)
                out_k.append([float(x) for x in v])
                out_v.append(self._values[row] if row is not None else None)
        return out_k, out_v

    def delete(self, keys: Sequence[Sequence[float]]) -> int:
        removed = 0
        with self._lock:
            for vec in keys:
                v = np.asarray(vec, np.float32).reshape(-1)
                row = self._row_of(v)
                if row is not None:
                    self._index.pop(self._key_bytes(v), None)
                if row is None:
                    continue
                self._keys[row] = None  # type: ignore[call-overload]
                self._values[row] = b""
                self._free.append(row)
                removed += 1
                self._dirty = True
        return removed

    def find(self, key: Sequence[float], top_k: int
             ) -> tuple[list[list[float]], list[bytes], list[float]]:
        with self._lock:
            if not self._index:
                return [], [], []
            q = self._check_dim(np.asarray(key))
            self._sync_device()
            k = min(max(top_k, 1), len(self._index))
            # the device-side k rounded to a power of two capped at cap,
            # as the JAX package rounds it; the host filter below trims
            # to the exact k
            k_dev = 1
            while k_dev < k:
                k_dev *= 2
            k_dev = min(k_dev, self._cap)
            scores, idx = topk_cosine(
                self._matrix, self._norms,
                torch.from_numpy(q).to(self.device), self._valid, k_dev)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            keys_out, vals_out, sims_out = [], [], []
            for s, i in zip(scores, idx):
                if not np.isfinite(s) or len(keys_out) >= k:
                    continue
                keys_out.append([float(x) for x in self._keys[int(i)]])
                vals_out.append(self._values[int(i)])
                sims_out.append(float(s))
            return keys_out, vals_out, sims_out


class StoreRegistry:
    """Named stores (the API server can host several), each on
    ``device`` (resolved when the first store is made)."""

    def __init__(self, device: str | torch.device | None = "cuda") -> None:
        self.device = device
        self._stores: dict[str, VectorStore] = {}
        self._lock = threading.Lock()

    def get(self, name: str = "default") -> VectorStore:
        with self._lock:
            st = self._stores.get(name)
            if st is None:
                st = self._stores[name] = VectorStore(device=self.device)
            return st

    def drop(self, name: str) -> bool:
        with self._lock:
            return self._stores.pop(name, None) is not None
