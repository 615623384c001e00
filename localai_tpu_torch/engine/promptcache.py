"""Disk-persistent prompt KV cache.

Port of ``localai_tpu/engine/promptcache.py`` (``prompt_cache_path`` /
``prompt_cache_all`` / ``prompt_cache_ro``), in its directory format, so
a directory written by either package is read by the other: an
``index.json`` mapping each key to its token sequence, and one
``<key>.npz`` per entry, the key being the first 32 hex digits of the
sha256 of the tokens as int64. An entry holds ``kv_dtype``, ``kv_rope``
("roped", or "raw" for a self-extend runner's unroped K), the rows
``k``/``v`` [L, H, n, hd] (bfloat16 as uint16 bits beside a
``<name>_bf16`` marker; int4 nibble-packed) and, for scaled caches,
``k_scale``/``v_scale`` [L, H, n] (``ModelRunner.pack_prefix``).

On admit, the scheduler looks up the entry with the longest common
prefix with the incoming prompt and loads its rows into the slot
(``ModelRunner.load_prefix``); the suffix prefill then computes only the
tail. Writes go through tmp + rename so a crash never leaves a torn
entry; the directory is LRU-capped by mtime.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CacheHit:
    tokens: list[int]       # the stored sequence (resident-record shaped)
    arrays: dict            # k/v (+ scales) rows for tokens[:n]
    n: int                  # cached KV rows
    # no lcp field: the scheduler re-scores the hit through
    # ModelRunner.reusable_prefix(valid_n=n) so one definition (with all
    # feasibility gates) decides both ranking and admit behavior


class PromptKVCache:
    """One directory of (index.json, <key>.npz) entries."""

    def __init__(self, path: str | os.PathLike, *, read_only: bool = False,
                 max_entries: int = 32, min_prefix: int = 16):
        self.dir = Path(path)
        self.read_only = read_only
        self.max_entries = max_entries
        self.min_prefix = min_prefix
        if not self.dir.exists() and not read_only:
            self.dir.mkdir(parents=True, exist_ok=True)
        # lookup() runs on the scheduler engine thread while store()/_evict()
        # run on the prompt-cache writer thread — every _index access (and
        # the index-file write) goes through this lock
        self._lock = threading.Lock()
        self._index: dict[str, list[int]] = {}
        self._load_index()
        # telemetry (scraped through Scheduler.metrics → /metrics)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.hit_tokens = 0  # KV rows handed back by successful lookups

    # -- index ------------------------------------------------------------

    def _index_path(self) -> Path:
        return self.dir / "index.json"

    # __init__-only: runs before the cache object is shared across threads
    def _load_index(self) -> None:
        try:
            raw = json.loads(self._index_path().read_text())
            self._index = {k: list(map(int, v)) for k, v in raw.items()}
        except (OSError, ValueError):
            self._index = {}

    def _write_index(self) -> None:  # the caller holds _lock
        tmp = self._index_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(self._index))
        tmp.replace(self._index_path())

    @staticmethod
    def _key(tokens: list[int]) -> str:
        return hashlib.sha256(
            np.asarray(tokens, np.int64).tobytes()
        ).hexdigest()[:32]

    # -- public -----------------------------------------------------------

    def lookup(self, prompt: list[int]) -> Optional[CacheHit]:
        """Entry with the longest common prefix ≥ min_prefix, or None."""
        best_key, best_tokens, best_lcp = None, None, 0
        with self._lock:
            items = list(self._index.items())
        for key, tokens in items:
            lcp = 0
            for a, b in zip(tokens, prompt):
                if a != b:
                    break
                lcp += 1
            if lcp > best_lcp:
                best_key, best_tokens, best_lcp = key, tokens, lcp
        # the last prompt token is always recomputed (its logits seed
        # sampling), so a full-prompt hit still leaves a 1-token tail
        best_lcp = min(best_lcp, len(prompt) - 1)
        if best_key is None or best_lcp < self.min_prefix:
            self.misses += 1
            return None
        path = self.dir / f"{best_key}.npz"
        try:
            with np.load(path) as z:
                arrays = {name: z[name] for name in z.files}
        except (OSError, ValueError) as e:
            log.warning("prompt cache entry %s unreadable: %s", best_key, e)
            with self._lock:
                self._index.pop(best_key, None)
            self.misses += 1
            return None
        n = int(arrays["k"].shape[2])
        try:  # LRU touch
            os.utime(path)
        except OSError:
            pass
        self.hits += 1
        self.hit_tokens += n
        return CacheHit(tokens=list(best_tokens), arrays=arrays, n=n)

    def store(self, tokens: list[int], arrays: dict) -> None:
        """Persist KV rows for ``tokens[:n]`` (n = arrays['k'].shape[2])."""
        if self.read_only:
            return
        n = int(arrays["k"].shape[2])
        if n < self.min_prefix:
            return
        key = self._key(tokens)
        with self._lock:
            if key in self._index:
                return
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"{key}.npz"
        tmp = self.dir / f".{key}.tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        tmp.replace(path)
        with self._lock:
            self._index[key] = list(map(int, tokens))
            self._write_index()
        self.stores += 1
        self._evict()

    def _evict(self) -> None:
        with self._lock:
            if len(self._index) <= self.max_entries:
                return
            entries = []
            for key in list(self._index):
                p = self.dir / f"{key}.npz"
                try:
                    entries.append((p.stat().st_mtime, key))
                except OSError:
                    self._index.pop(key, None)
            entries.sort()
            for _, key in entries[: len(self._index) - self.max_entries]:
                (self.dir / f"{key}.npz").unlink(missing_ok=True)
                self._index.pop(key, None)
            self._write_index()

    def stats(self) -> dict:
        with self._lock:
            n_entries = len(self._index)
        return {
            "entries": n_entries,
            "hits": self.hits,
            "misses": self.misses,
            "stores": self.stores,
            "hit_tokens": self.hit_tokens,
        }
