"""In-memory KV-prefix cache and the chunked wire format between replicas.

Port of ``localai_tpu/fleet/prefix.py``. The disaggregated handoff reuses
the disk prompt cache's machinery end to end (``engine.promptcache``): a
prefill replica's scheduler stores the finished prompt prefix into a
:class:`PrefixCache` (the same ``store(tokens, pack_prefix(...))`` call
the disk cache gets), the fleet moves the packed arrays to the decode
replica, whose scheduler finds them through ``lookup()`` at admission and
resumes past them with ``load_prefix``, the path the disk cache already
holds to byte-equal greedy output. The cache is RAM-resident and fed by
the fleet instead of from npz files.

``pack_chunks``/``assemble_chunks`` are the wire codec: one npz blob
(numpy's container, the disk cache's format) split into bounded
fragments, so a long prompt's export streams instead of materializing one
giant message. Bytes packed by either package assemble in the other.
"""

from __future__ import annotations

import io
import os
import threading
import uuid
from collections import OrderedDict
from typing import Iterable, Iterator, Optional

import numpy as np

from localai_tpu_torch.engine.promptcache import CacheHit

# 1 MiB fragments: a multi-MB prefix ships in a handful of messages
CHUNK_BYTES = 1 << 20


def _default_max_bytes() -> int:
    """``LOCALAI_FLEET_PREFIX_CACHE_MB`` (default 1024). A packed prefix
    of a production-size model is hundreds of MB, so an entry-count bound
    alone would let the cache grow to many GB of host RAM."""
    try:
        mb = float(os.environ.get("LOCALAI_FLEET_PREFIX_CACHE_MB", "")
                   or 1024)
    except ValueError:
        mb = 1024.0
    return max(1, int(mb * (1 << 20)))


class PrefixUnavailable(RuntimeError):
    """Prefill ran, but no exportable prefix materialized (a prompt beyond
    the context, or the scheduler's export path disabled)."""


class PrefixCache:
    """A prompt-cache-shaped, RAM-resident, signalling store.

    Presents the surface ``engine.scheduler.Scheduler`` expects of a
    prompt cache (``lookup``/``store``/``stats``/``read_only``/
    ``min_prefix``) plus ``wait_for()``: the prefill export stores
    asynchronously (the scheduler's prompt-cache writer thread), so the
    exporting side blocks on the store event rather than polling."""

    def __init__(self, *, max_entries: int = 16, min_prefix: int = 16,
                 max_bytes: Optional[int] = None, fallthrough=None):
        self.read_only = False
        self.min_prefix = min_prefix
        self.max_entries = max_entries
        self.max_bytes = max_bytes if max_bytes is not None \
            else _default_max_bytes()
        # optional second tier (a configured disk PromptKVCache): stores
        # forward to it, RAM-missed lookups fall through to it
        self.fallthrough = fallthrough
        self._lock = threading.Lock()
        # key → (tokens, arrays, nbytes); LRU order, evicted from the front
        self._entries: "OrderedDict[tuple, tuple[list[int], dict, int]]" = \
            OrderedDict()
        self._total_bytes = 0
        self._stored = threading.Condition(self._lock)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.hit_tokens = 0

    @staticmethod
    def _key(tokens: list[int]) -> tuple:
        return tuple(int(t) for t in tokens)

    def store(self, tokens: list[int], arrays: dict) -> None:
        n = int(arrays["k"].shape[2])
        if n < self.min_prefix:
            return
        key = self._key(tokens)
        nbytes = sum(int(np.asarray(a).nbytes) for a in arrays.values())
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._total_bytes -= old[2]
            self._entries[key] = (list(map(int, tokens)), arrays, nbytes)
            self._total_bytes += nbytes
            # evict LRU past either budget, but always keep the entry just
            # stored, even if it alone exceeds max_bytes (the exporter is
            # blocked on it in wait_for)
            while len(self._entries) > 1 and (
                    len(self._entries) > self.max_entries
                    or self._total_bytes > self.max_bytes):
                _, (_, _, freed) = self._entries.popitem(last=False)
                self._total_bytes -= freed
            self.stores += 1
            self._stored.notify_all()
        ft = self.fallthrough
        if ft is not None and not ft.read_only:
            # disk IO stays outside our lock
            ft.store(tokens, arrays)

    def wait_for(self, tokens: list[int],
                 timeout: float = 30.0) -> Optional[dict]:
        """Block until ``tokens`` lands (the prefill replica's scheduler
        stores off-thread); returns its packed arrays, or None on
        timeout."""
        key = self._key(tokens)
        with self._lock:
            if self._stored.wait_for(lambda: key in self._entries, timeout):
                return self._entries[key][1]
            return None

    def lookup(self, prompt: list[int]) -> Optional[CacheHit]:
        """The entry with the longest common prefix ≥ min_prefix, or None:
        the disk cache's contract (and its last-token clip). Runs under
        the lock (≤ max_entries short scans), so a concurrent store()
        cannot evict the winner mid-selection."""
        with self._lock:
            best_key: Optional[tuple] = None
            best: Optional[tuple[list[int], dict, int]] = None
            best_lcp = 0
            for key, entry in self._entries.items():
                lcp = 0
                for a, b in zip(entry[0], prompt):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best_lcp:
                    best_key, best, best_lcp = key, entry, lcp
            best_lcp = min(best_lcp, len(prompt) - 1)
            if best is not None and best_lcp >= self.min_prefix:
                self._entries.move_to_end(best_key, last=True)
                tokens, arrays, _ = best
                n = int(arrays["k"].shape[2])
                self.hits += 1
                self.hit_tokens += n
                return CacheHit(tokens=list(tokens), arrays=arrays, n=n)
            self.misses += 1
        # the disk tier's IO runs outside our lock
        if self.fallthrough is not None:
            return self.fallthrough.lookup(prompt)
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._total_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "hit_tokens": self.hit_tokens,
            }


# -- the two halves of the handoff (InProcessReplica wraps these, as the
# JAX package's gRPC servicer and in-process replica both do) -------------


def export_prefix(sm, gr, cache: PrefixCache,
                  *, prefill_timeout: float = 600.0,
                  export_timeout: float = 60.0) -> tuple[list[int], dict]:
    """Prefill-replica half: run ``gr``'s prefill (one sampled token, then
    the slot retires through the normal release, which snapshots the
    prompt prefix into ``cache``), wait for the off-thread export, return
    ``(prompt, packed arrays)``.

    Raises ValueError on a prompt below the export minimum,
    PrefixUnavailable when prefill finished but nothing exported, and
    RuntimeError when the prefill itself failed."""
    if len(gr.prompt) <= cache.min_prefix:
        raise ValueError(
            f"prompt of {len(gr.prompt)} tokens is below the "
            f"{cache.min_prefix}-token export minimum")
    gr.max_new_tokens = 1
    gr.stream = False
    prompt = list(gr.prompt)
    handle = sm.scheduler.submit(gr)
    try:
        handle.result(timeout=prefill_timeout)
    finally:
        if handle.finish_reason is None:
            handle.cancel()
    if handle.finish_reason not in ("stop", "length"):
        raise RuntimeError(f"prefill finished {handle.finish_reason!r}")
    arrays = cache.wait_for(prompt, timeout=export_timeout)
    if arrays is None:
        raise PrefixUnavailable(
            "prefill finished but no prefix was exported (prompt beyond "
            "context, or the export path is disabled)")
    return prompt, arrays


def import_prefix(cache: PrefixCache, chunks: Iterable) -> int:
    """Decode-replica half: assemble the streamed chunks, enforce the
    import minimum, seed ``cache``. Returns the KV-row count. Raises
    ValueError on a malformed stream or an undersized prefix."""
    tokens, arrays = assemble_chunks(chunks)
    n = int(arrays["k"].shape[2])
    if n < cache.min_prefix:
        raise ValueError(
            f"{n} transferred rows is below the {cache.min_prefix}-"
            "token import minimum")
    cache.store(tokens, arrays)
    return n


# -- wire codec --------------------------------------------------------------


def pack_chunks(tokens: list[int], arrays: dict,
                *, chunk_bytes: int = CHUNK_BYTES,
                transfer_id: str = "") -> Iterator[dict]:
    """(tokens, packed arrays) → bounded chunk dicts with the JAX
    package's ``PrefixChunk`` fields.

    ``arrays`` must already be host numpy (``ModelRunner.pack_prefix``
    output); the payload is one npz blob split at ``chunk_bytes``."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blob = buf.getvalue()
    tid = transfer_id or uuid.uuid4().hex
    n_tokens = int(arrays["k"].shape[2])
    total = max(1, -(-len(blob) // chunk_bytes))
    for i in range(total):
        frag = blob[i * chunk_bytes:(i + 1) * chunk_bytes]
        yield {
            "transfer_id": tid,
            "seq": i,
            "data": frag,
            "last": i == total - 1,
            # identity rides the first fragment only (the rest is payload)
            "tokens": list(map(int, tokens)) if i == 0 else [],
            "n_tokens": n_tokens if i == 0 else 0,
        }


def assemble_chunks(chunks: Iterable) -> tuple[list[int], dict]:
    """A chunk stream (dicts, or objects with the same attributes) →
    (tokens, arrays).

    Raises ValueError on an empty, unordered or truncated stream."""
    tokens: list[int] = []
    frags: list[bytes] = []
    done = False
    for c in chunks:
        get = (lambda k, _c=c: _c[k]) if isinstance(c, dict) \
            else (lambda k, _c=c: getattr(_c, k))
        if int(get("seq")) != len(frags):
            raise ValueError(
                f"out-of-order prefix chunk: seq {get('seq')} "
                f"(expected {len(frags)})")
        if not frags:
            tokens = list(get("tokens"))
        frags.append(bytes(get("data")))
        if get("last"):
            done = True
            break
    if not frags or not done:
        raise ValueError("truncated prefix transfer (no final chunk)")
    if not tokens:
        raise ValueError("prefix transfer carries no token identity")
    try:
        with np.load(io.BytesIO(b"".join(frags))) as z:
            arrays = {name: z[name] for name in z.files}
    except Exception as e:  # zipfile.BadZipFile, OSError, ...: the same
        # thing to the caller — the payload is not a prefix export
        raise ValueError(f"corrupt prefix transfer payload: {e}") from e
    if "k" not in arrays:
        raise ValueError("prefix transfer payload misses KV rows")
    return tokens, arrays
