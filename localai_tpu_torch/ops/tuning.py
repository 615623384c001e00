"""Per-shape kernel tuning table for the paged decode hot path.

Port of ``localai_tpu/ops/tuning.py``. The paged attention dispatch has
tuning freedom whose best point depends on the shape tuple ``(head_dim,
kv_heads, kv_dtype, tensor_parallel)`` and on the card, not on anything
decidable statically. ``localai_tpu_torch.tools.autotune`` sweeps K1 over
its pool block sizes on real timings and persists the winners here;
``engine.runner.ModelRunner`` consults the table once per paged runner
construction, so a tuned box serves the measured-fastest block size
without config changes.

The table is a flat JSON file at ``LOCALAI_TUNE_CACHE`` (default
``~/.cache/localai_tpu/tuning.json``; ``"0"`` disables it), in the JAX
package's format, so each package reads the other's file:

    {"hd128_kv8_int8_tp1": {"impl": "pallas", "block_tokens": 64,
                            "num_buffers": 3, "us": 412.0}, ...}

On the card ``impl`` names K1 ("pallas") or its plain version ("xla");
the runner keeps K1 either way (one attention path per device).
``num_buffers`` is the TPU kernel's DMA depth: it is read, validated and
saved back, and moves nothing (K1's ``cp.async`` ring has two stages).

Failure policy: a missing, corrupt, or partially-written file degrades to
the built-in defaults (one warning, never an error — tuning is an
optimization, not a dependency). Every lookup emits a
``localai_autotune_lookups_total{result=hit|miss}`` receipt.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)

ENV_CACHE = "LOCALAI_TUNE_CACHE"
_DEFAULT_PATH = "~/.cache/localai_tpu/tuning.json"

_IMPLS = ("", "pallas", "xla")


def cache_path() -> str:
    """Resolved tuning-table path (``LOCALAI_TUNE_CACHE``; "0" disables)."""
    p = os.environ.get(ENV_CACHE, "")
    if p == "0":
        return ""
    return os.path.expanduser(p or _DEFAULT_PATH)


def shape_key(head_dim: int, kv_heads: int, kv_dtype: str, tp: int) -> str:
    """The tuning key: per-(head_dim, kv-head count, KV dtype, tensor-
    parallel width). ``kv_dtype`` is the dtype's name as the JAX package
    writes it ("bfloat16", "float32", "int8", "int4"). Slot count and
    context length are excluded: they scale the grid, not the per-block
    schedule."""
    return f"hd{int(head_dim)}_kv{int(kv_heads)}_{kv_dtype}_tp{int(tp)}"


@dataclasses.dataclass
class TuneEntry:
    """One tuned configuration. Zero-valued fields mean "no preference —
    keep the engine default"."""

    impl: str = ""          # "pallas" | "xla" | "" (auto)
    block_tokens: int = 0   # pool block size; 0 = LOCALAI_KV_BLOCK_TOKENS
    num_buffers: int = 0    # the TPU kernel's DMA depth; 0 = 2
    us: float = 0.0         # best measured microseconds per dispatch

    @staticmethod
    def from_dict(d: object) -> Optional["TuneEntry"]:
        """Validated parse; None on any malformed field (one bad entry
        must not poison the rest of the table)."""
        if not isinstance(d, dict):
            return None
        try:
            e = TuneEntry(
                impl=str(d.get("impl", "")),
                block_tokens=int(d.get("block_tokens", 0)),
                num_buffers=int(d.get("num_buffers", 0)),
                us=float(d.get("us", 0.0)),
            )
        except (TypeError, ValueError):
            return None
        if e.impl not in _IMPLS:
            return None
        if e.block_tokens < 0 or e.num_buffers < 0:
            return None
        return e

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v not in ("", 0, 0.0)}


class TuningTable:
    """In-memory view of one tuning-cache file."""

    def __init__(self, entries: Optional[dict[str, TuneEntry]] = None,
                 path: str = ""):
        self.entries: dict[str, TuneEntry] = dict(entries or {})
        self.path = path

    @staticmethod
    def load(path: str) -> "TuningTable":
        """Parse ``path``; corrupt or unreadable files degrade to an empty
        table with one warning (defaults keep serving)."""
        table = TuningTable(path=path)
        if not path or not os.path.exists(path):
            return table
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(raw).__name__}")
        except (OSError, ValueError) as e:
            log.warning("tuning cache %s unreadable (%s); using defaults",
                        path, e)
            return table
        for key, val in raw.items():
            entry = TuneEntry.from_dict(val)
            if entry is None:
                log.warning("tuning cache %s: dropping malformed entry %r",
                            path, key)
                continue
            table.entries[str(key)] = entry
        return table

    def lookup(self, key: str) -> Optional[TuneEntry]:
        return self.entries.get(key)

    def put(self, key: str, entry: TuneEntry) -> None:
        self.entries[key] = entry

    def save(self, path: Optional[str] = None) -> str:
        """Atomic JSON write (the JAX package's bytes); returns the path
        written."""
        path = path or self.path or cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({k: e.to_dict() for k, e in self.entries.items()},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


# process-wide table, lazily loaded per LOCALAI_TUNE_CACHE value (tests
# flip the env between runners; serving reads it once per path)
_lock = threading.Lock()
_loaded: Optional[TuningTable] = None
_loaded_path: Optional[str] = None


def table() -> TuningTable:
    global _loaded, _loaded_path
    path = cache_path()
    with _lock:
        if _loaded is None or _loaded_path != path:
            _loaded = TuningTable.load(path)
            _loaded_path = path
            _set_entries_gauge(len(_loaded.entries))
        return _loaded


def reset() -> None:
    """Drop the cached table (tests; a rewritten cache file re-loads on
    the next lookup)."""
    global _loaded, _loaded_path
    with _lock:
        _loaded = None
        _loaded_path = None


def lookup(head_dim: int, kv_heads: int, kv_dtype: str,
           tp: int = 1) -> Optional[TuneEntry]:
    """Tuned entry for one shape, with a hit/miss metric receipt."""
    entry = table().lookup(shape_key(head_dim, kv_heads, kv_dtype, tp))
    _note_lookup("hit" if entry is not None else "miss")
    return entry


def _note_lookup(result: str) -> None:
    try:
        from localai_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.autotune_lookups.inc(result=result)
    except Exception:  # noqa: BLE001 — metrics must never break tuning
        pass


def _set_entries_gauge(n: int) -> None:
    try:
        from localai_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.autotune_entries.set(n)
    except Exception:  # noqa: BLE001
        pass
