"""Device health: timeout-guarded liveness probe + device-memory accounting.

Port of ``localai_tpu/obs/device.py``. Three questions, three tools:

  * **Is the device answering at all?** :func:`probe_device` runs a tiny
    add on the device from a SIDE thread, then ``torch.cuda.synchronize()``,
    and joins it with a timeout: a wedged card makes the synchronize block
    forever, and a blocked probe must never take the caller (an HTTP
    handler) down with it. One probe thread at a time (later callers join
    it), so a dashboard polling a dead card parks one thread, not many.
  * **How full is it?** :func:`device_memory` reads each card's
    ``torch.cuda.memory_stats()`` (bytes in use, peak) and its capacity
    into gauges. Host metadata, no kernel: safe at
    /metrics scrape time. The CPU reports ``memory: null``, as the JAX
    package's CPU devices do.
  * **Who is holding it?** :func:`hbm_census` attributes the caching
    allocator's ``torch.cuda.memory_allocated()`` to the loaded runners'
    KV pool tensors and parameters (identity sets of their storages, the
    JAX package walks ``jax.live_arrays()``); the rest is "other". On the
    CPU the known sets are summed alone.

:func:`roofline` is the peak table the program cost catalog
(:mod:`obs.compile`) divides by: the port's own table keyed on
``torch.cuda.get_device_name()`` (the H100 SXM's published 3350 GB/s and
989 dense bf16 TFLOP/s), ``LOCALAI_PEAK_GBPS`` / ``LOCALAI_PEAK_TFLOPS``
over it, and an explicitly marked ``assumed`` fallback for other devices.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Iterable, Optional

import torch

from localai_tpu_torch.obs.metrics import REGISTRY, Registry

# device name substring (lowercased) → (peak memory GB/s, peak dense bf16
# TFLOP/s), published spec-sheet numbers; the catalog reports fractions,
# so ±10% on a peak moves the fraction, not the measured numerator
_ROOFLINES = (
    ("h100 80gb hbm3", (3350.0, 989.0)),   # H100 SXM
)
# unknown device (the CPU test host): the JAX package's deliberately
# modest guess, reported with source "assumed" so nobody mistakes the
# fraction for a measurement
_ASSUMED = (25.0, 0.5)


def _device_kind(device: Optional[Any] = None) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a card, else
    "cpu"."""
    try:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu"))
        if dev.type == "cuda":
            return torch.cuda.get_device_name(dev)
    except Exception:  # noqa: BLE001 — no backend is still an answer
        pass
    return "cpu"


def roofline(device: Optional[Any] = None) -> dict:
    """Peak bandwidth/compute for ``device`` (default: the first card, else
    the CPU). ``{"peak_gbps", "peak_tflops", "source": "env"|"table"|
    "assumed", "device_kind"}``."""
    env_bw = os.environ.get("LOCALAI_PEAK_GBPS")
    env_fl = os.environ.get("LOCALAI_PEAK_TFLOPS")
    if env_bw or env_fl:
        try:
            return {
                "peak_gbps": float(env_bw or _ASSUMED[0]),
                "peak_tflops": float(env_fl or _ASSUMED[1]),
                "source": "env",
            }
        except ValueError:
            pass
    kind = _device_kind(device).lower()
    for sub, (bw, fl) in _ROOFLINES:
        if sub in kind:
            return {"peak_gbps": bw, "peak_tflops": fl, "source": "table",
                    "device_kind": kind}
    return {"peak_gbps": _ASSUMED[0], "peak_tflops": _ASSUMED[1],
            "source": "assumed", "device_kind": kind}


# -- liveness probe ---------------------------------------------------------

@dataclasses.dataclass
class ProbeResult:
    ok: bool
    seconds: float
    error: str = ""
    device: str = ""

    def to_dict(self) -> dict:
        return {"ok": self.ok, "seconds": round(self.seconds, 4),
                "error": self.error, "device": self.device}


_probe_lock = threading.Lock()
# single-flight latch for the default probe: against a wedged card every
# probe thread blocks forever; while one is in flight, later callers join
# it instead of spawning another
_probe_inflight: dict = {"thread": None, "box": None}


def _default_probe() -> None:
    """Tiny device round-trip: one [8] add, then wait for the card."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out = torch.arange(8, dtype=torch.int32, device=dev) + 1
    if out.is_cuda:
        torch.cuda.synchronize()


def probe_device(timeout: float = 5.0, *,
                 registry: Optional[Registry] = None,
                 fn: Optional[Any] = None) -> ProbeResult:
    """Run a liveness round-trip in a side thread; join with ``timeout``.

    A hung card leaves the probe thread blocked (daemon — it dies with the
    process) and returns ok=False error="timeout" in ``timeout`` seconds
    instead of hanging the caller. ``fn`` is a test hook (inject a
    blocking callable to exercise the timeout path)."""
    reg = registry or REGISTRY
    probe = fn or _default_probe

    def make_thread(box: dict) -> threading.Thread:
        def run() -> None:
            t0 = time.monotonic()
            try:
                probe()
                box["seconds"] = time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — a sick device is a
                # result, not a crash
                box["error"] = f"{type(e).__name__}: {e}"
                box["seconds"] = time.monotonic() - t0

        return threading.Thread(target=run, name="device-probe",
                                daemon=True)

    started = False
    if fn is None:
        with _probe_lock:
            t = _probe_inflight["thread"]
            if t is not None and t.is_alive():
                box = _probe_inflight["box"]  # join the in-flight probe
            else:
                box = {}
                t = make_thread(box)
                _probe_inflight.update(thread=t, box=box)
                started = True
    else:  # test-injected probes stay independent of the latch
        box = {}
        t = make_thread(box)
        started = True
    t0 = time.monotonic()
    if started:
        t.start()
    t.join(timeout)
    kind = _device_kind()
    if t.is_alive():
        res = ProbeResult(False, time.monotonic() - t0,
                          f"timeout after {timeout}s", kind)
    elif "error" in box:
        res = ProbeResult(False, box.get("seconds", 0.0), box["error"], kind)
    else:
        res = ProbeResult(True, box.get("seconds", 0.0), "", kind)
    reg.device_ok.set(1 if res.ok else 0)
    reg.device_probe_seconds.set(round(res.seconds, 4))
    return res


# -- memory stats + census --------------------------------------------------

def device_memory(registry: Optional[Registry] = None) -> list[dict]:
    """Per-card memory snapshot (gauges refreshed as a side effect): the
    caching allocator's bytes in use and peak, and the card's capacity.
    Without a card, one CPU entry with ``memory: null``."""
    reg = registry or REGISTRY
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": "cpu", "memory": None}]
    out: list[dict] = []
    for i in range(torch.cuda.device_count()):
        entry: dict = {"id": i, "platform": "gpu",
                       "kind": torch.cuda.get_device_name(i), "memory": None}
        try:
            stats = torch.cuda.memory_stats(i)
            # the card's capacity from its (cached) properties: no runtime
            # call at scrape time
            total = torch.cuda.get_device_properties(i).total_memory
            mem = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
            }
        except Exception:  # noqa: BLE001 — optional per backend
            mem = None
        if mem:
            entry["memory"] = mem
            dev = str(i)
            reg.hbm_bytes_in_use.set(mem["bytes_in_use"], device=dev)
            reg.hbm_peak_bytes.set(mem["peak_bytes_in_use"], device=dev)
            reg.hbm_bytes_limit.set(mem["bytes_limit"], device=dev)
        out.append(entry)
    return out


def _storages(tensors: Iterable[Any]) -> dict[tuple, int]:
    """Distinct storages of ``tensors``: (device, data pointer) → bytes (a
    tied weight or a view is counted once)."""
    out: dict[tuple, int] = {}
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        out[(str(t.device), st.data_ptr())] = st.nbytes()
    return out


def hbm_census(known: Optional[dict[str, Iterable[Any]]] = None,
               registry: Optional[Registry] = None) -> dict:
    """Attribute device memory to categories.

    ``known`` maps category → tensors ("kv_cache": the runners' pool
    tensors, "weights": their parameters); each category counts its
    distinct storages (a storage two categories share counts in the
    first), and "other" is what the caching allocator holds beyond the
    known storages on the cards (``memory_allocated()`` of every card; 0
    without one). Metadata only: the census launches nothing and never
    syncs."""
    reg = registry or REGISTRY
    seen: dict[tuple, int] = {}
    totals: dict[str, int] = {}
    for name, tensors in (known or {}).items():
        totals[name] = 0
        for key, nbytes in _storages(tensors).items():
            if key not in seen:
                seen[key] = nbytes
                totals[name] += nbytes
    allocated = 0
    if torch.cuda.is_available():
        allocated = sum(torch.cuda.memory_allocated(i)
                        for i in range(torch.cuda.device_count()))
    on_card = sum(n for (dev, _ptr), n in seen.items()
                  if dev.startswith("cuda"))
    totals["other"] = max(0, allocated - on_card)
    out = {"arrays": len(seen), "total_bytes": sum(totals.values()),
           "by_category": totals}
    for name, nbytes in totals.items():
        reg.hbm_live_bytes.set(nbytes, category=name)
    return out


def _param_tensors(tree: Any) -> list:
    """Every tensor of a parameter tree (dicts, lists, quantized weights'
    ``q`` and ``scale``)."""
    out: list = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "q") and hasattr(x, "scale"):
            stack.extend((x.q, x.scale))
    return out


def known_arrays(runners: Iterable[Any]) -> dict[str, list]:
    """The census ``known`` mapping from ModelRunner-shaped objects
    (anything with ``.kv`` — k, v and their scales — and ``.params``);
    other entries are skipped."""
    kv: list = []
    weights: list = []
    for r in runners:
        cache = getattr(r, "kv", None)
        if cache is not None:
            kv.extend(t for t in (getattr(cache, n, None) for n in
                                  ("k", "v", "k_scale", "v_scale"))
                      if t is not None)
        params = getattr(r, "params", None)
        if params is not None:
            weights.extend(_param_tensors(params))
    return {"kv_cache": kv, "weights": weights}


def update_device_gauges(runners: Iterable[Any] = (),
                         registry: Optional[Registry] = None) -> None:
    """Scrape-time refresh (no kernel): memory stats + census. The probe
    is deliberately NOT here — /metrics must never push work onto a
    possibly wedged card; probes run from /debug/devices."""
    device_memory(registry)
    hbm_census(known_arrays(runners), registry)
