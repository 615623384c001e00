"""Multi-model density on one host: whole-model LRU eviction under device
memory pressure, and the hot weight swap as the deploy primitive.

Port of ``localai_tpu/fleet/autoscale/density.py``. When the card's
memory occupancy crosses the threshold, the least-recently-used non-busy
model is shut down whole (every replica, through the manager's graceful
path), freeing its KV pools and weights for what is serving.

The hot swap turns a checkpoint rollout into a routing event: boot a
replacement for each live replica on the new checkpoint (the pool's
factory reads the fleet's mutable config holder, so runtime spawns pick
the new weights up), let the consistent-hash ring shift traffic to the
newcomers, then drain and retire the old generation: in-flight requests
live-migrate, nothing fails.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

from localai_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)


def hbm_fraction() -> Optional[float]:
    """The worst card's memory occupancy fraction (1 - free / total, from
    ``torch.cuda.mem_get_info``), or None with no card.
    ``LOCALAI_AUTOSCALE_HBM_FRACTION`` overrides it (tests, CPU runs)."""
    override = os.environ.get("LOCALAI_AUTOSCALE_HBM_FRACTION")
    if override:
        try:
            return float(override)
        except ValueError:
            return None
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        fracs = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            if total:
                fracs.append(1.0 - free / total)
        return max(fracs) if fracs else None
    except Exception:  # noqa: BLE001 — density is advisory, never fatal
        return None


def evict_lru_model(manager, *, keep=(), threshold: float = 0.92,
                    fraction: Optional[float] = None) -> Optional[str]:
    """Under memory pressure, evict the least-recently-used non-busy model
    through the manager's graceful shutdown. ``keep`` protects the
    caller's own model; returns the evicted name or None."""
    frac = hbm_fraction() if fraction is None else fraction
    if frac is None or frac < threshold:
        return None
    with manager._lock:
        items = list(manager._models.items())
    candidates = [(name, sm) for name, sm in items
                  if name not in keep and not sm.busy]
    if not candidates:
        return None
    name, _ = min(candidates,
                  key=lambda kv: getattr(kv[1], "last_used", 0.0))
    log.warning("density: device memory at %.0f%% — evicting LRU model %s",
                frac * 100.0, name)
    manager.shutdown_model(name, force=False, wait=5.0)
    return name


def hot_swap(fm, checkpoint: Optional[str] = None, *,
             timeout: float = 30.0) -> dict:
    """Swap every healthy local replica of ``fm`` for a freshly booted one
    (on a new ``checkpoint`` when given). Aborts cleanly, with the old
    generation serving on, if any replacement fails to boot."""
    pool = fm.pool
    olds = [r for r in pool.members()
            if r.respawnable and r.state == "healthy"]
    if not olds:
        return {"ok": False,
                "error": "no healthy local replicas to swap"}
    prev_cfg = fm.cfg_ref["mcfg"]
    if checkpoint:
        fm.cfg_ref["mcfg"] = dataclasses.replace(prev_cfg, model=checkpoint)
        fm.config = fm.cfg_ref["mcfg"]
    spawned = []
    for old in olds:
        rid = pool.spawn(old.role, wait=True)
        if rid is None:
            # the new checkpoint does not boot: tear the replacements down
            # and rebind the old config (the rollout failed, serving not)
            for nid in spawned:
                pool.remove(nid)
            if checkpoint:
                fm.cfg_ref["mcfg"] = prev_cfg
                fm.config = prev_cfg
            log.error("hot swap %s: replacement for %s failed to boot; "
                      "aborted", fm.name, old.id)
            return {"ok": False, "spawned_then_removed": spawned,
                    "error": f"replacement for {old.id} failed to boot"}
        spawned.append(rid)
    drained = {}
    for old in olds:
        drained[old.id] = fm.scheduler.drain(old.id)
        deadline = time.monotonic() + timeout
        while old.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        if old.inflight > 0:
            log.warning("hot swap %s: %s still busy after drain+%.0fs; "
                        "retiring anyway", fm.name, old.id, timeout)
        pool.remove(old.id)
    REGISTRY.model_swaps.inc(model=fm.name)
    REGISTRY.autoscale_decisions.inc(model=fm.name, action="swap")
    auto = getattr(fm, "autoscaler", None)
    if auto is not None:
        auto.decisions["swap"] += 1
    log.info("hot swap %s: %s → %s (%s)", fm.name,
             [r.id for r in olds], spawned,
             checkpoint or "same checkpoint")
    return {"ok": True, "checkpoint": checkpoint,
            "old": [r.id for r in olds], "new": spawned,
            "drained": drained}
