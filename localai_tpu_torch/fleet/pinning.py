"""Per-replica device pinning (``--fleet-device-pinning``).

Port of ``localai_tpu/fleet/pinning.py``. ``--fleet-replicas N`` with
worker replicas spawns N engine processes; without pinning every worker
takes the same devices. This module derives each replica's spawn
environment instead of a hand-written ``worker_env``: the host's visible
devices split into N contiguous equal slices, and each replica's spawn
environment pins its slice.

By platform:

  * **cuda** — ``CUDA_VISIBLE_DEVICES=<ids>`` (the worker sees only its
    slice, as device 0 onward);
  * **cpu** — ``LOCALAI_DEVICE=cpu`` (the test shape);
  * anything else — no convention, so the replica spawns unpinned and the
    operator keeps ``worker_env``.

Fewer devices than replicas cannot be partitioned: the replicas spawn
unpinned, with one warning. On a CUDA card they then share the device
(a CUDA context a process, each with its own weights and KV pool), where
a second TPU worker of the JAX package would die on a held chip.

:func:`pinning_env` takes the platform and device count explicitly, so
tests pin the partition arithmetic without a device. On a fleet host
declare the topology with ``LOCALAI_FLEET_PIN_PLATFORM=cuda
LOCALAI_FLEET_PIN_DEVICES=8``; otherwise :func:`derive_pinning_env` reads
``torch.cuda.device_count()``, which creates no CUDA context in the
serving process.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)

_warned: set = set()
_warned_lock = threading.Lock()


def _warn_once(key: tuple, msg: str, *args) -> None:
    with _warned_lock:
        if key in _warned:
            return
        _warned.add(key)
    log.warning(msg, *args)


def pinning_env(index: int, replicas: int, *, platform: str,
                n_devices: int) -> dict[str, str]:
    """Spawn-environment additions for replica ``index`` of ``replicas`` on
    a host with ``n_devices`` ``platform`` devices.

    Devices split into ``replicas`` contiguous slices of ``n_devices //
    replicas``; the remainder stays unused rather than skewing one
    replica. {} when the split is impossible (fewer devices than replicas)
    or the platform has no pinning convention."""
    if not 0 <= index < replicas:
        raise ValueError(f"replica index {index} outside fleet size "
                         f"{replicas}")
    per = n_devices // replicas
    if per < 1:
        _warn_once(("split", replicas, n_devices, platform),
                   "device pinning: %d replicas over %d %s device(s) — "
                   "cannot partition; replicas spawn unpinned", replicas,
                   n_devices, platform)
        return {}
    if n_devices % replicas:
        _warn_once(("rest", replicas, n_devices, platform),
                   "device pinning: %d %s devices do not divide evenly over "
                   "%d replicas; %d device(s) stay unused", n_devices,
                   platform, replicas, n_devices % replicas)
    ids = range(index * per, (index + 1) * per)
    if platform == "cuda":
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in ids)}
    if platform == "cpu":
        return {"LOCALAI_DEVICE": "cpu"}
    _warn_once(("platform", platform),
               "device pinning: no visible-device convention for platform "
               "%r; replicas spawn unpinned (set worker_env explicitly)",
               platform)
    return {}


def derive_pinning_env(index: int, replicas: int) -> dict[str, str]:
    """:func:`pinning_env` for this host's devices:
    ``LOCALAI_FLEET_PIN_PLATFORM`` + ``LOCALAI_FLEET_PIN_DEVICES`` when
    both are set, else ``torch.cuda.device_count()`` cards (``cpu`` with
    one device when there is none)."""
    platform = os.environ.get("LOCALAI_FLEET_PIN_PLATFORM", "")
    nd = os.environ.get("LOCALAI_FLEET_PIN_DEVICES", "")
    if platform and nd:
        return pinning_env(index, replicas, platform=platform,
                           n_devices=int(nd))
    import torch

    n = torch.cuda.device_count()
    platform = "cuda" if n else "cpu"
    log.info("device pinning: LOCALAI_FLEET_PIN_PLATFORM/_DEVICES unset; "
             "%d %s device(s) on this host", max(n, 1), platform)
    return pinning_env(index, replicas, platform=platform,
                       n_devices=max(n, 1))


def pinned_worker_env(base: Optional[dict], index: int,
                      replicas: int) -> dict[str, str]:
    """The derived slice under the operator's ``worker_env`` (explicit
    keys win; the derived ones fill the gaps)."""
    out = dict(derive_pinning_env(index, replicas))
    out.update(base or {})
    return out
