"""Fault-injection registry: named failure points with trigger predicates.

A copy of ``localai_tpu/faults/registry.py``. The failure classes that
take real deployments down are the ones ordinary tests never exercise: a
dispatch raising mid-decode, one slot's logits going NaN, the block pool
running dry under load, a drain that never returns. This module lets
those failures be *scheduled* — deterministically, per injection point,
with a trigger predicate ("the Nth matching hit, M times, when the key
contains X") — so the recovery paths (engine rebuild, slot quarantine)
run on every test pass instead of only in production incidents.

The port fires ``engine.dispatch``, ``engine.drain``, ``engine.compile``
(a program shape's first call: the port compiles nothing at run time),
``decode.nan``, ``paged.allocate`` and ``spec.draft``, and, in its
in-process fleets, ``worker.stream`` (an in-process replica's reply
stream), ``fleet.dial``, ``fleet.respawn``, ``fleet.transport`` and
``fleet.sibling``: all ten of the JAX package's ``SITES``, so ``GET
/debug/faults`` answers the same table.

Zero overhead when disarmed
---------------------------
Injection sites gate on the module-global :data:`ACTIVE` boolean::

    if _faults.ACTIVE:
        _faults.apply("engine.dispatch", key=program)

``ACTIVE`` is ``False`` unless at least one spec is armed, so a
production dispatch pays one attribute load and a predictable branch —
no environment lookups, no function call, nothing allocated. Arming and
clearing maintain the flag; it is never consulted with a lock held.

Arming
------
* programmatically: ``arm(FaultSpec(site="engine.drain", mode="hang",
  delay_s=3.0, after=2, times=1))``
* environment (parsed once at boot by :func:`install_from_env`):
  ``LOCALAI_FAULT_ENGINE_DRAIN="mode=hang,delay_s=3.0,after=2,times=1"``
  (the site's dots become underscores, uppercased)
* at runtime: ``POST /debug/faults`` (api/debug.py) with the same fields.

Trigger predicate: a spec matches a ``fire(site, key)`` call when the
site equals and ``match`` (if set) is a substring of ``key``; the first
``after`` matching hits are skipped, then the spec fires at most
``times`` times (0 = unlimited). Hit/fire counts are recorded on the
spec (``snapshot()`` shows them) and in the
``localai_faults_injected_total{site}`` counter, so a chaos run can
assert its schedule actually executed.

Only host-side faults exist (raise, hang, sleep, and the modes a site
interprets): a sticky CUDA error poisons the process's context and
needs a process restart, which no rebuild mends.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

# the documented injection points (a spec for an unknown site is refused:
# a typo'd chaos schedule must fail loudly, not silently never fire)
SITES = {
    "engine.dispatch": "scheduler engine loop, before a decode dispatch "
                       "(key: program label). raise = device dispatch "
                       "error; hang/sleep = slow dispatch.",
    "engine.drain": "inside the watchdog-guarded drain of an in-flight "
                    "dispatch (key: engine watchdog channel). hang = "
                    "wedged device round-trip (trips the stall watchdog "
                    "and the self-healing supervisor).",
    "engine.compile": "first dispatch of a program shape (key: program "
                      "label). raise = XLA compile failure.",
    "decode.nan": "poison one active slot's logits with NaN before the "
                  "next dispatch (key: the request's correlation/trace "
                  "id) — exercises the per-row NaN guard.",
    "paged.allocate": "BlockAllocator.allocate (key: seq/slot id). "
                      "exhaust = report the pool full.",
    "spec.draft": "speculative drafter proposals (key: drafter name). "
                  "garble (any non-raise mode) = replace every proposal "
                  "with divergent garbage tokens (acceptance collapses; "
                  "rollback + co-batched streams must stay byte-"
                  "correct); raise = drafter failure mid-window.",
    "worker.stream": "per-reply inside PredictStream, worker gRPC and "
                     "in-process replicas alike (key: model/replica id). "
                     "raise = stream dies mid-flight; sleep = slow "
                     "replica.",
    "fleet.respawn": "fleet replica respawn attempt (key: replica id). "
                     "raise = respawn fails (exercises backoff).",
    "fleet.dial": "replica health dial, every replica kind (key: replica "
                  "id). raise = peer unreachable/refused — a network "
                  "partition as the monitor sees it (exercises eviction "
                  "and redial backoff).",
    "fleet.transport": "per-message on the cross-replica stream pump "
                       "(fleet.net.bounded_stream; key: replica id). "
                       "raise = connection reset mid-stream (partition "
                       "under traffic); sleep = slow link — delay_s past "
                       "LOCALAI_FLEET_RPC_TIMEOUT_S trips the dispatch "
                       "deadline.",
    "fleet.sibling": "inside the directory-driven sibling prefix fetch "
                     "(FleetScheduler._sibling_fetch; key: the DONOR "
                     "replica id). raise = donor dies mid-TransferPrefix "
                     "— the fetch must fall back to a plain re-prefill "
                     "and drop the stale directory entry, never fail "
                     "the request.",
}

# module-global fast gate: hot paths read this one attribute and skip the
# registry entirely while nothing is armed
ACTIVE = False


class FaultInjected(RuntimeError):
    """Raised by ``mode="raise"`` faults at their injection point."""

    def __init__(self, site: str, key: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f" (key={key!r})" if key else ""))
        self.site = site
        self.key = key


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: where, what, and when it triggers."""

    site: str
    mode: str = "raise"      # raise | hang | sleep | exhaust | nan
    after: int = 0           # matching hits to skip before firing
    times: int = 1           # max fires (0 = unlimited)
    match: str = ""          # substring predicate on the site's key
    delay_s: float = 0.0     # hang/sleep duration
    hits: int = 0            # matching hits seen (skipped ones included)
    fired: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultRegistry:
    """Armed specs + the fire predicate. One process-wide instance."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []

    def arm(self, spec: FaultSpec) -> FaultSpec:
        if spec.site not in SITES:
            raise ValueError(
                f"unknown fault site {spec.site!r}; have {sorted(SITES)}")
        if spec.after < 0 or spec.times < 0 or spec.delay_s < 0:
            raise ValueError("after/times/delay_s must be >= 0")
        with self._lock:
            self._specs.append(spec)
        _set_active(True)
        log.warning("fault armed: %s", spec.to_dict())
        return spec

    def clear(self, site: Optional[str] = None) -> int:
        with self._lock:
            before = len(self._specs)
            self._specs = [s for s in self._specs
                           if site is not None and s.site != site]
            remaining = len(self._specs)
        _set_active(remaining > 0)
        return before - remaining

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._specs]

    def fire(self, site: str, key: str = "") -> Optional[FaultSpec]:
        """The trigger predicate: returns the first armed spec for
        ``site`` that matches ``key`` and is due (past ``after``, under
        ``times``), advancing its counters — else None. Exhausted specs
        stay listed (their counts are the chaos run's receipt)."""
        with self._lock:
            for spec in self._specs:
                if spec.site != site:
                    continue
                if spec.match and spec.match not in key:
                    continue
                spec.hits += 1
                if spec.hits <= spec.after:
                    continue
                if spec.times and spec.fired >= spec.times:
                    continue
                spec.fired += 1
                winner = spec
                break
            else:
                return None
        # counter import is lazy so this leaf module stays importable
        # before the obs registry (and the metric cost is fire-time only)
        from localai_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.faults_injected.inc(site=site)
        log.warning("fault fired: site=%s key=%r mode=%s (fire %d)",
                    site, key, winner.mode, winner.fired)
        return winner


REGISTRY = FaultRegistry()


def _set_active(value: bool) -> None:
    global ACTIVE
    ACTIVE = value


def active() -> bool:
    """Current gate value. Injection sites read the module global
    directly (one attribute load); package-level consumers must call
    this — a ``from faults import ACTIVE`` would freeze the boot-time
    value."""
    return ACTIVE


# -- module-level convenience surface (what injection sites call) ---------

def arm(spec: FaultSpec) -> FaultSpec:
    return REGISTRY.arm(spec)


def clear(site: Optional[str] = None) -> int:
    return REGISTRY.clear(site)


def snapshot() -> list[dict]:
    return REGISTRY.snapshot()


def fire(site: str, key: str = "") -> Optional[FaultSpec]:
    return REGISTRY.fire(site, key)


def apply(site: str, key: str = "") -> Optional[FaultSpec]:
    """Fire-and-interpret for the common modes: ``raise`` raises
    :class:`FaultInjected` at the call site, ``hang``/``sleep`` block for
    ``delay_s`` (outside the registry lock) and return the spec; other
    modes (``exhaust``, ``nan``) are returned for the site to interpret.
    Returns None when nothing fired."""
    spec = REGISTRY.fire(site, key)
    if spec is None:
        return None
    if spec.mode == "raise":
        raise FaultInjected(site, key)
    if spec.mode in ("hang", "sleep") and spec.delay_s > 0:
        time.sleep(spec.delay_s)
    return spec


def parse_spec(site: str, text: str) -> FaultSpec:
    """``"mode=hang,delay_s=3.0,after=2,times=1,match=decode"`` →
    FaultSpec (the LOCALAI_FAULT_* / POST /debug/faults value grammar)."""
    kw: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad fault field {part!r} (want key=value)")
        k, v = part.split("=", 1)
        k = k.strip()
        v = v.strip()
        if k in ("after", "times"):
            kw[k] = int(v)
        elif k == "delay_s":
            kw[k] = float(v)
        elif k in ("mode", "match"):
            kw[k] = v
        else:
            raise ValueError(f"unknown fault field {k!r}")
    return FaultSpec(site=site, **kw)


def install_from_env(environ=None) -> int:
    """Parse every ``LOCALAI_FAULT_<SITE>`` variable (dots in the site
    name written as underscores) and arm the specs. Called once at
    server/worker boot — never on a request path. Returns specs armed."""
    env = os.environ if environ is None else environ
    sites_by_env = {s.replace(".", "_").upper(): s for s in SITES}
    armed = 0
    for name, value in env.items():
        if not name.startswith("LOCALAI_FAULT_") or not value:
            continue
        suffix = name[len("LOCALAI_FAULT_"):]
        site = sites_by_env.get(suffix)
        if site is None:
            log.warning("ignoring %s: no injection site matches", name)
            continue
        try:
            arm(parse_spec(site, value))
            armed += 1
        except ValueError as e:
            log.warning("ignoring %s=%r: %s", name, value, e)
    return armed
