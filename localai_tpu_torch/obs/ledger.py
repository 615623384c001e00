"""Per-tenant cost ledger + goodput/waste decomposition (obs subsystem).

A copy of ``localai_tpu/obs/ledger.py``: the tenant derivation, the LRU
of ``LOCALAI_TENANT_MAX`` tenants, the panes, the waste classes, the
``/v1/usage`` payload and the registry export kept.

* The DISPATCH is the accounting grain — every delivered token,
  engine-resident millisecond and queue-wait second is attributable to
  one request, hence to one (tenant, model, lane) pane.
* KV-BLOCK-SECONDS is the memory cost unit: a request's context occupies
  ``ceil(tokens / block_tokens)`` blocks for its slot-resident lifetime,
  host arithmetic only.

Tenant identity is derived from the API key by :func:`derive_tenant`:
the raw key NEVER appears in a label, a trace, or any exposition — only a
short sha256 prefix (``t-<12 hex>``), or the stable ``anonymous`` bucket
when auth is off. Overflow past the LRU merges into one ``overflow`` pane
and counts an eviction.

Every request's work is classified once at its terminal event
(``EngineTelemetry.finished``) into GOODPUT (``stop``/``length``) or a
named WASTE class:

====================  ====================================================
reason                meaning (unit)
====================  ====================================================
cancelled             tokens generated for a request the client abandoned
error                 tokens generated before a backend error
nan_quarantine        tokens on a request failed by the NaN row guard
spec_rejected         draft tokens proposed but rejected by verify
shed                  requests refused by SLO admission control (requests)
failover_reprefill    prompt tokens re-prefilled after a replica failover
migration_reprefill   prompt tokens re-prefilled by a migration fallback
====================  ====================================================

``nan_quarantine`` is fed by the scheduler's NaN quarantine,
``failover_reprefill`` and ``migration_reprefill`` by the fleet's
dispatch thread (``fleet.serving``).

Per engine the token-emitting classes reconcile exactly against the
flight ring: ``goodput_tokens + cancelled + error + nan_quarantine tokens
== FlightRecorder.total_tokens`` (both sides count sampled tokens, EOS
excluded). ``spec_rejected``/``shed``/``*_reprefill`` measure work the
ring never counted and sit outside that identity.

Feed discipline: the ledger is process-global, and ``finished()`` feeds
it only when the request carries a tenant (stamped by the server's auth
check), so a direct scheduler submit stays unattributed.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from collections import OrderedDict, deque
from contextvars import ContextVar
from typing import Any, Optional

ANONYMOUS = "anonymous"   # auth off / exempt path: one stable bucket
OVERFLOW = "overflow"     # LRU-evicted tenants merge here

# token-emitting waste classes — these (plus goodput) reconcile against
# FlightRecorder.total_tokens; the rest measure work outside the ring
FLIGHT_WASTE = ("cancelled", "error", "nan_quarantine")
WASTE_REASONS = FLIGHT_WASTE + (
    "spec_rejected", "shed", "failover_reprefill", "migration_reprefill",
)

# the request's tenant travels with the handler thread's context: set by
# the server's auth check for the request, resolved by
# api.openai._gen_request
_tenant_var: ContextVar[str] = ContextVar("request_tenant", default="")


def current_tenant() -> str:
    """The tenant the auth middleware stamped on this task ('' outside a
    request context — direct scheduler submits stay unattributed)."""
    return _tenant_var.get()


def set_current_tenant(tenant: str) -> Any:
    """Stamp the calling context's tenant; returns the reset token."""
    return _tenant_var.set(tenant)


def reset_current_tenant(token: Any) -> None:
    """Undo :func:`set_current_tenant` at the request's end (a connection
    thread serves its next request with no stale tenant)."""
    _tenant_var.reset(token)


def derive_tenant(api_key: str) -> str:
    """API key → bounded tenant label. NEVER the raw key: a short sha256
    prefix identifies the tenant across restarts without leaking the
    secret into /metrics labels, traces, or snapshots."""
    if not api_key:
        return ANONYMOUS
    return "t-" + hashlib.sha256(api_key.encode("utf-8")).hexdigest()[:12]


def kv_block_seconds(prompt_tokens: int, completion_tokens: int,
                     resident_s: float, block_tokens: int = 16) -> float:
    """The PagedAttention memory cost of one finished request: final
    context footprint in blocks × slot-resident seconds. An upper-bound
    host estimate (the request grew into its last block over time), but
    monotone and comparable across tenants."""
    tokens = max(0, prompt_tokens) + max(0, completion_tokens)
    blocks = math.ceil(tokens / max(1, block_tokens))
    return blocks * max(0.0, resident_s)


def _new_pane() -> dict:
    return {
        "requests": 0,
        "delivered_tokens": 0,
        "prompt_tokens": 0,
        "dispatch_ms": 0.0,
        "queue_wait_ms": 0.0,
        "kv_block_seconds": 0.0,
        "waste_tokens": 0,
        "waste_requests": 0,
    }


def _merge_pane(dst: dict, src: dict) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


class TenantLedger:
    """The process-wide usage ledger. All mutators take one short lock
    around plain dict arithmetic (no I/O, no device work, no nested
    locks) — safe to call from the engine thread at drain points."""

    def __init__(self, max_tenants: Optional[int] = None,
                 events: int = 4096):
        if max_tenants is None:
            try:
                max_tenants = int(os.environ.get("LOCALAI_TENANT_MAX", 64))
            except ValueError:
                max_tenants = 64
        self.max_tenants = max(2, max_tenants)
        self._lock = threading.Lock()
        # tenant → {(model, lane) → pane}; OrderedDict is the LRU order
        self._tenants: OrderedDict[str, dict] = OrderedDict()
        # (reason, model) → {"tokens": n, "requests": n}
        self._waste: dict[tuple[str, str], dict] = {}
        # model → delivered tokens (goodput side of the decomposition)
        self._goodput: dict[str, int] = {}
        self.evictions_total = 0
        # bounded finished-request ring feeding /v1/usage ?since=/?window=
        self._events: deque = deque(maxlen=events)

    # -- feed points ------------------------------------------------------

    def note_request(self, *, tenant: str, model: str, lane: str,
                     reason: str, tokens: int, prompt_tokens: int,
                     dispatch_ms: float, queue_wait_ms: float,
                     kv_block_s: float) -> None:
        """One finished request, classified by its terminal reason:
        ``stop``/``length`` → goodput; anything else → the matching
        token-emitting waste class. Called from EngineTelemetry.finished
        — the single feed point every scheduler tier shares."""
        model = model or "engine"
        goodput = reason in ("stop", "length")
        with self._lock:
            pane = self._pane(tenant, model, lane)
            pane["requests"] += 1
            pane["prompt_tokens"] += max(0, prompt_tokens)
            pane["dispatch_ms"] += max(0.0, dispatch_ms)
            pane["queue_wait_ms"] += max(0.0, queue_wait_ms)
            pane["kv_block_seconds"] += max(0.0, kv_block_s)
            if goodput:
                pane["delivered_tokens"] += max(0, tokens)
                self._goodput[model] = (
                    self._goodput.get(model, 0) + max(0, tokens))
            else:
                waste_reason = (reason if reason in WASTE_REASONS
                                else "error")
                pane["waste_tokens"] += max(0, tokens)
                pane["waste_requests"] += 1
                self._waste_cell(waste_reason, model, tokens=max(0, tokens),
                                 requests=1)
            self._events.append({
                "ts": time.time(),
                "tenant": tenant,
                "model": model,
                "lane": lane,
                "reason": reason,
                "tokens": max(0, tokens),
                "prompt_tokens": max(0, prompt_tokens),
                "dispatch_ms": round(max(0.0, dispatch_ms), 3),
                "queue_wait_ms": round(max(0.0, queue_wait_ms), 3),
                "kv_block_seconds": round(max(0.0, kv_block_s), 3),
            })

    def note_waste(self, reason: str, *, model: str = "", tenant: str = "",
                   tokens: int = 0, requests: int = 0) -> None:
        """Waste observed OUTSIDE a request's terminal event: rejected
        draft tokens, shed admissions, failover/migration re-prefills.
        Tenant attribution is best-effort (the engine thread doesn't
        always know one) — the per-model decomposition is exact."""
        model = model or "engine"
        with self._lock:
            self._waste_cell(reason, model, tokens=max(0, tokens),
                             requests=max(0, requests))
            if tenant:
                pane = self._pane(tenant, model, "interactive")
                pane["waste_tokens"] += max(0, tokens)
                pane["waste_requests"] += max(0, requests)

    # -- internals (caller holds _lock) -----------------------------------

    def _pane(self, tenant: str, model: str,
              lane: str) -> dict:
        panes = self._tenants.get(tenant)
        if panes is None:
            panes = self._tenants[tenant] = {}
            while len(self._tenants) > self.max_tenants:
                self._evict()
        else:
            self._tenants.move_to_end(tenant)
        pane = panes.get((model, lane))
        if pane is None:
            pane = panes[(model, lane)] = _new_pane()
        return pane

    def _evict(self) -> None:
        """Fold the least-recently-seen evictable tenant into the
        ``overflow`` bucket — totals are conserved, cardinality bounded."""
        victim = next(
            (t for t in self._tenants if t not in (ANONYMOUS, OVERFLOW)),
            None)
        if victim is None:
            return
        panes = self._tenants.pop(victim)
        over = self._tenants.setdefault(OVERFLOW, {})
        for key, pane in panes.items():
            dst = over.get(key)
            if dst is None:
                over[key] = dict(pane)
            else:
                _merge_pane(dst, pane)
        self.evictions_total += 1

    def _waste_cell(self, reason: str, model: str, *, tokens: int,
                    requests: int) -> None:
        cell = self._waste.get((reason, model))
        if cell is None:
            cell = self._waste[(reason, model)] = {"tokens": 0,
                                                   "requests": 0}
        cell["tokens"] += tokens
        cell["requests"] += requests

    # -- read side --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able full-state copy (the smoke's reconciliation input).
        Copy under the lock, format outside — same discipline as
        FlightRecorder.snapshot."""
        with self._lock:
            tenants = {
                t: {f"{m}/{lane}": dict(p)
                    for (m, lane), p in panes.items()}
                for t, panes in self._tenants.items()
            }
            waste = {f"{reason}/{m}": dict(cell)
                     for (reason, m), cell in self._waste.items()}
            goodput = dict(self._goodput)
            evictions = self.evictions_total
        return {
            "tenants": tenants,
            "waste": waste,
            "goodput_tokens": goodput,
            "evictions_total": evictions,
        }

    def goodput_totals(self, model: Optional[str] = None) -> dict:
        """The decomposition for one model (or all): delivered tokens,
        per-reason waste, and the flight-identity sum (delivered +
        token-emitting waste == FlightRecorder.total_tokens)."""
        with self._lock:
            delivered = (self._goodput.get(model, 0) if model
                         else sum(self._goodput.values()))
            waste: dict[str, dict] = {}
            for (reason, m), cell in self._waste.items():
                if model and m != model:
                    continue
                agg = waste.setdefault(reason,
                                       {"tokens": 0, "requests": 0})
                agg["tokens"] += cell["tokens"]
                agg["requests"] += cell["requests"]
        flight_tokens = delivered + sum(
            waste.get(r, {}).get("tokens", 0) for r in FLIGHT_WASTE)
        waste_tokens = sum(c["tokens"] for c in waste.values())
        total = delivered + waste_tokens
        return {
            "delivered_tokens": delivered,
            "waste": waste,
            "waste_tokens": waste_tokens,
            "flight_tokens": flight_tokens,
            "goodput_ratio": (delivered / total) if total else 1.0,
        }

    def usage_payload(self, *, since: Optional[float] = None,
                      window: Optional[float] = None) -> dict:
        """The GET /v1/usage body (OpenAI-usage-shaped: one ``data`` row
        per (tenant, model, lane) aggregation bucket). With ``since``/
        ``window`` the rows aggregate the bounded event ring instead of
        lifetime totals — ``coverage_start`` says how far back the ring
        actually reaches, so a truncated window is visible, not silent."""
        now = time.time()
        if window is not None:
            since = max(since or 0.0, now - window)
        if since is not None:
            with self._lock:
                events = [e for e in self._events if e["ts"] >= since]
                coverage = self._events[0]["ts"] if self._events else now
                evictions = self.evictions_total
            rows: dict[tuple, dict] = {}
            for e in events:
                key = (e["tenant"], e["model"], e["lane"])
                pane = rows.setdefault(key, _new_pane())
                pane["requests"] += 1
                pane["prompt_tokens"] += e["prompt_tokens"]
                pane["dispatch_ms"] += e["dispatch_ms"]
                pane["queue_wait_ms"] += e["queue_wait_ms"]
                pane["kv_block_seconds"] += e["kv_block_seconds"]
                if e["reason"] in ("stop", "length"):
                    pane["delivered_tokens"] += e["tokens"]
                else:
                    pane["waste_tokens"] += e["tokens"]
                    pane["waste_requests"] += 1
            data = [
                {"tenant": t, "model": m, "lane": lane, **pane}
                for (t, m, lane), pane in sorted(rows.items())
            ]
            return {
                "object": "usage",
                "start_time": since,
                "end_time": now,
                "coverage_start": coverage,
                "events": len(events),
                "data": data,
                "tenant_lru": {"evictions_total": evictions},
            }
        snap = self.snapshot()
        data = []
        for tenant, panes in sorted(snap["tenants"].items()):
            for key, pane in sorted(panes.items()):
                model, _, lane = key.partition("/")
                data.append({"tenant": tenant, "model": model,
                             "lane": lane, **pane})
        waste = [
            {"reason": key.partition("/")[0],
             "model": key.partition("/")[2], **cell}
            for key, cell in sorted(snap["waste"].items())
        ]
        return {
            "object": "usage",
            "start_time": None,
            "end_time": now,
            "data": data,
            "waste": waste,
            "goodput": self.goodput_totals(),
            "tenant_lru": {
                "evictions_total": snap["evictions_total"],
                "tenants": len(snap["tenants"]),
                "max_tenants": self.max_tenants,
            },
        }

    def export(self, registry: Any) -> None:
        """Sync the registry's tenant/goodput/waste families from the
        ledger (scrape-time, like update_engine_gauges). ``set_total`` is
        a max-merge, so re-exports and the update_engine_gauges spec/shed
        sync writing the same cells stay consistent."""
        snap = self.snapshot()
        for tenant, panes in snap["tenants"].items():
            for key, pane in panes.items():
                model, _, lane = key.partition("/")
                lbl = {"tenant": tenant, "model": model, "lane": lane}
                registry.tenant_requests.set_total(pane["requests"], **lbl)
                registry.tenant_tokens.set_total(
                    pane["delivered_tokens"], **lbl)
                registry.tenant_prompt_tokens.set_total(
                    pane["prompt_tokens"], **lbl)
                registry.tenant_dispatch_ms.set_total(
                    pane["dispatch_ms"], **lbl)
                registry.tenant_queue_wait_ms.set_total(
                    pane["queue_wait_ms"], **lbl)
                registry.tenant_kv_block_seconds.set_total(
                    pane["kv_block_seconds"], **lbl)
        registry.tenant_lru_evictions.set_total(snap["evictions_total"])
        for key, cell in snap["waste"].items():
            reason, _, model = key.partition("/")
            registry.waste_tokens.set_total(
                cell["tokens"], model=model, reason=reason)
            registry.waste_requests.set_total(
                cell["requests"], model=model, reason=reason)
        for model, tokens in snap["goodput_tokens"].items():
            registry.goodput_tokens.set_total(tokens, model=model)
            registry.goodput_ratio.set(
                self.goodput_totals(model)["goodput_ratio"], model=model)

    def reset(self) -> None:
        """Test hook: drop all state (the singleton is process-global)."""
        with self._lock:
            self._tenants.clear()
            self._waste.clear()
            self._goodput.clear()
            self._events.clear()
            self.evictions_total = 0


LEDGER = TenantLedger()
