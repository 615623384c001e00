"""Cross-replica call discipline: deadlines, bounded retries, stream pumps.

Port of ``localai_tpu/fleet/net.py``. A partitioned peer does not refuse
connections, it goes silent, and a slow link delivers every byte
eventually; neither raises, both hang. So every cross-replica interaction
of the fleet goes through this module:

  * **explicit deadlines** — :func:`rpc_timeout_s` is the one setting
    (``LOCALAI_FLEET_RPC_TIMEOUT_S``, default 120 s) bounding control
    calls and, through :func:`bounded_stream`, the per-reply inactivity
    of dispatch and prefill streams (a generation may run for minutes;
    what may never happen is silence between replies);
  * **bounded jittered retry** — :func:`call_with_retries` for calls that
    are idempotent by construction (stats pulls, prefix imports). Dispatch
    streams are not retried here: failover is the fleet scheduler's
    routing decision;
  * **fault surface** — the ``fleet.transport`` injection site fires on
    the stream pump (per message, keyed by replica id), so partitions
    (``raise``) and slow links (``sleep``) are emulated where a real
    link would fail. In-process replicas run through the same pump.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
import time
from typing import Callable, Iterator, Optional, TypeVar

from localai_tpu_torch.faults import registry as _faults

log = logging.getLogger(__name__)

T = TypeVar("T")

# generous: the deadline must sit above the worst queue wait + TTFT of a
# cold replica, or spurious failovers cascade
DEFAULT_RPC_TIMEOUT_S = 120.0
DEFAULT_RPC_RETRIES = 2


def rpc_timeout_s() -> float:
    """The fleet's cross-replica deadline (``LOCALAI_FLEET_RPC_TIMEOUT_S``,
    default 120 s; 0 disables it). Control calls use it directly; streams
    use it as the per-reply inactivity bound."""
    try:
        return float(os.environ.get("LOCALAI_FLEET_RPC_TIMEOUT_S", "")
                     or DEFAULT_RPC_TIMEOUT_S)
    except ValueError:
        return DEFAULT_RPC_TIMEOUT_S


def rpc_retries() -> int:
    """Max retries of idempotent cross-replica calls
    (``LOCALAI_FLEET_RPC_RETRIES``, default 2)."""
    try:
        return int(os.environ.get("LOCALAI_FLEET_RPC_RETRIES", "")
                   or DEFAULT_RPC_RETRIES)
    except ValueError:
        return DEFAULT_RPC_RETRIES


class RpcDeadlineExceeded(RuntimeError):
    """A cross-replica call (or one reply of a stream) blew its deadline."""

    def __init__(self, rid: str, timeout: float, what: str = "reply"):
        super().__init__(
            f"no {what} from {rid or 'peer'} within {timeout:.1f}s "
            "(LOCALAI_FLEET_RPC_TIMEOUT_S)")
        self.rid = rid
        self.timeout = timeout


def call_with_retries(fn: Callable[[], T], *, retries: Optional[int] = None,
                      base_delay: float = 0.1, cap_delay: float = 2.0,
                      rid: str = "", what: str = "rpc") -> T:
    """Run ``fn`` with up to ``retries`` bounded, jittered-exponential
    retries. Only for idempotent calls: re-running must be a no-op on the
    peer. Every retry is counted in ``localai_fleet_rpc_retries_total``."""
    n = rpc_retries() if retries is None else retries
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — transport errors retry
            if attempt >= n:
                raise
            delay = min(cap_delay, base_delay * (2 ** attempt))
            delay *= 0.75 + 0.5 * random.random()
            attempt += 1
            from localai_tpu_torch.obs.metrics import REGISTRY

            REGISTRY.fleet_rpc_retries.inc(rpc=what)
            log.warning("fleet rpc %s to %s failed (%s); retry %d/%d in "
                        "%.2fs", what, rid or "peer", e, attempt, n, delay)
            time.sleep(delay)


# marks the normal end of a stream on the pump queue
_DONE = object()


def bounded_stream(replies: Iterator[T], timeout: float, *,
                   rid: str = "") -> Iterator[T]:
    """Pump ``replies`` on a reader thread and re-yield each item, raising
    :class:`RpcDeadlineExceeded` when the upstream goes silent for more
    than ``timeout`` seconds (0 = no deadline, a pure pump).

    The ``fleet.transport`` fault site fires per message inside the pump,
    upstream of the deadline check: an injected ``sleep`` is a slow link,
    an injected ``raise`` a mid-stream connection reset."""
    if timeout <= 0 and not _faults.ACTIVE:
        # no deadline and nothing armed: no pump thread, no queue hop
        yield from replies
        return
    q: "queue.Queue" = queue.Queue(maxsize=64)
    abandoned = threading.Event()

    def pump() -> None:
        payload: object = _DONE
        try:
            for item in replies:
                if _faults.ACTIVE:
                    _faults.apply("fleet.transport", key=rid)
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            payload = e
        finally:
            if abandoned.is_set():
                # the consumer is gone: release the upstream. A generator
                # may only be closed by the thread that runs its frame —
                # this one
                close = getattr(replies, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — teardown only
                        pass
            else:
                while not abandoned.is_set():
                    try:
                        q.put(payload, timeout=0.25)
                        break
                    except queue.Full:
                        continue

    t = threading.Thread(target=pump, daemon=True,
                         name=f"fleet-pump-{rid or 'stream'}")
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=timeout if timeout > 0 else None)
            except queue.Empty:
                raise RpcDeadlineExceeded(rid, timeout) from None
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()
        # only a cross-thread-safe cancel here; a plain generator is
        # closed by the pump itself
        cancel = getattr(replies, "cancel", None)
        if cancel is not None:
            try:
                cancel()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
