"""First-dispatch telemetry + the program cost catalog.

Port of ``localai_tpu/obs/compile.py``. PyTorch runs eagerly: there is no
XLA compile and no ``cost_analysis()``. What the port keeps, and what its
numbers mean:

  * :func:`watch` wraps the runner's programs as the JAX package's runner
    wraps its jitted entry points (``decode``, ``decode_n``,
    ``decode_frozen_n``, ``verify``, ``prefill``, ``prefill_mm``,
    ``prefill_resume``, ``prefill_chunk``, ``embed``). The first call of
    each (program, shape) is counted and timed as its "compile": on the
    card that first call also pays the kernel extension's first use, the
    cuBLAS handles and the caching allocator's first blocks. Later calls
    of a seen shape pass through with one set lookup and a counter bump.
    The series keep the JAX package's names,
    ``localai_xla_compile_total`` / ``localai_xla_compile_seconds_total``,
    so dashboards read alike.
  * **Cost catalog** (``GET /debug/programs``): every watched program and
    shape lands in the process-wide :data:`CATALOG` with its cost,
    reckoned by the port from the model config and the call's shape
    (:func:`reckon_cost`): the weights are read once a step, the KV rows
    a step attends over are read and its new rows written (every slot's
    whole context: the shape's worst case, as the JAX package's static
    count), and the FLOPs are 2 × matmul parameters × tokens plus
    attention. The scheduler feeds
    measured per-dispatch latency through :func:`note_latency`; the report
    divides bytes and FLOPs by it and by the device roofline
    (``obs.device.roofline``) into achieved fractions.

The reckoning is not XLA's ``cost_analysis``: XLA counts every operation's
operand and result bytes (intermediates included) and its elementwise
FLOPs, and counts a scanned program's loop body once; the port counts what
a bound needs. ``tests/test_torch_debug_routes.py`` holds the two within
stated bands on a one-shot prefill, and ROADMAP records the divergence.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Optional

from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.obs.metrics import REGISTRY, Registry


class ProgramEntry:
    """One (program, shape-key): statics + counters + the reckoned cost."""

    def __init__(self, program: str, key: tuple, statics: dict,
                 compile_seconds: float, cost: Optional[dict]):
        self.program = program
        self.key = key
        self.statics = statics
        self.compile_seconds = compile_seconds
        self.dispatches = 0
        self.cost = cost
        self.cost_error = "" if cost is not None else "no cost model"


class ProgramCatalog:
    """Process-wide program registry behind /debug/programs.

    Entries are keyed (program, watch-instance, shape-key), so two loaded
    models' "decode" programs stay apart. The latency EMA stays keyed
    (program, steps), as the scheduler feeding it knows no instance."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[tuple, ProgramEntry] = {}
        # measured seconds per DISPATCH, EMA, keyed (program, steps)
        self._latency: dict[tuple, float] = {}

    def record(self, program: str, key: tuple, kwargs: dict,
               compile_seconds: float, cost: Optional[dict]) -> None:
        entry = ProgramEntry(program, key, dict(kwargs), compile_seconds,
                             cost)
        with self._lock:
            entry.dispatches = 1
            self._entries[(program, key)] = entry

    def dispatched(self, program: str, key: tuple) -> None:
        with self._lock:
            e = self._entries.get((program, key))
            if e is not None:
                e.dispatches += 1

    def note_latency(self, program: str, seconds: float, *,
                     steps: int = 1) -> None:
        """Fold one measured per-dispatch wall time into the (program,
        steps) EMA — called by the scheduler at its drain points, never on
        the dispatch path."""
        if seconds <= 0:
            return
        k = (program, int(steps))
        with self._lock:
            prev = self._latency.get(k)
            self._latency[k] = (seconds if prev is None
                                else 0.8 * prev + 0.2 * seconds)

    def reset(self) -> None:
        """Drop every entry and latency (the catalog is process-wide: a
        run that serves one model after others starts it clean)."""
        with self._lock:
            self._entries.clear()
            self._latency.clear()

    def report(self, *, roofline: Optional[dict] = None,
               harvest: bool = True) -> list[dict]:
        """Catalog view joined with measured latency and the roofline.
        ``harvest=False`` lists without the costs (the JAX package's cheap
        listing, which skips its lazy compile)."""
        with self._lock:
            entries = list(self._entries.values())
            latency = dict(self._latency)
        peak_gbps = (roofline or {}).get("peak_gbps")
        peak_tflops = (roofline or {}).get("peak_tflops")
        out = []
        for e in entries:
            steps = int(e.statics.get("n", 1) or 1)
            lat = latency.get((e.program, steps))
            row: dict = {
                "program": e.program,
                # which watch() wrapper (≈ which runner) this entry is
                "instance": e.key[0] if e.key else 0,
                "statics": {k: v for k, v in e.statics.items()},
                "first_dispatch_seconds": round(e.compile_seconds, 4),
                "dispatches": e.dispatches,
                "dispatch_seconds_ema": (None if lat is None
                                         else round(lat, 6)),
            }
            if harvest and e.cost:
                row.update(e.cost)
                flops = e.cost.get("flops") or 0.0
                byts = e.cost.get("bytes_accessed") or 0.0
                if lat:
                    row["achieved_gflops"] = round(flops / lat / 1e9, 3)
                    row["achieved_gbps"] = round(byts / lat / 1e9, 3)
                    if peak_tflops:
                        row["flops_fraction"] = round(
                            flops / lat / (peak_tflops * 1e12), 4)
                    if peak_gbps:
                        row["bandwidth_fraction"] = round(
                            byts / lat / (peak_gbps * 1e9), 4)
            elif harvest and e.cost_error:
                row["cost_error"] = e.cost_error
            out.append(row)
        out.sort(key=lambda r: (r["program"], r["instance"],
                                str(r["statics"])))
        return out


CATALOG = ProgramCatalog()


def note_latency(program: str, seconds: float, *, steps: int = 1) -> None:
    CATALOG.note_latency(program, seconds, steps=steps)


# one id per watch() wrapper: two runners' same-named programs stay apart
_WATCH_SEQ = itertools.count(1)


def watch(fn: Callable, program: str,
          registry: Optional[Registry] = None,
          cost: Optional[Callable[..., Optional[dict]]] = None) -> Callable:
    """Wrap a runner program: the first call per shape (the shapes of the
    tensor arguments and the keyword arguments) is timed and counted as a
    compilation of ``program`` and catalogued with ``cost(*args,
    **kwargs)``; later calls bump the dispatch counter."""
    reg = registry or REGISTRY
    seen: set = set()
    lock = threading.Lock()
    wid = next(_WATCH_SEQ)

    def wrapped(*args: Any, **kwargs: Any) -> Any:
        key = ((wid,)
               + tuple(tuple(a.shape) if hasattr(a, "shape") else None
                       for a in args)
               + tuple(sorted(kwargs.items())))
        with lock:
            fresh = key not in seen
            if fresh:
                seen.add(key)
        if not fresh:
            CATALOG.dispatched(program, key)
            return fn(*args, **kwargs)
        if _faults.ACTIVE:
            # chaos: a compile failure is a first-dispatch failure — on the
            # port the first call of a program shape — raised before it runs
            _faults.apply("engine.compile", key=program)
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        dt = time.monotonic() - t0
        reg.compile_count.inc(program=program)
        reg.compile_seconds.inc(dt, program=program)
        try:
            c = cost(*args, **kwargs) if cost is not None else None
        except Exception:  # noqa: BLE001 — the catalog is best-effort
            c = None
        CATALOG.record(program, key, kwargs, dt, c)
        return out

    wrapped.__name__ = getattr(fn, "__name__", program)
    return wrapped


# -- the port's cost reckoning ----------------------------------------------

def _tensor_bytes(x: Any) -> int:
    if hasattr(x, "q") and hasattr(x, "scale"):
        return _tensor_bytes(x.q) + _tensor_bytes(x.scale)
    return int(x.numel() * x.element_size())


def _numel(x: Any) -> int:
    """Logical weight count (a packed int4 tensor holds two a byte)."""
    if hasattr(x, "q") and hasattr(x, "scale"):
        n = int(x.q.numel())
        return 2 * n if getattr(x, "mode", "") == "w4" else n
    return int(x.numel())


def matmul_weights(params: dict) -> tuple[int, int]:
    """(parameters, bytes) of the weights a forward multiplies by: every
    layer tensor, the final norm and the output head (the embedding
    table when the head is tied to it). A separate embedding table is a
    gather of a few rows, not read whole, so it is not counted."""
    tensors = list(params.get("layers", {}).values())
    tensors += [v for k, v in params.items()
                if k not in ("layers", "embed") and not isinstance(v, dict)]
    if "lm_head" not in params and "embed" in params:
        tensors.append(params["embed"])
    n = sum(_numel(t) for t in tensors)
    b = sum(_tensor_bytes(t) for t in tensors)
    return n, b


def reckon_cost(cfg: Any, params: dict, *, tokens_per_step: int,
                steps: int, attended_rows: int, kv_rows: int,
                kv_row_bytes: int, new_rows: int) -> dict:
    """FLOPs and bytes of ``steps`` forwards of ``tokens_per_step`` tokens
    each, every token attending over ``attended_rows`` rows, reading
    ``kv_rows`` cached rows a step (all layers' K and V, ``kv_row_bytes``
    a row) and writing ``new_rows``: the weights once a step, the KV rows
    read and written, 2 × matmul parameters × tokens plus
    4 × L × Hq × hd × tokens × attended rows for QKᵀ and PV."""
    n_params, w_bytes = matmul_weights(params)
    tokens = tokens_per_step * steps
    attn = 4 * cfg.num_layers * cfg.num_heads * cfg.hd * attended_rows
    flops = (2 * n_params + attn) * tokens
    byts = steps * (w_bytes + (kv_rows + new_rows) * kv_row_bytes)
    return {"flops": float(flops), "bytes_accessed": float(byts)}
