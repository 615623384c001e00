"""Dispatch anatomy: where each engine dispatch's wall time went.

A copy of ``localai_tpu/obs/anatomy.py`` (the vocabulary, ``summarize``,
``phase_quantiles`` and ``breakdown``), with the phases read for an eager
PyTorch runner. The flight ring (:mod:`obs.flight`) records each dispatch
as one wall-clock blob; this module names the four phases that split it,
with no added device sync, so metrics, the debug API and the smoke speak
the same names:

======  ===========================================================
phase   meaning on the port
======  ===========================================================
gap     idle since the previous dispatch retired: host scheduling /
        staging between drains (row processing, queue bookkeeping,
        waits) that no other phase claims
sched   admit, select and host-mirror work before the runner call
launch  time for the eager runner call to return: PyTorch runs
        eagerly, so this is the host ISSUING every kernel of the
        dispatch (in the JAX package it is the async enqueue of one
        compiled program)
sync    time blocked at the result fetch, ``np.asarray(toks)`` (the
        CUDA event of ``AsyncTokens``), or the runner's own blocking
        read in its synchronous entry points (``last_sync_ms``)
======  ===========================================================

Attribution model (interval tiling), as in the JAX package: each record's
phases decompose the wall interval its ``dispatch_ms`` accounts for — for
pipelined records the inter-drain interval, for synchronous records the
issue→drain span. ``sched``/``launch`` are accumulated host measurements
since the previous record; ``sync`` is the measured block at the drain;
``gap`` is what no measured phase claims. So ``gap + sched + launch + sync
<= dispatch_ms`` holds for every record.

* ``host_overhead_fraction`` = (gap+sched+launch) / dispatch wall — the
  share of accounted time the host spent NOT blocked on the device. Under
  eager PyTorch a host-bound step shows up here directly: the kernels'
  issue time is ``launch``.
* ``device_bubble_fraction`` is an ESTIMATOR, not a measurement: per
  record ``max(0, (gap+sched+launch) - sync)``. Host time the device
  never made the host wait for is presumed device idleness. A profiler
  trace (``POST /backend/trace``) measures the idle share instead.

Caveats wherever these numbers render:

* Compile-bearing rows (a shape's first dispatch) are excluded.
* ``launch`` absorbs device time when CUDA's launch queue is full: once
  the card falls about a thousand launches behind, the next launch blocks
  until a slot frees, so a device-bound step reads as host time.
* ``launch`` also absorbs every hidden synchronisation inside a runner
  call: a blocking host read, or a blocking host→device copy from
  pageable memory (``tensor.to("cuda")``, ``torch.tensor(..., device=)``
  wait for the stream to drain first). On the port's paths:

  - paged decode (``step_async`` / ``step_n_async``): none; the sampler
    draws a sampled row's token on the device (no ``multinomial`` checks,
    no 0-dim tensor index, both of which read the device);
  - constrained decode (``step_frozen_n``): the freeze mask's copy to the
    card; ``set_bias`` between tokens copies each refreshed bias row;
  - speculative verify (``verify_async``): the proposals' copy to the
    card, and, while a sampled (non-greedy) slot is live, the accept
    scan's ``still.tolist()`` at every window position;
  - prefill (``admit``, ``PagedAdmission.step_chunk``): the chunk's token
    and block-table rows copied to the card, the prompt's ids for the
    penalty counts (``torch.tensor(ids, device=)``), the final chunk's
    block-table row (``_finish_paged_admit``), and ``_prepare_slot``'s
    bias row; the final chunk's ``int(tok)`` is the designed sync and is
    measured as ``sync``;
  - a contiguous admission's ``slot_positions()`` (one [S] read).

  Each of them waits for the dispatches already queued, so a prefill
  chunk issued behind pipelined decode steps carries their device time in
  its ``launch``.
* Records whose writers did not attribute phases carry all-zero phases
  and show up as ``unattributed``.
"""

from __future__ import annotations

from typing import Any, Optional

#: Phase column order — stable; UI stacked bars and bench lines rely on it.
PHASES = ("gap", "sched", "launch", "sync")

QUANTILES = ("p50", "p90", "p99")

#: One-line phase definitions, served with /debug/anatomy payloads.
PHASE_HELP = {
    "gap": ("idle since the previous dispatch retired — host scheduling/"
            "staging no measured phase claims (by exclusion)"),
    "sched": "admit/select/host-mirror work before entering the runner",
    "launch": ("time for the eager runner call to return — the host "
               "issuing every kernel of the dispatch"),
    "sync": "time blocked at the existing result fetch (device-bound)",
}

#: Window the scheduler/metrics plane summarizes over, matching the
#: step-time percentile window in Scheduler.metrics().
DEFAULT_WINDOW_S = 60.0


def summarize(flight: Any, window_s: Optional[float] = DEFAULT_WINDOW_S,
              now: Optional[float] = None) -> dict:
    """Windowed per-phase percentiles/totals + fractions for one ring."""
    return flight.phases(window_s=window_s, now=now)


def phase_quantiles(summary: dict) -> dict:
    """``{phase: {quantile: ms}}`` from a :func:`summarize` dict.

    Skips absent/None entries, so gauge feeding degrades cleanly on empty
    windows and on payloads from replicas that predate the phase columns.
    """
    out: dict = {}
    for ph in PHASES:
        qs = {}
        for q in QUANTILES:
            v = summary.get(f"{ph}_ms_{q}")
            if v is not None:
                qs[q] = float(v)
        if qs:
            out[ph] = qs
    return out


def breakdown(flight: Any, window_s: Optional[float] = DEFAULT_WINDOW_S,
              now: Optional[float] = None) -> dict:
    """``GET /debug/anatomy`` payload: summary + per-phase wall shares.

    Adds ``phase_share`` (each phase's fraction of the windowed dispatch
    wall), the ``unattributed`` remainder (records whose writers did not
    attribute phases — all-zero columns — land here, never silently in a
    phase), and the phase definitions for self-description.
    """
    s = summarize(flight, window_s=window_s, now=now)
    total = s.get("dispatch_ms_total") or 0.0
    attributed = 0.0
    shares: dict = {}
    for ph in PHASES:
        ms = s.get(f"{ph}_ms_total") or 0.0
        attributed += ms
        shares[ph] = round(ms / total, 4) if total > 0 else None
    unattr = max(0.0, total - attributed)
    s["phase_share"] = shares
    s["unattributed_ms_total"] = round(unattr, 3)
    s["unattributed_share"] = (round(unattr / total, 4)
                               if total > 0 else None)
    s["window_s"] = window_s
    s["definitions"] = dict(PHASE_HELP)
    return s
