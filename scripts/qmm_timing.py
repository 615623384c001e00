"""Timing study of K4 (w8_matmul) and K5 (w4_matmul) on one NVIDIA card.

Times the quantized matmuls of whichever port package is on the import
path, so that one script times two checkouts alike. From the root of a
checkout:

    PYTHONPATH=. python3 scripts/qmm_timing.py --label change
    PYTHONPATH=<other checkout> python3 scripts/qmm_timing.py --label parent

Inputs are chip_smoke.py's: a seeded normal weight quantized by the
package's own quantizers (int8 per column, int4 in groups of 128) and bf16
x. Shapes: Llama-3-8B's five decode projections at M = 8 (the serving
batch) and K = N = 4096 at M = 256 (the largest prefill chunk the kernels'
gate admits). Each ``qmm_timing`` JSON line holds, under chip_smoke.py's
timer (L2 flushed, CUDA events, the median of 30 launches):

* ``ms``: the wrapper's default call;
* ``library_ms``: torch.matmul on the weight dequantized to bf16
  beforehand (cuBLAS; a yardstick the port never calls);
* ``bound_ms``: the byte or operation bound, as chip_smoke.py counts it;
* ``spun_ms`` / ``library_spun_ms``: the same two with the card spun
  ~0.5 ms between the flush and the start event, so that the host's
  enqueueing of the call (the wrapper's Python, ctypes) does not count,
  only the launches' device time;
* ``host_us``: host time per call while the card is kept busy by a long
  spin, so no call waits for it (scripts/k1_timing.py's measure);
* for a package with the split plan: the plan and ``split_spun_ms``, the
  call at each split count group edges allow among 1, 2, 4, ..., 32,
  under the spun timer.

A last ``qmm_timing`` line per kind sums one 8B decode step (7
projections x 32 layers + the lm_head) from the M = 8 lines.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

# this checkout's chip_smoke.py, by path: the checkout on PYTHONPATH may
# hold an older one
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = [(8, K, N, label) for label, ((K, N), _) in
         chip_smoke.SHAPES_8B.items()] + [(256, 4096, 4096, "M256")]
SPLITS = (1, 2, 4, 8, 16, 32)
SPIN_CYCLES = 1_000_000  # ~0.5 ms of card clock: longer than a call's
                         # host work
HOST_SPIN_CYCLES = 40_000_000  # ~20 ms: longer than 40 calls' host work


def host_us(fn, calls: int = 40, reps: int = 9) -> float:
    """Median host time per call of ``fn``, µs, with the card kept busy by
    a spin enqueued first, so that no call waits for the card."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per_call)[reps // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True,
                    help="name of the checkout in every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qmm_timing: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from localai_tpu_torch.models import quant as tq
    from localai_tpu_torch.ops import qmatmul as tqm

    planned = hasattr(tqm, "qmm_split_plan")
    card = chip_smoke.nvidia_smi_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"qmm_timing {args.label}: {card}; package {tqm.__file__}; "
          f"split plan {planned}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for kind, fn in (("w8", tqm.w8_matmul), ("w4", tqm.w4_matmul)):
        step = {}
        for M, K, N, label in CASES:
            w = torch.randn((K, N), generator=g, device="cuda") * 0.02
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            if kind == "w8":
                qt = tq.quantize_tensor(w, 0)
                wbytes = K * N + 4 * N
                group = tqm.QMM_BK if planned else 0
            else:
                qt = tq.quantize_tensor4(w, 0)
                wbytes = K * N // 2 + qt.scale.numel() * 4
                group = qt.group
            del w
            w_lib = tq.dequantize_tensor(qt, torch.bfloat16)
            bound = chip_smoke._bound(wbytes + 2 * M * K + 2 * M * N,
                                      2 * M * K * N, torch.bfloat16)

            def call():
                return fn(x, qt.q, qt.scale)

            def library():
                return torch.matmul(x, w_lib)

            rec = {"label": args.label, "kind": kind, "shape": label,
                   "M": M, "K": K, "N": N,
                   "ms": chip_smoke.time_ms(call),
                   "library_ms": chip_smoke.time_ms(library),
                   "spun_ms": chip_smoke.time_ms(
                       call, spin_cycles=SPIN_CYCLES),
                   "library_spun_ms": chip_smoke.time_ms(
                       library, spin_cycles=SPIN_CYCLES),
                   "host_us": host_us(call),
                   "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"]}
            if planned:
                rec["plan"] = tqm.qmm_split_plan(M, K, N, group, sms, kind)
                groups = K // group
                rec["split_spun_ms"] = {
                    s: chip_smoke.time_ms(
                        lambda: fn(x, qt.q, qt.scale, k_splits=s),
                        spin_cycles=SPIN_CYCLES)
                    for s in SPLITS
                    if s <= groups and -(-groups // -(-groups // s)) == s}
            print("qmm_timing " + json.dumps(rec), flush=True)
            if M == 8:
                step[label] = rec
            del qt, w_lib, x
            torch.cuda.empty_cache()
        count = {s: (c * chip_smoke.L_8B if c else 1)
                 for s, (_, c) in chip_smoke.SHAPES_8B.items()}
        print("qmm_timing " + json.dumps({
            "label": args.label, "kind": kind, "shape": "decode_step_8b",
            **{f: sum(step[s][f] * n for s, n in count.items())
               for f in ("ms", "library_ms", "spun_ms", "library_spun_ms",
                         "bound_ms")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
