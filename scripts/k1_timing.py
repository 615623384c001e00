"""Timing study of K1 (paged decode attention) on one NVIDIA card.

Times the ``paged_decode_attention`` of whichever port package is on the
import path, so that one script times two checkouts alike. From the root of
a checkout:

    PYTHONPATH=. python3 scripts/k1_timing.py --label change
    PYTHONPATH=<other checkout> python3 scripts/k1_timing.py --label parent

For each traffic mix and pool (bf16, f32, int8, int4) at the serving shape
(S=8, Hq=32, Hkv=8, hd=128, bt=64, 64-entry tables) it prints one
``k1_timing`` JSON line with the wrapper's default call under two timers
and on the host:

* ``event_ms``: chip_smoke.py's ``time_ms`` (L2 flush, start event, call,
  end event): the card's wait for the host's enqueueing counts;
* ``spun_ms``: the same with the card spun ~0.5 ms between the flush and
  the start event, so that only the launches' device time counts;
* ``host_us``: host time per call while the card is busy with a long spin,
  so the host never waits for it: what the call adds to a step bound by
  the host.

A package with the split walk also gives the plan, all three numbers for
the single walk (one split of all 64 entries), and ``split_spun_ms``, the
spun timer at each blocks per split: the host's work is the same at every
split, so the sweep compares device times. The mixes: ``smoke``, chip_smoke.py's
kernel-phase positions; ``profile``, every slot at 1050 as in the decode
steps of ``chip_smoke.py --profile`` (1024-token prompts); ``chat``, the
serving phases' short chats (1-3 live blocks a slot).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
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

MIXES = {"smoke": chip_smoke.SMOKE_POSITIONS,
         "profile": (1050,) * 8,
         "chat": (30, 45, 60, 75, 90, 105, 120, 135)}
# (q dtype, pool, seed): chip_smoke.py's timed kernel cases
POOLS = {"bf16": (torch.bfloat16, "", 0), "f32": (torch.float32, "", 0),
         "int8": (torch.bfloat16, "int8", 4),
         "int4": (torch.bfloat16, "int4", 5)}
SPIN_CYCLES = 1_000_000       # ~0.5 ms of card clock: longer than a call's
                              # host work
HOST_SPIN_CYCLES = 40_000_000  # ~20 ms: longer than 40 calls' host work
SPLIT_BLOCKS = (1, 2, 4, 8, 16, 32)


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
    return statistics.median(per_call)


def three(fn) -> dict:
    return {"event_ms": chip_smoke.time_ms(fn),
            "spun_ms": chip_smoke.time_ms(fn, spin_cycles=SPIN_CYCLES),
            "host_us": host_us(fn)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True,
                    help="name of the checkout in every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_timing: no CUDA device visible", file=sys.stderr)
        return 1
    from localai_tpu_torch.ops import attention

    split = hasattr(attention, "paged_split_plan")
    card = chip_smoke.nvidia_smi_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"k1_timing {args.label}: {card}; package {attention.__file__}; "
          f"split walk {split}", flush=True)
    for mix, positions in MIXES.items():
        for name, (dtype, pool, seed) in POOLS.items():
            q, k, v, tables, pos, scales, _ = chip_smoke.k1_inputs(
                dtype, positions=positions, pool=pool, seed=seed)
            MB = tables.shape[1]

            def call(**kw):
                return attention.paged_decode_attention(
                    q, k, v, tables, pos, *scales, **kw)

            rec = {"label": args.label, "mix": mix, "pool": name,
                   "positions": list(positions), **three(call)}
            if split:
                rec["blocks_per_split"], rec["splits"] = (
                    attention.paged_split_plan(q.shape[0], k.shape[1], MB,
                                               sms, pool))
                rec["single_walk"] = three(lambda: call(split_blocks=MB))
                rec["split_spun_ms"] = {
                    sb: chip_smoke.time_ms(lambda: call(split_blocks=sb),
                                           spin_cycles=SPIN_CYCLES)
                    for sb in SPLIT_BLOCKS}
            print("k1_timing " + json.dumps(rec), flush=True)
            del q, k, v, tables, pos, scales
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
