"""Timing study of K2 (contiguous decode attention) and K3 (prefill
attention) on one NVIDIA card.

Times the ``decode_attention`` and ``prefill_attention`` of whichever port
package is on the import path, so that one script times two checkouts
alike. From the root of a checkout:

    PYTHONPATH=. python3 scripts/attn_timing.py --label change
    PYTHONPATH=<other checkout> python3 scripts/attn_timing.py --label parent

It prints one ``attn_timing`` JSON line per case, each with the kernel's
default call under two timers and on the host:

* ``event_ms``: chip_smoke.py's ``time_ms`` (L2 flush, start event, call,
  end event): the card's wait for the host's enqueueing counts;
* ``spun_ms``: the same with the card spun ~0.5 ms between the flush and
  the start event, so that only the launches' device time counts;
* ``host_us``: host time per call while the card is busy with a long spin,
  so the host never waits for it.

K2: S=8, Hq=32, Hkv=8, hd=128 over a [8, 8, 4096, 128] cache in bf16,
f32 and scaled int8 at three traffic mixes (``smoke``: chip_smoke.py's
positions; ``profile``: every slot at 1050, as in ``chip_smoke.py
--profile``; ``chat``: the serving phases' short chats), with the
library's time (SDPA over the cache masked to each slot's rows, int8
dequantized beforehand) under both timers. A package with the split walk
also gives the plan, all three numbers for the single walk (one split of
all 64 tiles) and ``split_spun_ms``, the spun timer at each tiles per
split. K3: bf16 at Hq=32, Hkv=8, hd=128 for T = 512, 1024, 2048 and 4096
(length T), against SDPA with ``is_causal`` under both timers; a package
with the row plan also gives the plan's rows a CUDA block and
``rows_spun_ms``, the spun timer at each block size it compiles.
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
# (q dtype, cache kind, seed): chip_smoke.py's timed K2 cases
CACHES = {"bf16": (torch.bfloat16, "", 0), "f32": (torch.float32, "", 1),
          "int8": (torch.bfloat16, "int8", 2)}
PREFILL_T = (512, 1024, 2048, 4096)
SPIN_CYCLES = 1_000_000       # ~0.5 ms of card clock: longer than a call's
                              # host work
HOST_SPIN_CYCLES = 40_000_000  # ~20 ms: longer than 40 calls' host work
SPLIT_TILES = (1, 2, 4, 8, 16, 32)


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


def two(fn, iters: int = 30) -> dict:
    return {"event_ms": chip_smoke.time_ms(fn, iters=iters),
            "spun_ms": chip_smoke.time_ms(fn, iters=iters,
                                          spin_cycles=SPIN_CYCLES)}


def three(fn, iters: int = 30) -> dict:
    return {**two(fn, iters), "host_us": host_us(fn)}


def decode_records(attention, label: str, sms: int):
    split = hasattr(attention, "decode_split_plan")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for mix, positions in MIXES.items():
        for name, (dtype, kv, seed) in CACHES.items():
            q, k, v, pos, scales, _ = chip_smoke.k2_inputs(
                dtype, kv=kv, positions=positions, seed=seed)
            S, Hkv, C = k.shape[0], k.shape[1], k.shape[2]

            def call(**kw):
                return attention.decode_attention(q, k, v, pos, *scales,
                                                  **kw)

            if kv:
                keys = k.to(dtype) * scales[0][..., None].to(dtype)
                values = v.to(dtype) * scales[1][..., None].to(dtype)
            else:
                keys, values = k, v
            idx = torch.arange(C, device="cuda")
            mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :]
            rec = {"label": label, "kernel": "decode_attention", "mix": mix,
                   "cache": name, "positions": list(positions),
                   **three(call),
                   "library": two(lambda: sdpa(q4, keys, values,
                                               attn_mask=mask,
                                               enable_gqa=True))}
            if split:
                ntiles = -(-C // attention.DECODE_TILE)
                rec["tiles_per_split"], rec["splits"] = (
                    attention.decode_split_plan(S, Hkv, C, sms, kv))
                rec["single_walk"] = three(lambda: call(split_tiles=ntiles))
                rec["split_spun_ms"] = {
                    st: chip_smoke.time_ms(lambda: call(split_tiles=st),
                                           spin_cycles=SPIN_CYCLES)
                    for st in SPLIT_TILES}
            print("attn_timing " + json.dumps(rec), flush=True)
            del q, k, v, pos, scales, keys, values
            torch.cuda.empty_cache()


def prefill_records(attention, label: str, sms: int):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Hq, Hkv, hd = 32, 8, 128
    for seed, T in enumerate(PREFILL_T, start=21):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = [torch.randn(shp, generator=g, device="cuda")
                   .to(torch.bfloat16)
                   for shp in ((T, Hq, hd), (Hkv, T, hd), (Hkv, T, hd))]
        q4, k4, v4 = q.transpose(0, 1)[None], k[None], v[None]
        rec = {"label": label, "kernel": "prefill_attention", "T": T,
               "dtype": "bfloat16",
               **three(lambda: attention.prefill_attention(q, k, v, T),
                       iters=10),
               "library": two(lambda: sdpa(q4, k4, v4, is_causal=True,
                                           enable_gqa=True), iters=10)}
        if hasattr(attention, "prefill_block_rows"):
            rec["block_rows"] = attention.prefill_block_rows(T, Hq, Hkv, sms)
            rec["rows_spun_ms"] = {
                rows: chip_smoke.time_ms(
                    lambda: attention.prefill_attention(q, k, v, T,
                                                        block_rows=rows),
                    iters=10, spin_cycles=SPIN_CYCLES)
                for rows in attention.PREFILL_ROWS}
        print("attn_timing " + json.dumps(rec), flush=True)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True,
                    help="name of the checkout in every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_timing: no CUDA device visible", file=sys.stderr)
        return 1
    from localai_tpu_torch.ops import attention

    card = chip_smoke.nvidia_smi_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"attn_timing {args.label}: {card}; package {attention.__file__}; "
          f"K2 split walk {hasattr(attention, 'decode_split_plan')}",
          flush=True)
    decode_records(attention, args.label, sms)
    prefill_records(attention, args.label, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
