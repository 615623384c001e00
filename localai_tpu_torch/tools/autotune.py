"""Per-shape paged-attention autotuner (ops.tuning's writer).

Port of ``tools/autotune.py``. Sweeps the paged decode attention dispatch
over its tuning axes — kernel impl (K1, the hand-written CUDA kernel, as
"pallas"; its plain PyTorch version as "xla", the names the JAX package's
table uses), pool ``block_tokens``, and ``num_buffers`` (the TPU kernel's
DMA depth: swept and saved as the JAX package does, no effect on K1) —
on real timings at the shapes a model family serves, and persists the
winner per ``(head_dim, kv_heads, kv_dtype, tp)`` key to the tuning table
(``LOCALAI_TUNE_CACHE`` / ``--out``). The runner then picks the tuned
block size automatically, each lookup leaving a ``localai_autotune_*``
metric receipt.

On the card, each point's ``n`` calls are captured in one CUDA graph and
the graph's replays are timed with CUDA events (best of ``reps``), so
the time is the device's work and not the host's enqueue rate. K/V is
warm in L2 (a point's pool fits in it). A kernel point is skipped only
where the kernel's gate refuses its block (``ops.paged_gate``); any other
failure of the kernel raises, and so does a key left with no kernel
point. The fastest K1 point of a key is installed, unless the default
block's K1 point is within the spread of the two points' repeated runs:
then the default block is installed. ``num_buffers`` has no effect on
K1, so the card measures each kernel block once, at the first
``--buffers`` value, which the table saves. On the CPU there is no
kernel to time: kernel points print an error record naming the missing
card, as the JAX sweep prints a failed point, and the fastest plain
point is installed. The port has no kernel interpreter: ``--interpret``
is accepted and says so.

Tensor-parallel keys (``--tp``) are measured at the per-device local
shapes (heads/tp), as the JAX package measures them.

Usage:
    python -m localai_tpu_torch.tools.autotune       # 1b + 8b shapes
    python -m localai_tpu_torch.tools.autotune --preset llama3-8b \\
        --kv-dtypes bfloat16,int8,int4 --out tuning.json
    python -m localai_tpu_torch.tools.autotune --smoke   # the CI sweep

Output: one JSON line per measured point plus a final summary line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# the shapes worth tuning out of the box: the bench/serving presets
PRESET_SHAPES = {
    "tiny": (16, 2),          # debug:tiny (tests, CI smoke)
    "small": (32, 4),
    "1b": (64, 8),            # debug:1b
    "llama3-8b": (128, 8),    # the north-star dims
}

KERNEL_IMPL = "pallas"        # the table's name for the kernel point
PLAIN_IMPL = "xla"            # and for the plain version's


def _timeit(fn, *, n: int = 10, warmup: int = 2, reps: int = 3,
            cuda: bool) -> list[float]:
    """Seconds per call of ``fn``, once for each of ``reps`` runs of ``n``
    calls. On the card the ``n`` calls are captured once in a CUDA graph
    and each run times one replay with CUDA events; on the CPU each run
    reads the host's clock."""
    if cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        runs = []
        for _ in range(reps):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 1e3 / n)
        return runs
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n)
    return runs


def point_inputs(head_dim: int, kv_heads: int, kv_dtype: str, *,
                 block_tokens: int, group: int = 4, slots: int = 4,
                 ctx: int = 512, device="cpu") -> dict:
    """The inputs of one measured point, drawn as the JAX package draws
    them (``np.random.default_rng(0)``, the same order and shapes): q
    [slots, H, hd], a K/V pool of ``slots * ceil(ctx / bt) + 1`` blocks
    (block 0 unmapped), tables in order, every slot at position ctx - 2.
    A float pool holds ``kv_dtype`` and q is cast to it (K1 reads a float
    pool in the compute dtype); an int8/int4 pool is quantized by the
    port's quantizers and q stays float32."""
    from localai_tpu_torch.models.quant import (
        quantize_lastdim,
        quantize_lastdim4,
    )

    rng = np.random.default_rng(0)
    bt = block_tokens
    mb = -(-ctx // bt)
    n_blocks = slots * mb + 1
    num_heads = kv_heads * group

    def draw(shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device)

    q = draw((slots, num_heads, head_dim))
    kf = draw((n_blocks, kv_heads, bt, head_dim))
    vf = draw((n_blocks, kv_heads, bt, head_dim))
    tables = torch.from_numpy(
        np.arange(1, n_blocks).reshape(slots, mb).astype(np.int32)).to(
        device)
    positions = torch.full((slots,), ctx - 2, dtype=torch.int32,
                           device=device)
    k_scale = v_scale = None
    if kv_dtype == "int8":
        kf, k_scale = quantize_lastdim(kf)
        vf, v_scale = quantize_lastdim(vf)
    elif kv_dtype == "int4":
        kf, k_scale = quantize_lastdim4(kf)
        vf, v_scale = quantize_lastdim4(vf)
    elif kv_dtype == "bfloat16":
        q = q.to(torch.bfloat16)
        kf, vf = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    elif kv_dtype != "float32":
        raise ValueError(f"unsupported kv dtype {kv_dtype!r}")
    return {"q": q, "k": kf, "v": vf, "tables": tables,
            "positions": positions, "k_scale": k_scale, "v_scale": v_scale}


def point_fn(inputs: dict, impl: str):
    """The dispatch one point times: K1 (``impl`` "pallas") or its plain
    version ("xla") on ``inputs``."""
    from localai_tpu_torch.ops.attention import (
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    args = (inputs["q"], inputs["k"], inputs["v"], inputs["tables"],
            inputs["positions"], inputs["k_scale"], inputs["v_scale"])
    if impl == KERNEL_IMPL:
        if inputs["q"].device.type != "cuda":
            raise RuntimeError("the paged decode kernel needs a CUDA card "
                               "(none visible)")
        return lambda: paged_decode_attention(*args)
    if impl == PLAIN_IMPL:
        return lambda: paged_decode_attention_ref(*args)
    raise ValueError(f"unknown impl {impl!r}")


def measure_point(head_dim: int, kv_heads: int, kv_dtype: str, *,
                  impl: str, block_tokens: int, num_buffers: int,
                  group: int = 4, slots: int = 4, ctx: int = 512,
                  interpret: bool = False, reps: int = 3,
                  device=None, runs: list | None = None) -> float:
    """Best-of-``reps`` microseconds for one paged decode attention
    dispatch at the given configuration (local, single-device shapes).
    ``num_buffers`` and ``interpret`` are the JAX package's arguments:
    K1 has a two-stage copy ring and no interpreter, so neither moves
    anything here. ``runs``, when given, receives each run's
    microseconds."""
    del num_buffers, interpret
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    with torch.no_grad():
        fn = point_fn(point_inputs(
            head_dim, kv_heads, kv_dtype, block_tokens=block_tokens,
            group=group, slots=slots, ctx=ctx, device=device), impl)
        us = [dt * 1e6 for dt in _timeit(fn, reps=reps, cuda=cuda)]
    if runs is not None:
        runs.extend(us)
    return min(us)


def _gate(head_dim: int, kv_heads: int, kv_dtype: str,
          block_tokens: int, group: int = 4) -> str:
    """``ops.paged_gate`` at a point's shape and dtypes (``point_inputs``:
    q in a float pool's dtype, float32 over a scaled pool)."""
    from localai_tpu_torch import ops

    scaled = kv_dtype in ("int8", "int4")
    pool = kv_dtype if scaled else getattr(torch, kv_dtype)
    return ops.paged_gate(
        num_heads=kv_heads * group, num_kv_heads=kv_heads,
        head_dim=head_dim, block_tokens=block_tokens, kv_dtype=pool,
        dtype=torch.float32 if scaled else pool)


def sweep(shapes, kv_dtypes, tps, *, block_candidates, buffer_candidates,
          impls, ctx: int, interpret: bool, table,
          device=None) -> list[dict]:
    """Measure every point, install the per-key winners into ``table``,
    and return the point records. A key's winner is its fastest kernel
    point, or its fastest plain point when no kernel point was measured
    (the CPU); where the default block's point of the same impl is within
    the spread of the two points' runs, the default block wins. On the
    card a kernel point fails only where the kernel's gate refuses its
    block: every other error raises, and so does a key that ends with no
    kernel point."""
    from localai_tpu_torch.engine import paged as pgd
    from localai_tpu_torch.ops import tuning

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    default_bt = pgd.block_tokens_default()
    records = []
    for hd, kv in shapes:
        for kv_dtype in kv_dtypes:
            if kv_dtype == "int4" and hd % 2:
                continue
            for tp in tps:
                if kv % tp or tp < 1:
                    continue
                key = tuning.shape_key(hd, kv, kv_dtype, tp)
                t_key = time.monotonic()
                points: dict = {}   # (is kernel, bt) -> (us, spread, nb)
                for impl in impls:
                    kernel = impl == KERNEL_IMPL
                    bufs = [2]
                    if kernel:
                        # num_buffers moves nothing on K1: the card
                        # measures one depth
                        bufs = (buffer_candidates[:1] if on_card
                                else buffer_candidates)
                    for bt in block_candidates:
                        if bt > ctx:
                            continue
                        for nb in bufs:
                            rec = {"key": key, "impl": impl,
                                   "block_tokens": bt, "num_buffers": nb}
                            why = (_gate(hd, kv // tp, kv_dtype, bt)
                                   if kernel and on_card else "")
                            if why:
                                rec["error"] = f"ValueError: {why}"[:200]
                                records.append(rec)
                                print(json.dumps(rec))
                                continue
                            runs: list = []
                            try:
                                us = measure_point(
                                    hd, kv // tp, kv_dtype, impl=impl,
                                    block_tokens=bt, num_buffers=nb,
                                    ctx=ctx, interpret=interpret,
                                    device=device, runs=runs)
                            except Exception as e:  # noqa: BLE001
                                if on_card:
                                    raise
                                rec["error"] = f"{type(e).__name__}: {e}"[
                                    :200]
                                records.append(rec)
                                print(json.dumps(rec))
                                continue
                            spread = max(runs) - min(runs) if runs else 0.0
                            rec["us"] = round(us, 1)
                            rec["spread_us"] = round(spread, 1)
                            records.append(rec)
                            print(json.dumps(rec))
                            if (kernel, bt) not in points \
                                    or us < points[(kernel, bt)][0]:
                                points[(kernel, bt)] = (us, spread, nb)
                has_kernel = any(k for k, _ in points)
                if on_card and KERNEL_IMPL in impls and not has_kernel:
                    raise RuntimeError(f"{key}: no kernel point ran "
                                       f"(blocks {block_candidates})")
                if not points:
                    continue
                mine = {bt: p for (k, bt), p in points.items()
                        if k == has_kernel}
                bt = min(mine, key=lambda b: mine[b][0])
                us, spread, nb = mine[bt]
                if default_bt in mine and bt != default_bt:
                    d_us, d_spread, d_nb = mine[default_bt]
                    if us >= d_us - max(spread, d_spread):
                        print(json.dumps({
                            "key": key, "fastest_block_tokens": bt,
                            "note": "within the spread of the default "
                                    f"block {default_bt}: default kept"}))
                        bt, us, nb = default_bt, d_us, d_nb
                table.put(key, tuning.TuneEntry(
                    impl=KERNEL_IMPL if has_kernel else PLAIN_IMPL,
                    block_tokens=bt, num_buffers=nb, us=round(us, 1)))
                _note_sweep(key, time.monotonic() - t_key)
    return records


def _note_sweep(key: str, seconds: float) -> None:
    try:
        from localai_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.autotune_sweep_seconds.set(seconds, key=key)
    except Exception:  # noqa: BLE001
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", action="append", default=[],
                    choices=sorted(PRESET_SHAPES),
                    help="model shape preset(s) to tune (default: 1b + "
                         "llama3-8b; repeatable)")
    ap.add_argument("--kv-dtypes", default="bfloat16,int8,int4",
                    help="comma list of KV dtypes to tune")
    ap.add_argument("--tp", default="1",
                    help="comma list of tensor-parallel widths to key")
    ap.add_argument("--blocks", default="16,32,64,128",
                    help="block_tokens candidates")
    ap.add_argument("--buffers", default="2,3",
                    help="num_buffers candidates (kernel points only; the "
                         "TPU kernel's DMA depth, saved and without effect "
                         "on the card, which measures the first only)")
    ap.add_argument("--ctx", type=int, default=512,
                    help="context rows per measured slot")
    ap.add_argument("--interpret", action="store_true",
                    help="include kernel points off the card (the port "
                         "has no interpreter: they fail, naming the card)")
    ap.add_argument("--out", default="",
                    help="table path (default LOCALAI_TUNE_CACHE)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI sweep: tiny shape, float32+int4, "
                         "tp 1+2, blocks 8/16, kernel points included")
    args = ap.parse_args(argv)

    from localai_tpu_torch.ops import tuning

    if args.smoke:
        shapes = [PRESET_SHAPES["tiny"]]
        kv_dtypes = ["float32", "int4"]
        tps = [1, 2]
        blocks = [8, 16]
        buffers = [2, 3]
        args.interpret = True
        ctx = 64
    else:
        presets = args.preset or ["1b", "llama3-8b"]
        shapes = [PRESET_SHAPES[p] for p in presets]
        kv_dtypes = [d for d in args.kv_dtypes.split(",") if d]
        tps = [int(t) for t in args.tp.split(",") if t]
        blocks = [int(b) for b in args.blocks.split(",") if b]
        buffers = [int(b) for b in args.buffers.split(",") if b]
        ctx = args.ctx

    on_card = torch.cuda.is_available()
    if args.interpret:
        print(json.dumps({"note": "--interpret: the port has no kernel "
                                  "interpreter; kernel points run on a "
                                  "CUDA card only"}))
    impls = [PLAIN_IMPL]
    if on_card or args.interpret:
        impls.append(KERNEL_IMPL)

    path = args.out or tuning.cache_path()
    table = tuning.TuningTable.load(path)
    t0 = time.monotonic()
    records = sweep(shapes, kv_dtypes, tps, block_candidates=blocks,
                    buffer_candidates=buffers, impls=impls, ctx=ctx,
                    interpret=False, table=table,
                    device="cuda" if on_card else "cpu")
    if not path:
        print(json.dumps({"error": "no table path (LOCALAI_TUNE_CACHE=0 "
                                   "and no --out)"}))
        return 1
    saved = table.save(path)
    tuning.reset()  # a fresh lookup sees the new entries
    print(json.dumps({
        "table": saved,
        "entries": len(table.entries),
        "points_measured": sum(1 for r in records if "us" in r),
        "points_failed": sum(1 for r in records if "error" in r),
        "backend": "cuda" if on_card else "cpu",
        "interpret": False,
        "sweep_s": round(time.monotonic() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
