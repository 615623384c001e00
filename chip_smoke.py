"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the port's CUDA kernels from ``localai_tpu_torch/csrc`` (nvcc,
     sm_90a) and print the build time and the ptxas report;
  3. kernel: the paged decode attention kernel against its plain PyTorch
     version at the serving shapes (S=8, Hq=32, Hkv=8, hd=128, bt=64,
     ragged positions up to 4096, shuffled block tables) in bf16 and f32,
     plus a sliding-window and an hd=64 case; times for the kernel, the
     plain version and one library call (scaled_dot_product_attention over
     K/V gathered beforehand — a yardstick only), and the byte bound;
  4. parity: the port's runner on the card and on the CPU give identical
     greedy tokens (debug:small, float32);
  5. serving: the port's HTTP server serves debug:llama3-8b (Llama-3-8B
     widths and depth, random weights from a seed) in bf16 with the paged
     bf16 pool, and answers concurrent chat completions, one streaming;
     the kernel's launch count must cover every layer of every decode step.
The line before last is the card's nvidia-smi name and power limit, the
line before it the kernels' JSON record; the last line is the result.
``--profile`` adds a decode-step breakdown (torch.profiler) at the
serving shape after phase 5.
Exits non-zero without a result when no CUDA device is visible.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# float32: absolute; bfloat16: per slot, relative to that slot's largest
# output (the output's bf16 rounding is at most 2**-8 of it), so a
# long-context slot, whose outputs are small, is held as tightly as a
# short one
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
L2_FLUSH_BYTES = 128 << 20          # > the 50 MB L2: every timed launch
                                    # finds K/V cold, as a decode layer does


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, timed with CUDA events."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def kernel_case(name, dtype, *, S=8, Hq=32, Hkv=8, hd=128, bt=64, MB=64,
                positions=(4095, 3001, 2048, 2047, 1000, 640, 64, 63),
                window=None, seed=0, timed=False):
    from localai_tpu_torch.ops.attention import (
        gather_blocks,
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    N = S * MB + 1
    dev = "cuda"
    q = torch.randn((S, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((N, Hkv, bt, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((N, Hkv, bt, hd), generator=g, device=dev).to(dtype)
    # shuffled physical blocks: block 0 (trash) never mapped
    tables = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
        torch.int32).reshape(S, MB)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    out = paged_decode_attention(q, k, v, tables, pos, sliding_window=window)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q.float(), k.float(), v.float(), tables,
                                     pos, sliding_window=window)
    slot_err = (out.float() - ref).abs().flatten(1).amax(1)
    if dtype == torch.bfloat16:
        slot_tol = TOL[dtype] * ref.abs().flatten(1).amax(1)
    else:
        slot_tol = torch.full_like(slot_err, TOL[dtype])
    err = slot_err.max().item()
    ok = bool((slot_err <= slot_tol).all())
    rec = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd, "bt": bt, "MB": MB,
           "window": window, "max_abs_err": err,
           "slot_err": slot_err.tolist(), "slot_tol": slot_tol.tolist()}
    if timed:
        # bytes each call must move: the live K/V blocks of every slot
        # (from the window's first block to the one holding pos), q, out,
        # the tables and positions; operations: 2 products of 2 flops
        elem = q.element_size()
        live = 0
        for p in positions:
            nb = min(p // bt + 1, MB)
            lo = max((p - window + 1) // bt, 0) if window else 0
            live += (nb - lo) * bt
        nbytes = (2 * live * Hkv * hd * elem + 2 * S * Hq * hd * elem
                  + S * MB * 4 + S * 4)
        flops = 4 * live * Hq * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        keys = gather_blocks(k, tables)
        values = gather_blocks(v, tables)
        idx = torch.arange(MB * bt, device=dev)
        keep = (idx[None, :] <= pos[:, None].long())
        if window:
            keep &= idx[None, :] > pos[:, None].long() - window
        q4 = q[:, :, None, :]
        mask = keep[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            sdpa(q4, keys, values, attn_mask=mask, enable_gqa=True)
            kv_lib, gqa = (keys, values), {"enable_gqa": True}
        except TypeError:  # torch < 2.5: heads expanded beforehand
            kv_lib = (keys.repeat_interleave(Hq // Hkv, dim=1),
                      values.repeat_interleave(Hq // Hkv, dim=1))
            gqa = {}

        def library():
            return sdpa(q4, *kv_lib, attn_mask=mask, **gqa)

        rec.update(
            ms=time_ms(lambda: paged_decode_attention(
                q, k, v, tables, pos, sliding_window=window)),
            plain_ms=time_ms(lambda: paged_decode_attention_ref(
                q, k, v, tables, pos, sliding_window=window)),
            library_ms=time_ms(library),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops)
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {name}: per-slot errors "
                             f"{slot_err.tolist()} exceed "
                             f"{slot_tol.tolist()}")
    return rec


def phase_kernel() -> dict:
    main = kernel_case("main-bf16", torch.bfloat16, timed=True)
    kernel_case("main-f32", torch.float32, timed=True)
    kernel_case("window-bf16", torch.bfloat16, window=700, seed=1)
    kernel_case("hd64-bf16", torch.bfloat16, Hq=16, Hkv=4, hd=64, seed=2)
    kernel_case("hd64-f32-g8", torch.float32, Hq=32, Hkv=4, hd=64, seed=3)
    return main


def phase_parity() -> None:
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.registry import resolve_model

    model = resolve_model("debug:small", dtype="float32", device="cpu")
    prompts = [list(b"The paged kernel walks each block table"), list(b"hi")]
    seqs = {}
    for dev in ("cuda", "cpu"):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in model.params.items()}
        r = ModelRunner(model.cfg, params, num_slots=4, max_ctx=256,
                        kv_dtype="float32", kv_block_tokens=16,
                        prefill_chunk=32, device=dev)
        out = []
        slots = []
        for p in prompts:
            s = r.acquire_slot()
            out.append([r.admit(s, p, temperature=0.0)])
            slots.append(s)
        for _ in range(16):
            toks = r.step()
            for o, s in zip(out, slots):
                o.append(int(toks[s]))
        seqs[dev] = out
        print(f"parity {dev} ({r.paged_attn_impl}): {out}", flush=True)
    if seqs["cuda"] != seqs["cpu"]:
        raise AssertionError("greedy tokens differ between cuda and cpu")


def _post(url: str, body: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def phase_serve(card: str):
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.ops.attention import paged_decode_attention

    name = "llama3-8b"
    mcfg = ModelConfig.from_dict({
        "name": name, "model": "debug:llama3-8b", "context_size": 4096,
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 8, "kv_block_tokens": 64, "spec": False},
    })
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    manager = ModelManager(AppConfig(device="cuda"), loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    try:
        t0 = time.monotonic()
        sm = manager.get(name)
        torch.cuda.synchronize()
        print(f"serve: loaded {name} (L={sm.runner.cfg.num_layers}, "
              f"D={sm.runner.cfg.hidden_size}) in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        chat = server.url + "/v1/chat/completions"
        prompts = ["Write a haiku about paged attention.",
                   "What is the capital of France?",
                   "List three prime numbers.",
                   "Explain continuous batching in one sentence.",
                   "Say hello."]

        def body(i, stream=False):
            return {"model": name, "max_tokens": 32, "temperature": 0,
                    "stream": stream,
                    "messages": [{"role": "user", "content": prompts[i]}]}

        # warm-up request (first-call allocations), not counted
        json.loads(_post(chat, body(4)).read())
        torch.cuda.reset_peak_memory_stats()
        results: dict = {}
        errors: list = []

        def plain(i):
            try:
                results[i] = json.loads(_post(chat, body(i)).read())
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        def streamed(i):
            try:
                t = time.monotonic()
                ttft, text, last = None, "", None
                with _post(chat, body(i, stream=True)) as r:
                    for line in r:
                        line = line.strip()
                        if not line.startswith(b"data: {"):
                            continue
                        frame = json.loads(line[6:])
                        delta = frame["choices"][0]["delta"].get("content")
                        if delta and ttft is None:
                            ttft = time.monotonic() - t
                        text += delta or ""
                        last = frame
                results[i] = {"text": text, "ttft_s": ttft, "last": last}
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        paged_decode_attention.launches = 0
        steps0 = sm.runner.decode_steps
        t0 = time.monotonic()
        threads = [threading.Thread(target=plain, args=(i,))
                   for i in range(4)]
        threads.append(threading.Thread(target=streamed, args=(4,)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        launches = paged_decode_attention.launches
        steps = sm.runner.decode_steps - steps0
        if errors:
            raise errors[0]
        ntok = 0
        for i in range(4):
            u = results[i]["usage"]["completion_tokens"]
            if u <= 0:
                raise AssertionError(f"request {i} returned no tokens")
            ntok += u
        su = results[4]["last"]["usage"]["completion_tokens"]
        if su <= 0:
            raise AssertionError("the streaming request returned no tokens")
        ntok += su
        L = sm.runner.cfg.num_layers
        if steps <= 0 or launches < L * steps:
            raise AssertionError(
                f"kernel launches {launches} < {L} layers x {steps} steps")
        again = json.loads(_post(chat, body(0)).read())
        if (again["choices"][0]["message"]["content"]
                != results[0]["choices"][0]["message"]["content"]):
            raise AssertionError("repeating request 0 changed its text")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "localai_tpu")]
        if bad:
            raise AssertionError(f"JAX-side modules imported: {bad[:5]}")
        print("serve: " + json.dumps({
            "card": card, "model": name, "requests": 5, "streaming": 1,
            "completion_tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall, "ttft_stream_s": results[4]["ttft_s"],
            "decode_steps": steps, "kernel_launches": launches,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
        }), flush=True)
        return launches, sm
    finally:
        server.shutdown()


def phase_profile(sm, ctx_tokens: int = 1024, steps: int = 16) -> None:
    """Where a decode step's time goes at the serving shape: every slot
    holds a ``ctx_tokens`` prompt, then ``steps`` decode steps run once
    plain (wall clock) and once under torch.profiler (device time by
    kernel). Run with ``--profile``; not part of the default smoke."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = sm.runner
    g = torch.Generator().manual_seed(0)
    for _ in range(r.num_slots):
        prompt = torch.randint(0, 256, (ctx_tokens,), generator=g).tolist()
        r.admit(r.acquire_slot(), prompt, temperature=0.0,
                reserve_tokens=ctx_tokens + 4 * steps)
    r.step_n(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.step_n(steps)
    wall_plain = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step_n(steps)
        wall_prof = (time.perf_counter() - t0) / steps
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps
    busy = sum(kernels.values())

    def share(*subs):
        return sum(v for k, v in kernels.items()
                   if any(x in k.lower() for x in subs))

    attn = share("paged_decode_kernel")
    gemm = share("gemm", "nvjet", "xmma", "cutlass", "cublas")
    print("profile: " + json.dumps({
        "ctx_tokens": ctx_tokens, "slots": r.num_slots, "steps": steps,
        "wall_ms_per_step": wall_plain * 1e3,
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy,
        # device busy time is taken under the profiler; against the
        # profiled wall it counts the profiler's own host cost as idle
        "device_idle_share_vs_profiled_wall": max(
            0.0, 1 - busy / (wall_prof * 1e3)),
        "device_idle_share_vs_plain_wall": max(
            0.0, 1 - busy / (wall_plain * 1e3)),
        "attention_kernel_ms_per_step": attn,
        "gemm_ms_per_step": gemm,
        "other_ms_per_step": busy - attn - gemm,
        "launches_per_step": sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / steps,
    }), flush=True)
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile kernel: {v:9.4f} ms/step  {k[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from localai_tpu_torch.ops import _build

    card = nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t0 = time.monotonic()
    _build.build_all()
    print(f"build: {time.monotonic() - t0:.1f}s", flush=True)
    for line in _build.build_log("paged_decode_attention").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    main_case = phase_kernel()
    phase_parity()
    launches, sm = phase_serve(card)
    if "--profile" in sys.argv[1:]:
        phase_profile(sm)
    k1 = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "localai_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "localai_tpu/ops/attention.py:458",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
