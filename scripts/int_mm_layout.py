"""The shape and layout rules of ``torch._int_mm`` on one NVIDIA card.

The int8_w8a8 product (``localai_tpu_torch/models/quant.py::int8_matmul``)
takes ``torch._int_mm``. This script records, for Llama-3-8B's
projections and lm_head, which row counts it takes (it refuses 16 rows
or fewer on CUDA, so decode's rows are padded) and the time of the same
int8 weight stored row-major ([K, N] contiguous) and column-major ([N, K]
contiguous, passed transposed: the port's storage), under chip_smoke.py's
timer (L2 flushed, CUDA events, the median of 30 launches). Every product
is checked against the exact float64 product. Then, for an lm_head of
32001 ids (N off a multiple of 8), the parts of ``int8_matmul``'s padded
product (the 32000 aligned columns as a view, the zero-padded 8-column
tail) beside one product on a weight padded to 32008 columns, each timed
as above and again with the host's enqueueing kept out
(``spin_cycles``). From the root of a checkout:

    PYTHONPATH=. python3 scripts/int_mm_layout.py

Prints one ``int_mm`` JSON line a case and one ``int_mm vocab`` line a
row count, the card's nvidia-smi name and power limit first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ROWS = (8, 16, 17, 40, 256)


def main() -> int:
    if not torch.cuda.is_available():
        print("int_mm_layout: no CUDA device visible", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, ((K, N), _) in chip_smoke.SHAPES_8B.items():
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        layouts = {"row_major": w, "column_major": w.t().contiguous().t()}
        for M in ROWS:
            x = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                              dtype=torch.int8)
            want = (x.double() @ w.double()).to(torch.int32)
            rec = {"card": card, "shape": label, "M": M, "K": K, "N": N}
            for name, mat in layouts.items():
                try:
                    got = torch._int_mm(x, mat)
                except RuntimeError as e:
                    rec[name] = f"refused: {str(e).splitlines()[0][:80]}"
                    continue
                if not torch.equal(got, want):
                    raise AssertionError(f"{label} M={M} {name}: not exact")
                rec[f"{name}_ms"] = chip_smoke.time_ms(
                    lambda: torch._int_mm(x, mat))
            print("int_mm " + json.dumps(rec), flush=True)
        del w, layouts
    vocab(card, g)
    return 0


def vocab(card: str, g: torch.Generator, K: int = 4096,
          N: int = 32001) -> None:
    """The padded product of a [K, N] column-major lm_head, N off 8."""
    from localai_tpu_torch.models import quant as tq

    w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int8).t().contiguous().t()
    n_al = N - N % 8
    padded = torch.zeros(N + (-N % 8), K, dtype=torch.int8,
                         device="cuda").t()
    padded[:, :N] = w
    for M in ROWS:
        x = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                          dtype=torch.int8)
        x17 = torch.cat([x, x.new_zeros(max(0, 17 - M), K)])
        want = (x.double() @ w.double()).to(torch.int32)
        if not torch.equal(tq.int8_matmul(x, w), want):
            raise AssertionError(f"vocab M={M}: not exact")
        tail = w.new_zeros(8, K).t()
        tail[:, :N - n_al] = w[:, n_al:]
        parts = {"int8_matmul": lambda: tq.int8_matmul(x, w),
                 "aligned_view": lambda: torch._int_mm(x17, w[:, :n_al]),
                 "tail": lambda: torch._int_mm(x17, tail),
                 "padded_weight": lambda: torch._int_mm(x17, padded)}
        rec = {"card": card, "M": M, "K": K, "N": N}
        for name, fn in parts.items():
            rec[f"{name}_ms"] = chip_smoke.time_ms(fn)
            rec[f"{name}_device_ms"] = chip_smoke.time_ms(
                fn, spin_cycles=2_000_000)
        print("int_mm vocab " + json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
