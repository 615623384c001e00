"""Quantized serving of the port on one NVIDIA card, for A/B runs.

Runs chip_smoke.py's int8 and int4 serving phases (debug:llama3-8b, five
greedy chats, one streamed; then the ``--profile`` decode-step breakdown)
for whichever port package is on the import path, so that one script
serves two checkouts alike. From the root of a checkout:

    PYTHONPATH=. python3 scripts/quant_serve.py --label change
    PYTHONPATH=<other checkout> python3 scripts/quant_serve.py --label parent

Each phase prints chip_smoke.py's ``serve:`` and ``profile:`` lines, then
one ``quant_serve`` JSON line with the label, tokens/s, streamed TTFT, the
plain wall and device-busy ms of a decode step and its idle share.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import torch

# this checkout's chip_smoke.py, by path: the checkout on PYTHONPATH may
# hold an older one
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True,
                    help="name of the checkout in every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quant_serve: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi_line()
    for quant in ("int8", "int4"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            chip_smoke.phase_serve(card, quant, profile=True)
        text = buf.getvalue()
        print(text, end="", flush=True)
        lines = {k: json.loads(line[len(k) + 2:])
                 for line in text.splitlines()
                 for k in ("serve", "profile")
                 if line.startswith(k + ": ")}
        serve, prof = lines["serve"], lines["profile"]
        print("quant_serve " + json.dumps({
            "label": args.label, "card": card, "quant": quant,
            "tokens_per_s": serve["tokens_per_s"],
            "ttft_stream_s": serve["ttft_stream_s"],
            "step_wall_ms": prof["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "idle_share": prof["device_idle_share_vs_plain_wall"],
            "qmm_ms": prof["w8_w4_kernel_ms_per_step"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
