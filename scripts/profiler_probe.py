"""Whether a process's first ``obs.profiler.torch_capture`` records the
card's kernels: a thread launches matmuls without pause while captures
run one after another on a second thread, as the ``/backend/trace``
route runs them; prints the kernel events of each capture. ``warm`` puts
a 0.2 s capture first. Each run is a fresh process:

    for i in 1 2 3; do PYTHONPATH=. python3 scripts/profiler_probe.py; done
    PYTHONPATH=. python3 scripts/profiler_probe.py warm
"""

import json
import sys
import tempfile
import threading

import torch

from localai_tpu_torch.obs.profiler import torch_capture


def main() -> None:
    warm = sys.argv[1:] == ["warm"]
    x = torch.randn(2048, 2048, device="cuda")
    for _ in range(10):
        x = x @ x / 2048
    torch.cuda.synchronize()
    stop = threading.Event()

    def engine():
        y = torch.randn(1024, 1024, device="cuda")
        while not stop.is_set():
            y = (y @ y) / 1024
            torch.cuda.synchronize()

    counts = []

    def capture(seconds):
        out = torch_capture(tempfile.mkdtemp(), seconds)
        with open(out) as f:
            events = json.load(f)["traceEvents"]
        counts.append(sum(1 for e in events if e.get("cat") == "kernel"))

    th = threading.Thread(target=engine)
    th.start()
    for seconds in ((0.2, 2.0, 2.0) if warm else (2.0, 2.0)):
        t = threading.Thread(target=capture, args=(seconds,))
        t.start()
        t.join()
    stop.set()
    th.join()
    print(json.dumps({"warm": warm, "kernel_counts": counts}), flush=True)


if __name__ == "__main__":
    main()
