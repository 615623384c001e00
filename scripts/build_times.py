"""Seconds nvcc takes for each CUDA source of the package on PYTHONPATH.

All sources are started together, as ``ops._build.build_all`` starts
them, into a fresh build directory, and each one's finishing time is
printed. Run it for two checkouts in one call to compare their builds:

    PYTHONPATH=<parent checkout> python3 scripts/build_times.py parent
    PYTHONPATH=. python3 scripts/build_times.py change
"""

import os
import sys
import tempfile
import time

os.environ["LOCALAI_TORCH_BUILD_DIR"] = tempfile.mkdtemp(prefix="bt-")

from localai_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    t0 = time.monotonic()
    started = {n: _build._start(n) for n in _build.SOURCES}
    done = {}
    while len(done) < len(started):
        for n, (proc, _tmp, out) in started.items():
            if n in done or proc.poll() is None:
                continue
            done[n] = time.monotonic() - t0
            if proc.returncode:
                print(out.with_suffix(".log").read_text()[-3000:])
                return 1
        time.sleep(0.05)
    label = sys.argv[1] if len(sys.argv) > 1 else ""
    print(label, "build s:", {n: round(t, 1) for n, t in done.items()},
          "total", round(time.monotonic() - t0, 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
