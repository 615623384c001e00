"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled by
``nvcc`` straight into a shared library that ``ctypes`` loads — a few
seconds per source, against minutes for an extension that includes
PyTorch's headers. Libraries land in ``build/localai_tpu_torch/`` at the
repository root (``LOCALAI_TORCH_BUILD_DIR`` overrides), named by a hash
of the source and flags, so an edited source rebuilds and an unchanged
one is reused. Building happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("paged_decode_attention",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("LOCALAI_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "localai_tpu_torch"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                     / "bin" / "nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, tmp path, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source not built yet, one nvcc per source, all
    started together. Raises with the compiler's output on failure."""
    started = {n: _start(n) for n in names}
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            continue
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc={rc}):\n"
                               + out.with_suffix(".log").read_text())
        os.replace(tmp, out)
    return {n: started[n][2] for n in names}


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) from
    the build of ``name``, or "" when it was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
