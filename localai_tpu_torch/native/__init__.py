"""Native (C) host helpers, built at first use.

Port of ``localai_tpu/native/__init__.py``. A module here is compiled by
the system C compiler (``cc -O3 -fPIC -shared``) the first time it is
asked for, into the repository's ``build/localai_tpu_torch/`` beside the
CUDA kernels (``LOCALAI_TORCH_BUILD_DIR`` overrides), named by a hash of
its source, and loaded with ``ctypes``. Every caller keeps a plain Python
version, so a machine without a compiler serves through it, with one
warning logged.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).resolve().parent
_lock = threading.Lock()
_cache: dict[str, Optional[ctypes.CDLL]] = {}

# ctypes signatures of each module's exported functions
_SIGNATURES = {
    "fsm_walk": {
        # trans, n_classes, byte_class, parent, edge, n_nodes, states
        "fsm_walk": [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_void_p],
        # states, leaf_of_token, token_ok, vocab, dead, row
        "fsm_mask": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p],
    },
}


def library_path(name: str) -> Path:
    from localai_tpu_torch.ops._build import build_dir

    tag = hashlib.sha256((_SRC_DIR / f"{name}.c").read_bytes()).hexdigest()
    return build_dir() / f"lib{name}-{tag[:16]}.so"


def _compile(name: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, "-O3", "-fPIC", "-shared",
                            str(_SRC_DIR / f"{name}.c"), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cc}: {e}")
            continue
        os.replace(tmp, out)
        return
    raise RuntimeError("no working C compiler (" + "; ".join(errors) + ")")


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load ``name``.c; None when it
    cannot be built or loaded — callers then take their Python path."""
    with _lock:
        if name in _cache:
            return _cache[name]
        lib: Optional[ctypes.CDLL] = None
        try:
            out = library_path(name)
            if not out.exists():
                _compile(name, out)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in _SIGNATURES.get(name, {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            log.debug("native module %s loaded from %s", name, out)
        except (OSError, RuntimeError) as e:
            log.warning("native module %s unavailable (%s); using the "
                        "Python path", name, e)
            lib = None
        _cache[name] = lib
        return lib
