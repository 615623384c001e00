"""Device resolution shared by every entry point of the port.

The port runs on the card by default. A caller that wants the CPU says so
(``device="cpu"``) — the tests do; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. Raises when
    the card is asked for and none is visible."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Carry a parameter tree of the JAX package (nested dicts and lists of
    numpy arrays; None kept) across to torch tensors on ``device``, each in
    its own dtype (bfloat16 arrives as ``ml_dtypes.bfloat16`` and goes
    across as its int16 bit pattern)."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [conv(v) for v in a]
        if a is None:
            return None
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return conv(tree)


_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved: tuple = ()


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Float32 convs and matmuls in full float32 on the card for the
    duration: cuDNN's TF32 (on by default) and cuBLAS's are turned off,
    and restored when the last of any concurrent holders leaves (a count,
    so two requests on two threads cannot restore under each other). The
    audio models are float32 in the JAX package, where a float32 product
    is a float32 product. The flags are process-wide: a float32 product
    of another model that runs meanwhile is exact too."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _f32_saved
