"""Device resolution shared by every entry point of the port.

The port runs on the card by default. A caller that wants the CPU says so
(``device="cpu"``) — the tests do; nothing moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Any

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
    numpy arrays) across to torch tensors on ``device``, each in its own
    dtype (bfloat16 arrives as ``ml_dtypes.bfloat16`` and goes across as
    its int16 bit pattern)."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [conv(v) for v in a]
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return conv(tree)
