"""Device resolution shared by every entry point of the port.

The port runs on the card by default. A caller that wants the CPU says so
(``device="cpu"``) — the tests do; nothing moves to the CPU on its own.
"""

from __future__ import annotations

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
