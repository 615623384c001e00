"""Server-sent event frames and the first-write mark of a streamed answer.

Port of ``localai_tpu/api/streams.py``. The JAX package's
``aiter_handle`` (an asyncio bridge from the engine thread's handle to an
aiohttp handler) has no counterpart here: the port's server gives every
connection a thread of its own, and a handler's generator iterates the
``GenHandle`` directly on it.
"""

from __future__ import annotations

import json
from typing import Any

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(payload: Any) -> bytes:
    """One ``data: {json}`` SSE frame."""
    return b"data: " + json.dumps(
        payload, separators=(",", ":"), ensure_ascii=False
    ).encode("utf-8") + b"\n\n"


def mark_first_write(handle) -> None:
    """Record ``first_sse_write`` on the request's trace once its first
    content frame was written: the TTFT a client sees (the engine's first
    token plus the queue and the write). Writers call it after every
    content frame; only the first call records."""
    tr = getattr(handle, "trace", None)
    if tr is None or getattr(handle, "_first_write_marked", False):
        return
    handle._first_write_marked = True
    tr.event("first_sse_write")
