"""Token→text streaming: incremental detokenization and stop-sequence logic.

Pure-Python copy of ``localai_tpu/engine/stream.py`` (the port imports
nothing of the JAX package).

LocalAI streams byte chunks from its C++ engine and reassembles UTF-8
runes on the Go side; stop sequences are checked in the C++ slot loop.
Here both live on the host next to the scheduler: tokens come
off the device as ids, text deltas are produced incrementally (never
re-decoding the whole sequence), and stop strings are enforced with holdback
so a stop sequence split across token boundaries is never emitted.
"""

from __future__ import annotations

from typing import Optional, Sequence


class IncrementalDetokenizer:
    """Produces text deltas from a growing token-id sequence.

    Uses the prefix-window algorithm (decode a sliding window, emit the
    difference) so BPE merge artifacts and multi-token UTF-8 characters are
    handled: a delta is only emitted once it no longer ends in a replacement
    character from an incomplete byte sequence.
    """

    def __init__(self, decode_fn, window: int = 8):
        self._decode = decode_fn
        self._ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0
        self._window = window

    @property
    def ids(self) -> list[int]:
        return self._ids

    def push(self, token_id: int) -> str:
        """Add one token; return the new text delta ('' if incomplete)."""
        self._ids.append(token_id)
        prefix = self._decode(self._ids[self._prefix_offset:self._read_offset])
        full = self._decode(self._ids[self._prefix_offset:])
        if full.endswith("�"):
            # incomplete UTF-8 sequence — wait for more tokens
            return ""
        if len(full) <= len(prefix) or not full.startswith(prefix):
            # tokenizer rewrote the window (BPE merge); emit nothing yet
            if len(self._ids) - self._prefix_offset > 4 * self._window:
                # safety: advance the window to bound re-decode cost
                self._prefix_offset = max(0, len(self._ids) - self._window)
                self._read_offset = len(self._ids)
            return ""
        delta = full[len(prefix):]
        self._read_offset = len(self._ids)
        if self._read_offset - self._prefix_offset > self._window:
            self._prefix_offset = self._read_offset - self._window
        return delta


class StopChecker:
    """Emits safe text, holding back any suffix that could begin a stop
    sequence; reports a hit with the stop text trimmed."""

    def __init__(self, stops: Sequence[str]):
        self._stops = [s for s in stops if s]
        self._holdback = max((len(s) for s in self._stops), default=1) - 1
        self._pending = ""
        self.stopped: Optional[str] = None

    def push(self, delta: str) -> str:
        """Feed a delta; return text that is safe to emit now."""
        if self.stopped is not None or not delta:
            return ""
        self._pending += delta
        for s in self._stops:
            idx = self._pending.find(s)
            if idx >= 0:
                self.stopped = s
                out, self._pending = self._pending[:idx], ""
                return out
        if not self._stops or self._holdback == 0:
            out, self._pending = self._pending, ""
            return out
        # hold back the longest suffix that is a prefix of any stop string
        keep = 0
        for k in range(min(self._holdback, len(self._pending)), 0, -1):
            tail = self._pending[-k:]
            if any(s.startswith(tail) for s in self._stops):
                keep = k
                break
        if keep:
            out, self._pending = self._pending[:-keep], self._pending[-keep:]
        else:
            out, self._pending = self._pending, ""
        return out

    def flush(self) -> str:
        """Return any held-back text at end of generation (no stop hit)."""
        out, self._pending = self._pending, ""
        return out if self.stopped is None else ""
