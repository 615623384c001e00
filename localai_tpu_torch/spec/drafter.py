"""Pluggable draft-token sources for speculative decoding.

Port of ``localai_tpu/spec/drafter.py``. A :class:`Drafter` proposes
``gamma`` candidate continuation tokens a slot each window; the target
verifies the whole window with ONE batched forward
(``ModelRunner.verify_async``) and the engine lane
(:mod:`localai_tpu_torch.spec.engine`) rolls rejected tails back per
slot. Two implementations:

* :class:`NGramDrafter` — self-drafting prompt lookup: the most recent
  n-gram at each slot's frontier is searched in the slot's own
  prompt + generation history and the continuation of its previous
  occurrence becomes the draft. No second model is loaded. Host numpy,
  so proposals need the previous window drained first
  (``device_proposals`` False: the scheduler serializes spec dispatches
  for host drafters).
* :class:`ModelDrafter` — a co-located small draft model on a contiguous
  ModelRunner: gamma+1 greedy decode steps of the draft (each through
  the contiguous decode kernel) propose on the device, with no host
  round trip between the draft and the verify.

A drafter may return ``None`` from :meth:`propose` to decline a window
(no usable lookup anywhere); the engine then falls back to plain
multi-step decode for that dispatch.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Drafter(Protocol):
    """The pluggable proposal source the spec engine drives.

    Slot lifecycle mirrors the target runner's: ``admit`` seeds a slot's
    draft state after the target's prefill, ``observe`` feeds drained
    window tokens back (host drafters build history from it), ``resync``
    rebuilds a slot after non-speculative dispatches advanced the target
    without the drafter, ``release`` drops a slot, and ``reinit`` resets
    everything (the self-healing engine rebuild)."""

    name: str
    gamma: int
    # True when propose() returns device tensors computed purely from
    # device state: such drafters tolerate pipelined spec dispatches
    device_proposals: bool

    def propose(self, target_tokens, target_positions): ...
    def admit(self, slot: int, prompt: list[int], first: int,
              target_positions) -> None: ...
    def observe(self, slot: int, emitted: list[int]) -> None: ...
    def resync(self, slot: int, resident: list[int],
               target_positions) -> None: ...
    def release(self, slot: int) -> None: ...
    def reinit(self) -> None: ...
    def stats(self) -> dict: ...


class NGramDrafter:
    """Self-drafting prompt-lookup: predict each slot's continuation from
    its own token history, no draft model loaded.

    For every active slot the longest recent n-gram (``max_n`` down to
    ``min_n`` tokens, ending at the frontier) is searched backwards
    through the slot's prompt+generation history; on a hit, the ``gamma``
    tokens that followed the previous occurrence become the draft. Misses
    propose nothing for that slot (its row is a guaranteed-reject filler
    so the batched verify stays static-shape); when NO slot has a hit the
    whole window is declined and the engine decodes plainly. All state is
    host lists owned by the engine thread — zero device traffic."""

    device_proposals = False

    def __init__(self, num_slots: int, gamma: int = 4, *,
                 max_n: int = 4, min_n: int = 2,
                 max_history: int = 8192):
        # min_n defaults to 2: a 1-gram "hit" fires whenever the frontier
        # token appeared ANYWHERE in history — on non-repetitive traffic
        # that proposes (and pays a verify for) near-random drafts every
        # window; the engine's acceptance backoff is the second line of
        # defense, this keeps the first-order hit rate honest
        self.name = "ngram"
        self.num_slots = num_slots
        self.gamma = int(gamma)
        self.max_n = max(1, int(max_n))
        self.min_n = max(1, min(int(min_n), self.max_n))
        self.max_history = int(max_history)
        self._history: dict[int, list[int]] = {}
        # incremental int64 mirrors of resident records (pre-gate scans)
        self._mirror: dict[int, tuple[Optional[np.ndarray], int]] = {}
        # [S] bool: which rows of the LAST propose() were real lookup
        # hits (None before the first propose)
        self.last_hits: Optional[np.ndarray] = None
        self.lookup_hits = 0
        self.lookup_misses = 0

    # -- proposal ---------------------------------------------------------

    def _lookup(self, arr: np.ndarray) -> Optional[list[int]]:
        """Longest-suffix match over an int64 history array: the
        continuation after the most recent earlier occurrence of the
        frontier n-gram, longest n first. Candidate starts come from one
        vectorized first-token scan per n — this runs on the engine
        thread every window, so a pure-Python O(L·n) scan would be a
        TPOT tax."""
        L = len(arr)
        for n in range(self.max_n, self.min_n - 1, -1):
            if L <= n:
                continue
            pat = arr[L - n:]
            # candidate window starts (the suffix occurrence itself is
            # excluded by the :L-n bound), most recent first
            starts = np.flatnonzero(arr[:L - n] == pat[0])
            for i in starts[::-1]:
                if n == 1 or np.array_equal(arr[i:i + n], pat):
                    cont = arr[i + n:i + n + self.gamma]
                    if len(cont):
                        out = [int(x) for x in cont]
                        while len(out) < self.gamma:  # pad short tails
                            out.append(out[-1])
                        return out
        return None

    def _resident_arr(self, slot: int, r: list) -> np.ndarray:
        """Incremental int64 mirror of a resident record, so the per-
        dispatch pre-gate costs O(new tokens) instead of re-converting
        the whole Python list every engine iteration. Records are
        append-only for a request's lifetime; a shrunk length or a
        mismatched last-mirrored element (slot reuse) rebuilds. A stale
        mirror can only mis-steer the HEURISTIC (one wasted drain or one
        delayed window) — proposals are always verified against true
        device state."""
        n = len(r)
        buf, filled = self._mirror.get(slot, (None, 0))
        if (buf is None or filled > n
                or (filled and int(buf[filled - 1]) != r[filled - 1])):
            buf = np.empty(max(1024, 2 * n), np.int64)
            filled = 0
        elif n > len(buf):
            grown = np.empty(max(2 * n, 2 * len(buf)), np.int64)
            grown[:filled] = buf[:filled]
            buf = grown
        if n > filled:
            buf[filled:n] = r[filled:n]
        self._mirror[slot] = (buf, n)
        lo = max(0, n - self.max_history)
        return buf[lo:n]

    def propose(self, target_tokens, target_positions):
        """[S, gamma] i32 proposals, or None when no slot has a lookup
        hit (the engine falls back to plain decode for this dispatch).
        ``last_hits`` records which slot rows are REAL proposals — the
        rest are guaranteed-reject filler for the static-shape verify,
        and the engine excludes them from the accept-rate arithmetic.
        The device args are unused — history is the source of truth."""
        props = np.zeros((self.num_slots, self.gamma), np.int32)
        hits = np.zeros(self.num_slots, bool)
        for slot, hist in self._history.items():
            cont = self._lookup(np.asarray(hist, np.int64))
            if cont is None:
                self.lookup_misses += 1
                continue
            self.lookup_hits += 1
            props[slot] = cont
            hits[slot] = True
        self.last_hits = hits
        return props if hits.any() else None

    def has_candidate(self, residents: dict) -> bool:
        """Pre-gate for the scheduler (SpecEngine.has_candidate): run the
        lookup over the CURRENT resident records — the same data a
        resync would copy into history — via incrementally-mirrored
        arrays bounded to ``max_history`` (exactly the window propose()
        searches; a wider scan could promise hits propose cannot
        deliver, draining the pipeline for nothing every iteration)."""
        for slot, r in residents.items():
            if r and self._lookup(self._resident_arr(slot, r)) is not None:
                return True
        return False

    # -- slot lifecycle ---------------------------------------------------

    def admit(self, slot: int, prompt: list[int], first: int,
              target_positions) -> None:
        self._history[slot] = (list(prompt) + [int(first)])[-self.max_history:]

    def observe(self, slot: int, emitted: list[int]) -> None:
        hist = self._history.get(slot)
        if hist is None:
            return
        hist.extend(int(t) for t in emitted)
        if len(hist) > self.max_history:
            del hist[:len(hist) - self.max_history]

    def resync(self, slot: int, resident: list[int],
               target_positions) -> None:
        self._history[slot] = list(resident)[-self.max_history:]

    def release(self, slot: int) -> None:
        self._history.pop(slot, None)
        self._mirror.pop(slot, None)

    def reinit(self) -> None:
        self._history.clear()
        self._mirror.clear()
        self.last_hits = None

    def stats(self) -> dict:
        return {"drafter": self.name, "lookup_hits": self.lookup_hits,
                "lookup_misses": self.lookup_misses}


class ModelDrafter:
    """Draft-model proposals: gamma+1 greedy decode steps of a co-located
    small model.

    The +1 step writes the last proposal's KV so the draft cache has no
    hole when every token is accepted; its sampled token is discarded.
    The draft's frontier (next token, position) is copied from the
    TARGET's post-verify state at the start of each window. Rejected
    draft rows are garbage above the frontier, overwritten before
    anything attends to them. The draft runner is contiguous, so each
    step runs the contiguous decode kernel and each admit or resync the
    prefill kernel."""

    device_proposals = True

    def __init__(self, runner, gamma: int = 4):
        # `runner` is a contiguous ModelRunner for the draft model (same
        # vocab and slot count as the target; build_spec_engine checks)
        self.name = "model"
        self.runner = runner
        self.gamma = int(gamma)

    @torch.no_grad()
    def propose(self, target_tokens: torch.Tensor,
                target_positions: torch.Tensor) -> torch.Tensor:
        """Copy the target's frontier into the draft state, then decode
        gamma+1 greedy steps; returns [S, gamma] proposals on the
        device (the Python loop of the JAX package's scan)."""
        r = self.runner
        # device tensors, or host arrays where a follower rank replays
        r.state.tokens.copy_(torch.as_tensor(target_tokens,
                                             device=r.device))
        r.state.positions.copy_(torch.as_tensor(target_positions,
                                                device=r.device))
        toks = r._decode_n_fn(self.gamma + 1)      # [gamma+1, S]
        return toks[:self.gamma].T.contiguous()

    def _seed(self, slot: int, prompt: list[int], first: int,
              target_positions) -> None:
        """Prefill the draft with ``prompt`` and set the slot's frontier
        to the target's: ``first`` is the next token to feed (the draft's
        own first sample is discarded)."""
        r = self.runner
        r.admit(slot, list(prompt) or [0], temperature=0.0)
        r.state.tokens[slot] = int(first)
        r.state.positions[slot] = target_positions[slot]

    def admit(self, slot: int, prompt: list[int], first: int,
              target_positions) -> None:
        self._seed(slot, prompt, first, target_positions)

    def observe(self, slot: int, emitted: list[int]) -> None:
        pass  # device state is the source of truth

    def resync(self, slot: int, resident: list[int],
               target_positions) -> None:
        """Rebuild one slot's draft KV after non-speculative dispatches
        advanced the target without it. ``resident`` is the scheduler's
        prompt + generated record; its last element is the next token to
        feed."""
        self._seed(slot, resident[:-1], resident[-1], target_positions)

    def acquire_slot(self, slot: int) -> None:
        self.runner.acquire_slot(slot)

    def release(self, slot: int) -> None:
        self.runner.release(slot)

    def reinit(self) -> None:
        """Fresh draft KV and state (a rebuilt target's slots are empty)."""
        self.runner.reinit()

    def stats(self) -> dict:
        return {"drafter": self.name,
                "draft_model_layers": self.runner.cfg.num_layers}
