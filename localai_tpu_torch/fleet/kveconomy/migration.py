"""Live slot migration: the ticket protocol between the migration caller
and the fleet dispatch thread.

Port of ``localai_tpu/fleet/kveconomy/migration.py``. A slot's state
between dispatches is a movable unit: the full token record plus the KV
rows ``snapshot_prefix``/``load_prefix`` already round-trip whatever the
layout. Migration therefore needs no new engine machinery; it is a
choreography:

  1. the caller (operator drain, rebalancing, a failover drill) stakes a
     :class:`MigrationTicket` on the in-flight handle and asks the donor
     replica to ``migrate_out`` the request: the donor cancels its inner
     stream with the ``migrate_export`` flag set, so the engine's release
     snapshots prompt + generation KV into the replica's prefix cache, and
     packs it into prefix chunks;
  2. the donor's "cancelled" final reply unwinds the fleet dispatch pump;
     the dispatch thread sees the staked ticket, waits for the chunks,
     transfers them into the destination replica and re-dispatches a
     *continuation* request (the full token record as the prompt, the
     remaining token budget): the destination's admission resumes from
     the loaded rows, so generation continues from the exact frontier;
  3. usage is spliced afterwards (donor tokens + destination tokens), and
     every failure leg falls back to a correct full re-prefill: a
     migration can be slow, never lossy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional


class MigrationTicket:
    """One requested migration, staked on a WorkerGenHandle.

    The caller thread fills the export fields and sets ``ready``; the
    fleet dispatch thread (which owns the request lifecycle) consumes
    them. ``dest_id`` is a preference: the dispatch thread re-checks
    health and may re-route the continuation on fallback."""

    def __init__(self, dest_id: str):
        self.dest_id = dest_id
        self.ready = threading.Event()
        # donor export (filled by the caller thread through migrate_out)
        self.chunks: Optional[list] = None      # prefix-transfer payload
        self.full_tokens: Optional[list[int]] = None  # prompt + generated
        self.donor_tokens = 0                   # tokens generated pre-move
        self.error = ""                         # donor-side failure note
        # outcome (filled by the dispatch thread; tests read it)
        self.completed = threading.Event()
        self.outcome = ""                       # migrated | fallback | ...

    def fail(self, why: str) -> None:
        """The donor export failed: release the waiting dispatch thread
        with the failure recorded (it falls back from the token record)."""
        self.error = why
        self.ready.set()

    def finish(self, outcome: str) -> None:
        self.outcome = outcome
        self.completed.set()


def continuation_request(req: Any, full_tokens: list[int],
                         donor_tokens: int) -> Any:
    """The destination-side request that resumes ``req`` after
    ``donor_tokens`` generated tokens: the full token record becomes the
    prompt (its prefix KV arrives by prefix transfer, so admission resumes
    instead of prefilling) and the budget shrinks by what the donor
    already produced. Greedy decoding carries over exactly; seeded
    sampling restarts its stream at the boundary."""
    remaining = max(0, int(req.max_new_tokens or 0) - donor_tokens)
    return dataclasses.replace(
        req, prompt=list(full_tokens), max_new_tokens=remaining,
        mm_embeds=None, mm_positions=None)
