"""SpecEngine: speculative decoding for the serving hot path.

Port of ``localai_tpu/spec/engine.py``. Speculative sampling (Leviathan et
al.) over the paged block pool: a
:class:`~localai_tpu_torch.spec.drafter.Drafter` proposes ``gamma``
tokens a slot, ONE batched target forward scores the whole window
(``ModelRunner.verify_async``), and the accept scan emits each slot's
accepted prefix + correction while rolling that slot's frontier back on
its own, so co-batched slots never notice a neighbour's rejection.

Paged targets write window rows through the block tables into
speculation rows reserved at admission (``begin_admit(spec_tokens=)``);
a rejected tail is a per-slot position rollback. Contiguous targets use
the same verify API over slot rows, so both KV layouts share one
speculation path (``engine.speculative.SpecDecoder`` is a shim over this
class).

The scheduler drives :meth:`step_spec_async` like multi-step decode;
each dispatch returns ``[gamma+1, S]`` token rows where SKIP (-1) marks
positions past a slot's accepted window, and ``observe_window`` folds
the drained rows into acceptance counters and the drafter's history.
The ``spec.draft`` fault site garbles every proposal (any mode but
raise) or fails the drafter mid-window (raise); :meth:`SpecEngine.reinit`
is the self-healing rebuild's hook (``supports_rebuild``)."""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Any, Optional

import numpy as np

from localai_tpu_torch.engine.runner import ModelRunner
from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.spec.drafter import Drafter, ModelDrafter, NGramDrafter

log = logging.getLogger(__name__)


def _env_num(name: str, default, cast=int):
    try:
        return cast(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SpecEngine:
    """Couples a target ModelRunner (paged or contiguous) with a Drafter.

    Implements the scheduler's engine surface (slot lifecycle + spec
    windows) by handing state operations to the target and proposal
    operations to the drafter. Every mutator runs on the scheduler's
    engine thread (or its single-owner recovery thread)."""

    # self-healing: a rebuild re-inits the target and the drafter (both
    # expose reinit())
    supports_rebuild = True

    def __init__(self, target: ModelRunner, drafter: Drafter,
                 gamma: Optional[int] = None,
                 min_accept: Optional[float] = None,
                 cooldown: Optional[int] = None):
        self.target = target
        self.drafter = drafter
        self.gamma = int(gamma if gamma is not None else drafter.gamma)
        if self.gamma != drafter.gamma:
            raise ValueError(
                f"engine gamma {self.gamma} != drafter gamma "
                f"{drafter.gamma}")
        self.num_slots = target.num_slots
        self.max_ctx = target.max_ctx
        self.cfg = target.cfg
        self.paged = bool(target.paged)
        # host drafters need the previous window drained before proposing
        self.pipeline_safe = bool(drafter.device_proposals)
        # acceptance-floor backoff: when the accept ratio over the last
        # 16 windows drops below min_accept, speculation suppresses itself
        # for `cooldown` dispatches, then probes again.
        # LOCALAI_SPEC_MIN_ACCEPT=0 disables it.
        if min_accept is None:
            min_accept = _env_num("LOCALAI_SPEC_MIN_ACCEPT", 0.1, float)
        if cooldown is None:
            cooldown = _env_num("LOCALAI_SPEC_COOLDOWN", 64)
        self.min_accept = max(0.0, float(min_accept))
        self.cooldown = max(1, int(cooldown))
        self._recent: "deque[tuple[int, int]]" = deque(maxlen=16)
        self._cooldown_left = 0
        # window counters (engine-thread writers, metrics readers)
        self.total_windows = 0          # verify dispatches
        self.total_emitted = 0          # tokens emitted across windows
        self.total_eligible = 0         # active slot-windows x (gamma+1)
        self.total_proposed = 0         # draft tokens scored
        self.total_accepted = 0         # draft tokens accepted
        self.total_declined = 0         # windows the drafter declined
        self.total_suppressed = 0       # windows skipped by the backoff
        self.last_skip_reason: Optional[str] = None
        # real-proposal row mask of the in-flight window (host drafters
        # serialize windows, so one pending mask suffices; device drafters
        # propose for every slot: None = all real)
        self._pending_hits: Optional[Any] = None

    # -- spec windows (engine thread) ------------------------------------

    def step_spec_async(self):
        """One speculative window over all slots: propose, verify, roll
        back. Returns the [gamma+1, S] emitted rows (AsyncTokens; SKIP =
        nothing for that step and slot), or None when the drafter
        declined or the backoff suppressed the window (the scheduler
        falls back to a plain dispatch)."""
        self.last_skip_reason = None
        if self.suppressed_tick():
            self.last_skip_reason = "suppressed"
            return None
        t = self.target
        props = self.drafter.propose(t.state.tokens, t.state.positions)
        if props is None:
            self.total_declined += 1
            self.last_skip_reason = "declined"
            return None
        self._pending_hits = getattr(self.drafter, "last_hits", None)
        if _faults.ACTIVE:
            spec = _faults.apply("spec.draft", key=self.drafter.name)
            if spec is not None:
                # divergent-draft chaos: every proposal replaced with
                # deterministic garbage — acceptance collapses, rollback
                # and co-batched streams must stay byte-correct
                props = self._garble(props)
        return t.verify_async(props)

    def _garble(self, props):
        """The JAX package's garbage proposals, ``(p * 31 + 17) % V``, on
        the proposals' own device and dtype."""
        V = self.target.cfg.vocab_size
        if isinstance(props, np.ndarray):
            return (props.astype(np.int64) * 31 + 17) % V
        return ((props.long() * 31 + 17) % V).to(props.dtype)

    def reinit(self) -> None:
        """Self-healing rebuild hook: the scheduler re-inits the target
        runner itself; this resets the drafter (draft KV / history) and
        the acceptance-backoff state."""
        self.drafter.reinit()
        self._recent.clear()
        self._cooldown_left = 0
        self._pending_hits = None

    def suppressed_tick(self) -> bool:
        """True while the acceptance backoff suppresses windows; each call
        consumes one cooldown tick. The scheduler calls this BEFORE any
        drain or resync, so a suppressed dispatch costs exactly a plain
        one."""
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self.total_suppressed += 1
            return True
        return False

    def has_candidate(self, residents: dict) -> bool:
        """Cheap pre-gate: could the drafter propose for any of these
        slots now? ``residents`` maps slot → its prompt + generation
        record. Device drafters always can; a host lookup drafter peeks
        at the records, and a False lets the scheduler skip the pipeline
        drain and the resync."""
        peek = getattr(self.drafter, "has_candidate", None)
        if peek is None:
            return True
        return bool(peek(residents))

    def step_spec(self) -> np.ndarray:
        """Synchronous window (tests and direct callers). Raises when the
        window was skipped: direct callers pick the window cadence."""
        emitted = self.step_spec_async()
        if emitted is None:
            raise RuntimeError(
                "speculative window skipped: "
                + ("acceptance backoff is suppressing windows"
                   if self.last_skip_reason == "suppressed"
                   else f"drafter {self.drafter.name!r} declined "
                        "(no proposals)"))
        rows = np.asarray(emitted)
        self.observe_window(rows)
        return rows

    def observe_window(self, rows: np.ndarray) -> dict:
        """Fold one drained [T, S] window into the acceptance counters and
        the drafter's per-slot history. An active slot always emits at
        least one token, so active columns are those with any token.
        Returns this window's counts."""
        T = rows.shape[0]
        gamma = T - 1
        # sentinels are not tokens: SKIP and NAN_TOKEN are both negative
        emitted_per = (rows >= 0).sum(axis=0)         # [S]
        active = emitted_per > 0
        emitted = int(emitted_per.sum())
        windows = int(active.sum())
        # each active window's last emitted token is the correction (or
        # the full-acceptance bonus sample); only REAL proposal rows count
        # toward the draft arithmetic (a host drafter pads no-hit slots
        # with filler, which would dilute accept_rate and trip the
        # backoff against a drafter that works)
        hits, self._pending_hits = self._pending_hits, None
        real = active if hits is None else (active & hits)
        proposed = int(real.sum()) * gamma
        accepted = int(np.maximum(emitted_per - 1, 0)[real].sum())
        self.total_windows += 1
        self.total_emitted += emitted
        self.total_eligible += windows * T
        self.total_proposed += proposed
        self.total_accepted += accepted
        for slot in np.nonzero(active)[0]:
            col = rows[:, slot]
            self.drafter.observe(int(slot), [int(x) for x in col[col >= 0]])
        if proposed and self.min_accept > 0:
            self._recent.append((proposed, accepted))
            if len(self._recent) == self._recent.maxlen:
                props = sum(p for p, _ in self._recent)
                accs = sum(a for _, a in self._recent)
                if props and accs / props < self.min_accept:
                    self._cooldown_left = self.cooldown
                    self._recent.clear()
                    log.info(
                        "speculation accept rate %.3f < %.2f over the "
                        "last %d windows; suppressing for %d dispatches",
                        accs / props, self.min_accept,
                        self._recent.maxlen, self.cooldown)
        return {"emitted": emitted, "windows": windows,
                "proposed": proposed, "accepted": accepted}

    def resync_draft(self, slot: int, resident: list[int]) -> None:
        """Rebuild one slot's draft state after non-speculative dispatches
        advanced the target without it (plain fallbacks, chunked
        admissions)."""
        self.drafter.resync(slot, resident, self.target.state.positions)

    # -- slot lifecycle (scheduler-facing, mirrors ModelRunner) ----------

    def admit(self, slot: int, prompt: list[int], **kw) -> int:
        """Prefill the target; the first sampled token seeds the drafter.
        Paged targets get the speculation lookahead reserved on top of
        any caller reservation."""
        if self.paged:
            kw.setdefault("spec_tokens", self.gamma + 1)
        first = self.target.admit(slot, prompt, **kw)
        self.drafter.admit(slot, list(prompt) or [0], first,
                           self.target.state.positions)
        return first

    def begin_admit(self, slot: int, prompt: list[int], **kw):
        """Chunked paged admission; the speculation lookahead rides the
        allocator call (spec_tokens)."""
        kw.setdefault("spec_tokens", self.gamma + 1)
        return self.target.begin_admit(slot, prompt, **kw)

    def acquire_slot(self, slot: Optional[int] = None) -> Optional[int]:
        got = self.target.acquire_slot(slot)
        if got is not None and hasattr(self.drafter, "acquire_slot"):
            self.drafter.acquire_slot(got)
        return got

    def free_slots(self) -> list[int]:
        return self.target.free_slots()

    def release(self, slot: int) -> None:
        self.target.release(slot)
        self.drafter.release(slot)

    def set_bias(self, slot: int, bias_row) -> None:
        self.target.set_bias(slot, bias_row)

    def slot_position(self, slot: int) -> int:
        return self.target.slot_position(slot)

    # -- counters ---------------------------------------------------------

    @property
    def acceptance_rate(self) -> float:
        """Emitted tokens per active slot-window / (gamma+1): 1.0 = every
        window fully accepted for every active slot."""
        if not self.total_eligible:
            return 0.0
        return self.total_emitted / self.total_eligible

    @property
    def accept_rate(self) -> float:
        """Draft tokens accepted / proposed."""
        if not self.total_proposed:
            return 0.0
        return self.total_accepted / self.total_proposed

    @property
    def tokens_per_dispatch(self) -> float:
        """Mean emitted tokens per active slot-window: > 1 means the
        verify window beats single-step decode on dispatch count."""
        if not self.total_eligible:
            return 0.0
        windows = self.total_eligible / (self.gamma + 1)
        return self.total_emitted / windows if windows else 0.0

    def stats(self) -> dict:
        """Window counters snapshot."""
        return {
            "gamma": self.gamma,
            "windows": self.total_windows,
            "emitted": self.total_emitted,
            "eligible": self.total_eligible,
            "proposed": self.total_proposed,
            "accepted": self.total_accepted,
            "declined": self.total_declined,
            "suppressed": self.total_suppressed,
            "acceptance_rate": self.acceptance_rate,
            "accept_rate": self.accept_rate,
            "tokens_per_dispatch": self.tokens_per_dispatch,
            **self.drafter.stats(),
        }


def build_spec_engine(target: ModelRunner, *,
                      drafter: str = "auto",
                      draft_ref: Optional[str] = None,
                      model_path: str = "models",
                      gamma: Optional[int] = None,
                      dtype: str = "bfloat16") -> SpecEngine:
    """Resolve a drafter and couple it to ``target`` (the manager's
    entry).

    ``drafter``: ``"model"`` loads ``draft_ref`` as a co-located draft
    model (contiguous KV, the target's slots and device); ``"ngram"``
    self-drafts by prompt lookup; ``"auto"`` picks model when a
    draft_ref is configured, ngram otherwise. Environment:
    ``LOCALAI_SPEC_GAMMA`` (window size), ``LOCALAI_SPEC_NGRAM_MAX`` /
    ``LOCALAI_SPEC_NGRAM_MIN`` (lookup n-gram lengths)."""
    if target.ga_n > 1:
        # a self-extend target has an unroped cache and an identity RoPE
        # table: the verify forward would attend position-blind
        raise ValueError("speculative decoding is not supported with "
                         "self-extend (grp_attn_n > 1)")
    if gamma is None:
        gamma = _env_num("LOCALAI_SPEC_GAMMA", 4)
    gamma = max(1, int(gamma))
    kind = drafter
    if kind in ("auto", "", None):
        kind = "model" if draft_ref else "ngram"
    if kind == "ngram":
        return SpecEngine(
            target,
            NGramDrafter(target.num_slots, gamma,
                         max_n=_env_num("LOCALAI_SPEC_NGRAM_MAX", 4),
                         min_n=_env_num("LOCALAI_SPEC_NGRAM_MIN", 2)),
        )
    if kind != "model":
        raise ValueError(f"unknown drafter {drafter!r} "
                         "(want auto | ngram | model)")
    if not draft_ref:
        raise ValueError("drafter 'model' needs a draft_model reference")
    from localai_tpu_torch.models.registry import resolve_model

    # on a tensor-parallel target the draft is sharded over its mesh
    mesh = getattr(target, "mesh", None)
    draft = resolve_model(draft_ref, model_path=model_path, dtype=dtype,
                          device=target.device, mesh=mesh)
    if draft.cfg.vocab_size != target.cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft.cfg.vocab_size} != target vocab "
            f"{target.cfg.vocab_size} — speculative decoding needs a "
            "shared tokenizer")
    runner = ModelRunner(
        draft.cfg, draft.params,
        num_slots=target.num_slots,
        max_ctx=target.max_ctx,
        prefill_buckets=list(target.buckets[:-1]) or None,
        # int4 is a pool-only layout; a contiguous draft cache takes the
        # scaled int8 scheme
        kv_dtype="int8" if target.kv_dtype == "int4" else target.kv_dtype,
        # the draft serves window steps over slot rows only
        paged=False,
        device=target.device,
        mesh=mesh,
    )
    return SpecEngine(target, ModelDrafter(runner, gamma))
