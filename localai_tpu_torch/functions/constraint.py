"""Token-level FSM constraint: the scheduler-facing half of constrained
decoding.

Copy of ``localai_tpu/functions/constraint.py``. llama.cpp walks a BNF
parser over candidate tokens on the CPU every step; here the grammar is a
byte DFA (fsm.py) compiled once, the tokenizer vocab is a byte trie built
once, and a token mask for a DFA state is ONE trie walk (the C loop of
``native/fsm_walk.c``, or its plain numpy version, O(trie nodes) ≈ ms)
cached per state — JSON grammars revisit a small set of states, so
steady-state per-token cost is an O(1) dict lookup + the [V] bias row the
engine already consumes (ModelRunner.set_bias). All of it is host code:
the device sees only that bias row.

Implements the scheduler's TokenConstraint protocol
(``engine/scheduler.py``).
"""

from __future__ import annotations

import ctypes
import logging
from typing import Any, Optional, Sequence

import numpy as np

from localai_tpu_torch.functions.fsm import DFA, compile_dfa

log = logging.getLogger(__name__)

NEG = np.float32(-1e30)

_NATIVE_SENTINEL = object()
_native_lib: Any = _NATIVE_SENTINEL


def _native_fsm():
    """The compiled fsm_walk C module, or None (numpy fallback)."""
    global _native_lib
    if _native_lib is _NATIVE_SENTINEL:
        from localai_tpu_torch.native import load

        _native_lib = load("fsm_walk")
    return _native_lib


# ---------------------------------------------------------------------------
# Vocabulary → byte sequences


def token_bytes_table(tokenizer: Any) -> list[Optional[bytes]]:
    """Best-effort byte representation per token id; None = never maskable-in
    (special/control tokens).

    For the built-in ByteTokenizer this is exact. For HF tokenizers we use
    the decode-difference trick (decode [probe, id] minus decode [probe]) so
    sentencepiece leading-space conventions survive.
    """
    cached = getattr(tokenizer, "_token_bytes_table", None)
    if cached is not None:
        return cached

    vs = tokenizer.vocab_size
    table: list[Optional[bytes]] = [None] * vs
    if type(tokenizer).__name__ == "ByteTokenizer":
        for i in range(256):
            table[i] = bytes([i])
    else:
        special = set(getattr(tokenizer, "eos_ids", set()))
        special |= set(getattr(tokenizer, "special_ids", set()))
        probe = None
        try:
            probe_ids = tokenizer.encode("x")
            probe = probe_ids[-1] if probe_ids else None
        except Exception:  # noqa: BLE001
            pass
        base = tokenizer.decode([probe]) if probe is not None else ""
        for i in range(vs):
            if i in special:
                continue
            try:
                if probe is not None:
                    text = tokenizer.decode([probe, i])[len(base):]
                else:
                    text = tokenizer.decode([i])
            except Exception:  # noqa: BLE001
                continue
            if text:
                table[i] = text.encode("utf-8")
    tokenizer._token_bytes_table = table
    return table


class TokenTrie:
    """Vocab as level-ordered arrays for vectorized DFA walks.

    Node 0 is the root. For each depth level d we store the node ids at that
    level, their parent node ids, and their edge bytes; a walk assigns DFA
    states level by level with one fancy-indexing op per level.
    """

    def __init__(self, table: Sequence[Optional[bytes]]):
        children: dict[tuple[int, int], int] = {}
        parent = [0]
        edge = [0]
        depth_of = [0]
        leaf_of_token = np.zeros(len(table), dtype=np.int64)
        token_ok = np.zeros(len(table), dtype=bool)
        for tid, bs in enumerate(table):
            if not bs:  # None or empty: never allowed (no FSM progress)
                continue
            node = 0
            for b in bs:
                key = (node, b)
                nxt = children.get(key)
                if nxt is None:
                    nxt = len(parent)
                    children[key] = nxt
                    parent.append(node)
                    edge.append(b)
                    depth_of.append(depth_of[node] + 1)
                node = nxt
            leaf_of_token[tid] = node
            token_ok[tid] = True
        self.n_nodes = len(parent)
        self.parent = np.asarray(parent, dtype=np.int64)
        self.edge = np.asarray(edge, dtype=np.int64)
        self.leaf_of_token = leaf_of_token
        self.token_ok = token_ok
        depths = np.asarray(depth_of)
        self.levels = [
            np.nonzero(depths == d)[0]
            for d in range(1, int(depths.max()) + 1 if self.n_nodes > 1 else 1)
        ]

    @staticmethod
    def for_tokenizer(tokenizer: Any) -> "TokenTrie":
        trie = getattr(tokenizer, "_token_trie", None)
        if trie is None:
            trie = TokenTrie(token_bytes_table(tokenizer))
            tokenizer._token_trie = trie
        return trie

    def walk(self, dfa: DFA, state: int) -> np.ndarray:
        """DFA final state per trie node, starting every token at `state`.
        Dead-state propagation makes `final != DEAD` ⇔ whole token legal.

        Takes the native single-pass loop when the C module compiled
        (``native/fsm_walk.c`` — parents precede children in the node
        order, so one linear loop resolves every node); ``walk_numpy`` is
        its plain version and the fallback."""
        lib = _native_fsm()
        if lib is None:
            return self.walk_numpy(dfa, state)
        states = np.zeros(self.n_nodes, dtype=np.int32)
        states[0] = state
        # contiguous int32/uint8 views cached on the DFA object
        trans = dfa.__dict__.get("_trans_i32")
        if trans is None:
            trans = np.ascontiguousarray(dfa.trans, dtype=np.int32)
            dfa.__dict__["_trans_i32"] = trans
        cls = dfa.__dict__.get("_cls_u8")
        if cls is None:
            cls = np.ascontiguousarray(dfa.byte_class.astype(np.uint8))
            dfa.__dict__["_cls_u8"] = cls
        lib.fsm_walk(
            trans.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(trans.shape[1]),
            cls.ctypes.data_as(ctypes.c_void_p),
            self.parent.ctypes.data_as(ctypes.c_void_p),
            self.edge.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(self.n_nodes),
            states.ctypes.data_as(ctypes.c_void_p),
        )
        return states

    def walk_numpy(self, dfa: DFA, state: int) -> np.ndarray:
        """The plain version of ``walk``: one numpy gather per trie
        level."""
        states = np.zeros(self.n_nodes, dtype=np.int32)
        states[0] = state
        cls = dfa.byte_class
        for nodes in self.levels:
            states[nodes] = dfa.trans[
                states[self.parent[nodes]], cls[self.edge[nodes]]
            ]
        return states


# ---------------------------------------------------------------------------
# The constraint object handed to the scheduler


class FSMConstraint:
    """Drives one request's grammar: mask rows + state advance.

    `allowed_mask` → [V] f32 additive bias (0 allowed / -1e30 banned); EOS
    ids are allowed exactly in accepting states. Returns None once the FSM
    has terminally matched (free region after completion is not part of the
    grammar — the scheduler treats None as "anything").
    """

    def __init__(self, dfa: DFA, tokenizer: Any):
        self.dfa = dfa
        self.tokenizer = tokenizer
        self.trie = TokenTrie.for_tokenizer(tokenizer)
        self.vocab_size = tokenizer.vocab_size
        self.eos_ids = sorted(getattr(tokenizer, "eos_ids", set()))
        self.state = dfa.start
        self._done = False
        # per-state caches: mask row and per-token final state (for advance).
        # Shared across all requests using the same (dfa, vocab trie) — the
        # expensive trie walks happen once per state per grammar, not per
        # request. WeakKeyDictionary: when a model's tokenizer (and thus its
        # trie) is unloaded, its [V]-sized rows are collectible, and a new
        # trie can never collide with a dead one's cache.
        import weakref

        shared = dfa.__dict__.setdefault(
            "_vocab_caches", weakref.WeakKeyDictionary()
        )
        cached = shared.get(self.trie)
        if cached is None:
            cached = ({}, {})
            shared[self.trie] = cached
        self._masks, self._finals = cached

    # -- TokenConstraint protocol ----------------------------------------

    def allowed_mask(self) -> Optional[np.ndarray]:
        if self._done:
            return None
        return self._row(self.state)

    def advance(self, token_id: int) -> None:
        if self._done:
            return
        if token_id in self.eos_ids:
            self._done = True
            return
        finals = self._final_states(self.state)
        if not self.trie.token_ok[token_id]:
            log.warning("constraint: non-text token %d sampled", token_id)
            self._done = True
            return
        nxt = int(finals[self.trie.leaf_of_token[token_id]])
        if nxt == DFA.DEAD:
            # Shouldn't happen under masking; fail open so generation ends
            # cleanly rather than wedging the slot.
            log.warning("constraint: token %d left the grammar", token_id)
            self._done = True
            return
        self.state = nxt
        if self.dfa.forced_end(self.state):
            self._done = True

    @property
    def done(self) -> bool:
        return self._done

    # -- internals --------------------------------------------------------

    def _final_states(self, state: int) -> np.ndarray:
        finals = self._finals.get(state)
        if finals is None:
            node_states = self.trie.walk(self.dfa, state)
            finals = node_states
            self._finals[state] = finals
        return finals

    def _row(self, state: int) -> np.ndarray:
        row = self._masks.get(state)
        if row is None:
            finals = self._final_states(state)
            lib = _native_fsm()
            if lib is not None:
                # fused gather+compare+select in C (fsm_walk.c:fsm_mask):
                # no [V] temporaries on a mask-cache miss
                row = np.empty(len(self.trie.leaf_of_token), np.float32)
                ok_u8 = self.trie.__dict__.get("_ok_u8")
                if ok_u8 is None:
                    ok_u8 = np.ascontiguousarray(
                        self.trie.token_ok.astype(np.uint8))
                    self.trie.__dict__["_ok_u8"] = ok_u8
                lib.fsm_mask(
                    finals.ctypes.data_as(ctypes.c_void_p),
                    self.trie.leaf_of_token.ctypes.data_as(
                        ctypes.c_void_p),
                    ok_u8.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_int64(len(self.trie.leaf_of_token)),
                    ctypes.c_int32(DFA.DEAD),
                    row.ctypes.data_as(ctypes.c_void_p),
                )
            else:
                row = self._mask_numpy(finals)
            self._allow_eos(state, row)
            self._masks[state] = row
        return row

    def row_numpy(self, state: int) -> np.ndarray:
        """The plain version of a state's mask row (numpy walk and
        select, never the C module and never the cache), for holding the
        native rows against."""
        row = self._mask_numpy(self.trie.walk_numpy(self.dfa, state))
        self._allow_eos(state, row)
        return row

    def _mask_numpy(self, finals: np.ndarray) -> np.ndarray:
        tok_final = finals[self.trie.leaf_of_token]
        allowed = self.trie.token_ok & (tok_final != DFA.DEAD)
        return np.where(allowed, np.float32(0.0), NEG).astype(np.float32)

    def _allow_eos(self, state: int, row: np.ndarray) -> None:
        allowed_any = bool((row == 0.0).any())
        if bool(self.dfa.accept[state]):
            for e in self.eos_ids:
                row[e] = 0.0
        elif not allowed_any:
            # dead grammar state with nothing allowed: permit EOS so the
            # slot can finish instead of sampling uniformly over -1e30
            for e in self.eos_ids:
                row[e] = 0.0


# ---------------------------------------------------------------------------
# Convenience constructors


_DFA_CACHE: dict[str, DFA] = {}
_DFA_CACHE_MAX = 128


def cached_dfa(pattern: str) -> DFA:
    """Compile-once cache keyed by pattern text: repeated requests with the
    same toolset skip NFA→DFA construction AND share per-state mask rows
    (they hang off the DFA object)."""
    dfa = _DFA_CACHE.get(pattern)
    if dfa is None:
        dfa = compile_dfa(pattern)
        if len(_DFA_CACHE) >= _DFA_CACHE_MAX:
            _DFA_CACHE.pop(next(iter(_DFA_CACHE)))
        _DFA_CACHE[pattern] = dfa
    return dfa


def constraint_for_regex(pattern: str, tokenizer: Any) -> FSMConstraint:
    c = FSMConstraint(cached_dfa(pattern), tokenizer)
    c.source_regex = pattern
    return c


def constraint_for_schema(schema: dict, tokenizer: Any, *,
                          prop_order: Optional[list[str]] = None,
                          any_depth: int = 3) -> FSMConstraint:
    from localai_tpu_torch.functions.jsonschema import schema_to_regex

    return constraint_for_regex(
        schema_to_regex(schema, prop_order=prop_order, any_depth=any_depth),
        tokenizer,
    )
