"""Byte-level regex → NFA → DFA engine for constrained decoding.

Copy of ``localai_tpu/functions/fsm.py`` (host code, no device work): the
constraint is compiled to a DFA over UTF-8 *bytes* once, and at serve time
the only per-token work is an O(1) state lookup plus a cached [V] mask
row (see constraint.py). It stands in for LocalAI's BNF grammars, which
llama.cpp walks per token on the CPU.

The regex dialect is the small subset our own compilers emit
(jsonschema.py): literals, escapes, char classes with ranges/negation,
``(...)``, ``|``, ``* + ?``, ``{m}``/``{m,}``/``{m,n}``, and ``.`` (any
byte). No capture semantics, no anchors (matches are always whole-string),
no backreferences — the language is regular by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

# ---------------------------------------------------------------------------
# AST


@dataclasses.dataclass(frozen=True)
class Lit:
    """Single byte-class step; mask is a frozen 256-bool tuple index set."""

    bytes_mask: bytes  # 256-byte 0/1 mask (hashable, unlike ndarray)


@dataclasses.dataclass(frozen=True)
class Concat:
    parts: tuple["Node", ...]


@dataclasses.dataclass(frozen=True)
class Alt:
    options: tuple["Node", ...]


@dataclasses.dataclass(frozen=True)
class Repeat:
    node: "Node"
    lo: int
    hi: Optional[int]  # None = unbounded


Node = Union[Lit, Concat, Alt, Repeat]

EPSILON = Concat(())


def _mask_of(byte_ids) -> bytes:
    m = bytearray(256)
    for b in byte_ids:
        m[b] = 1
    return bytes(m)


_ANY = _mask_of(range(256))
_DIGIT = _mask_of(range(0x30, 0x3A))
_SPACE = _mask_of(b" \t\n\r\f\v")
_WORD = _mask_of(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F]
)


def _invert(mask: bytes) -> bytes:
    return bytes(1 - b for b in mask)


# ---------------------------------------------------------------------------
# Parser (recursive descent over the emitted dialect)


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.src = pattern.encode("utf-8")
        self.i = 0

    def parse(self) -> Node:
        node = self._alt()
        if self.i != len(self.src):
            raise RegexError(f"trailing input at byte {self.i}")
        return node

    # grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    #          repeat := atom quantifier? ; atom := literal | class | group | .
    def _alt(self) -> Node:
        opts = [self._concat()]
        while self._peek() == 0x7C:  # '|'
            self.i += 1
            opts.append(self._concat())
        return opts[0] if len(opts) == 1 else Alt(tuple(opts))

    def _concat(self) -> Node:
        parts = []
        while True:
            c = self._peek()
            if c is None or c in (0x7C, 0x29):  # '|' ')'
                break
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def _repeat(self) -> Node:
        atom = self._atom()
        c = self._peek()
        if c == 0x2A:  # '*'
            self.i += 1
            return Repeat(atom, 0, None)
        if c == 0x2B:  # '+'
            self.i += 1
            return Repeat(atom, 1, None)
        if c == 0x3F:  # '?'
            self.i += 1
            return Repeat(atom, 0, 1)
        if c == 0x7B:  # '{'
            j = self.src.index(b"}", self.i)
            spec = self.src[self.i + 1:j].decode()
            self.i = j + 1
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s or 0)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(spec)
            if hi is not None and hi < lo:
                raise RegexError(f"bad quantifier {{{spec}}}")
            return Repeat(atom, lo, hi)
        return atom

    def _atom(self) -> Node:
        c = self._peek()
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == 0x28:  # '('
            self.i += 1
            if self.src[self.i:self.i + 2] == b"?:":
                self.i += 2
            node = self._alt()
            if self._peek() != 0x29:
                raise RegexError("unbalanced group")
            self.i += 1
            return node
        if c == 0x5B:  # '['
            return self._char_class()
        if c == 0x2E:  # '.'
            self.i += 1
            return Lit(_ANY)
        if c == 0x5C:  # '\'
            self.i += 1
            return Lit(self._escape())
        self.i += 1
        return Lit(_mask_of([c]))

    def _escape(self) -> bytes:
        c = self.src[self.i]
        self.i += 1
        table = {0x64: _DIGIT, 0x44: _invert(_DIGIT), 0x73: _SPACE,
                 0x53: _invert(_SPACE), 0x77: _WORD, 0x57: _invert(_WORD)}
        if c in table:
            return table[c]
        literal = {0x6E: 0x0A, 0x74: 0x09, 0x72: 0x0D, 0x66: 0x0C,
                   0x76: 0x0B, 0x30: 0x00}
        if c in literal:
            return _mask_of([literal[c]])
        if c == 0x78:  # \xHH
            h = self.src[self.i:self.i + 2].decode()
            self.i += 2
            return _mask_of([int(h, 16)])
        return _mask_of([c])  # escaped literal (\{ \} \" \\ ...)

    def _char_class(self) -> Node:
        self.i += 1  # '['
        negate = self._peek() == 0x5E  # '^'
        if negate:
            self.i += 1
        mask = bytearray(256)
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexError("unterminated character class")
            if c == 0x5D and not first:  # ']'
                self.i += 1
                break
            first = False
            if c == 0x5C:
                self.i += 1
                sub = self._escape()
                if sum(sub) != 1:  # class escape like \d inside [...]
                    for b in range(256):
                        if sub[b]:
                            mask[b] = 1
                    continue
                lo = sub.index(1)
            else:
                lo = c
                self.i += 1
            if self._peek() == 0x2D and self.src[self.i + 1:self.i + 2] != b"]":
                self.i += 1  # '-'
                hc = self._peek()
                if hc == 0x5C:
                    self.i += 1
                    esc = self._escape()
                    hi = esc.index(1)
                else:
                    hi = hc
                    self.i += 1
                for b in range(lo, hi + 1):
                    mask[b] = 1
            else:
                mask[lo] = 1
        out = bytes(mask)
        return Lit(_invert(out) if negate else out)

    def _peek(self) -> Optional[int]:
        return self.src[self.i] if self.i < len(self.src) else None


def parse(pattern: str) -> Node:
    return _Parser(pattern).parse()


# ---------------------------------------------------------------------------
# Thompson NFA


class _NFA:
    def __init__(self) -> None:
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[bytes, int]]] = []  # (byte mask, target)

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node: Node, src: int, dst: int) -> None:
        if isinstance(node, Lit):
            self.edges[src].append((node.bytes_mask, dst))
        elif isinstance(node, Concat):
            cur = src
            for part in node.parts[:-1] if node.parts else ():
                nxt = self.state()
                self.build(part, cur, nxt)
                cur = nxt
            if node.parts:
                self.build(node.parts[-1], cur, dst)
            else:
                self.eps[src].append(dst)
        elif isinstance(node, Alt):
            for opt in node.options:
                self.build(opt, src, dst)
        elif isinstance(node, Repeat):
            cur = src
            for _ in range(node.lo):
                nxt = self.state()
                self.build(node.node, cur, nxt)
                cur = nxt
            if node.hi is None:
                loop = self.state()
                self.eps[cur].append(loop)
                self.build(node.node, loop, loop)
                self.eps[loop].append(dst)
            else:
                for _ in range(node.hi - node.lo):
                    self.eps[cur].append(dst)
                    nxt = self.state()
                    self.build(node.node, cur, nxt)
                    cur = nxt
                self.eps[cur].append(dst)
        else:  # pragma: no cover
            raise TypeError(node)


# ---------------------------------------------------------------------------
# DFA (subset construction over byte equivalence classes)


@dataclasses.dataclass
class DFA:
    """Dense byte-class DFA. State 0 is always the dead state."""

    trans: np.ndarray        # [n_states, n_classes] int32
    accept: np.ndarray       # [n_states] bool
    byte_class: np.ndarray   # [256] int32
    start: int

    DEAD = 0

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def step_byte(self, state: int, byte: int) -> int:
        return int(self.trans[state, self.byte_class[byte]])

    def step_bytes(self, state: int, data: bytes) -> int:
        for b in data:
            state = self.step_byte(state, b)
            if state == self.DEAD:
                return state
        return state

    def matches(self, text: Union[str, bytes]) -> bool:
        data = text.encode("utf-8") if isinstance(text, str) else text
        return bool(self.accept[self.step_bytes(self.start, data)])

    def live(self, state: int) -> bool:
        """True if any continuation from `state` can still reach accept."""
        return state != self.DEAD

    def forced_end(self, state: int) -> bool:
        """Accepting state with no live outgoing transition: match complete."""
        return bool(self.accept[state]) and bool(
            (self.trans[state] == self.DEAD).all()
        )


def _byte_classes(masks: list[bytes]) -> np.ndarray:
    """Partition 0..255 into equivalence classes indistinguishable by any
    transition mask — collapses the 256-wide alphabet to typically <64."""
    classes: dict[bytes, int] = {}
    arr = np.zeros((len(masks), 256), dtype=np.uint8)
    for i, m in enumerate(masks):
        arr[i] = np.frombuffer(m, dtype=np.uint8)
    out = np.zeros(256, dtype=np.int32)
    for b in range(256):
        key = arr[:, b].tobytes()
        out[b] = classes.setdefault(key, len(classes))
    return out


def compile_dfa(pattern: Union[str, Node]) -> DFA:
    node = parse(pattern) if isinstance(pattern, str) else pattern
    nfa = _NFA()
    s0 = nfa.state()
    s1 = nfa.state()
    nfa.build(node, s0, s1)

    # epsilon closures (iterative DFS, computed per subset on demand)
    def closure(states: frozenset[int]) -> frozenset[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    masks = [m for edges in nfa.edges for (m, _) in edges]
    if not masks:
        masks = [_ANY]
    byte_class = _byte_classes(masks)
    n_classes = int(byte_class.max()) + 1
    # representative byte per class
    rep = np.zeros(n_classes, dtype=np.int32)
    for c in range(n_classes):
        rep[c] = int(np.argmax(byte_class == c))

    start_set = closure(frozenset([s0]))
    ids: dict[frozenset[int], int] = {frozenset(): DFA.DEAD, start_set: 1}
    order: list[frozenset[int]] = [frozenset(), start_set]
    rows: list[list[int]] = [[DFA.DEAD] * n_classes]
    qi = 1  # BFS over `order` so discovery order == state id order
    while qi < len(order):
        cur = order[qi]
        qi += 1
        row = [DFA.DEAD] * n_classes
        for c in range(n_classes):
            b = int(rep[c])
            targets = set()
            for s in cur:
                for m, t in nfa.edges[s]:
                    if m[b]:
                        targets.add(t)
            if targets:
                nxt = closure(frozenset(targets))
                if nxt not in ids:
                    ids[nxt] = len(order)
                    order.append(nxt)
                row[c] = ids[nxt]
        rows.append(row)
    trans = np.asarray(rows, dtype=np.int32)
    accept = np.zeros(len(order), dtype=bool)
    for subset, sid in ids.items():
        accept[sid] = s1 in subset

    # prune states that can never reach accept (turn them into DEAD) so that
    # `state != DEAD` is exactly "still matchable" — the property the token
    # mask relies on.
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        reaches = live[trans].any(axis=1)
        new_live = live | reaches
        if (new_live != live).any():
            live = new_live
            changed = True
    remap = np.zeros(len(order), dtype=np.int32)
    nxt_id = 1
    for sid in range(1, len(order)):
        if live[sid]:
            remap[sid] = nxt_id
            nxt_id += 1
    new_trans = np.zeros((nxt_id, n_classes), dtype=np.int32)
    new_accept = np.zeros(nxt_id, dtype=bool)
    for sid in range(1, len(order)):
        if live[sid]:
            new_trans[remap[sid]] = np.where(
                live[trans[sid]], remap[trans[sid]], DFA.DEAD
            )
            new_accept[remap[sid]] = accept[sid]
    start = int(remap[1]) if live[1] else DFA.DEAD
    return DFA(trans=new_trans, accept=new_accept,
               byte_class=byte_class, start=start)
