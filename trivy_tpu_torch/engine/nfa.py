"""Union Glushkov NFA compiler: all rules -> one batched state machine.

Copied from `trivy_tpu/engine/nfa.py` (the Glushkov builder `redfa`
builds on): the port imports nothing from the JAX package, so it keeps its
own copy of this jax-free module.

This is stage B of the TPU secret engine: the reference's per-rule regex loop
(pkg/fanal/secret/scanner.go:388, regexp.FindAllIndex per rule) disappears into
the *width* of one position automaton — every rule's Glushkov positions live in
one shared bit-space, so a single bit-parallel state step advances all rules at
once.  The step, per input byte b:

    S' = (follow(S) | first) & accept[class(b)]
    match_ends(r) |= S' & rule_last[r]

where S is a packed uint32 state bitmask.  `follow` is applied either bitwise
(VPU) or as a dense boolean matmul over the MXU (S[B,m] @ F[m,m]).

Over-approximations (sound for a sieve; the host confirms candidates exactly):
  * zero-width anchors dropped (engine/ir.py),
  * counted repeats E{n,m} with m-n > REP_WIDEN_LIMIT widened to E{n,}.

Compiled tensors:
  byte_class[256]      byte -> equivalence class id
  accept[C, W]·u32     class c -> bitmask of positions whose byte-set contains c
  follow[m, W]·u32     position p -> bitmask of positions reachable next
  first[W]·u32         positions reachable at a match start
  rule_last[R, W]·u32  per-rule accepting positions
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from trivy_tpu_torch.engine import goregex
from trivy_tpu_torch.engine.ir import Alt, Empty, Lit, Rep, Seq, parse_ir
from trivy_tpu_torch.rules.model import Rule

REP_WIDEN_LIMIT = 8
MAX_REP_EXPAND = 64  # cap on instantiated copies of a counted repeat


@dataclass
class UnionNFA:
    num_positions: int
    num_words: int
    num_classes: int
    byte_class: np.ndarray  # [256] int32
    accept: np.ndarray  # [C, W] uint32
    follow: np.ndarray  # [m, W] uint32
    first: np.ndarray  # [W] uint32
    rule_last: np.ndarray  # [R, W] uint32
    pos_rule: np.ndarray  # [m] int32
    rule_ids: list[str]


class _Builder:
    def __init__(self, max_rep: int = MAX_REP_EXPAND) -> None:
        self.pos_bs: list[int] = []  # byte-set per position
        self.follow: list[set[int]] = []
        self.pos_rule: list[int] = []
        self._rule: int = -1
        # Cap on instantiated copies of a counted repeat; smaller caps widen
        # the language further (sound for sieves/verifiers) and keep the
        # position count inside a machine word for bit-parallel simulation.
        self.max_rep = max_rep

    def new_pos(self, bs: int) -> int:
        p = len(self.pos_bs)
        self.pos_bs.append(bs)
        self.follow.append(set())
        self.pos_rule.append(self._rule)
        return p

    def build(self, node) -> tuple[bool, set[int], set[int]]:
        """Returns (nullable, first, last), registering follow edges."""
        if isinstance(node, Empty):
            return True, set(), set()
        if isinstance(node, Lit):
            p = self.new_pos(node.bs)
            return False, {p}, {p}
        if isinstance(node, Seq):
            return self._seq([(it, False) for it in node.items])
        if isinstance(node, Alt):
            nullable, first, last = False, set(), set()
            for b in node.branches:
                n, f, l = self.build(b)
                nullable |= n
                first |= f
                last |= l
            return nullable, first, last
        if isinstance(node, Rep):
            return self._rep(node)
        raise TypeError(node)

    def _seq(self, items: list[tuple[object, bool]]) -> tuple[bool, set[int], set[int]]:
        """Sequence fold; (item, force_nullable) pairs."""
        nullable_acc, first_acc, last_acc = True, set(), set()
        for item, force_nullable in items:
            n, f, l = self.build(item)
            n = n or force_nullable
            for p in last_acc:
                self.follow[p] |= f
            if nullable_acc:
                first_acc |= f
            if n:
                last_acc = last_acc | l
            else:
                last_acc = l
            nullable_acc = nullable_acc and n
        return nullable_acc, first_acc, last_acc

    def _rep(self, node: Rep) -> tuple[bool, set[int], set[int]]:
        lo = min(node.min, self.max_rep)
        hi = node.max
        if hi is not None and (hi - lo > REP_WIDEN_LIMIT or hi > self.max_rep):
            hi = None  # widen to unbounded (sieve over-approximation)
        if hi is None:
            if lo == 0:
                # E*: one copy, self-loop, nullable
                n, f, l = self.build(node.item)
                for p in l:
                    self.follow[p] |= f
                return True, f, l
            # E{n,} (n>=1): (n-1) plain copies followed by a self-looped copy E+
            parts = [(node.item, False)] * (lo - 1)
            nullable_acc, first_acc, last_acc = (
                self._seq(parts) if parts else (True, set(), set())
            )
            n, f, l = self.build(node.item)
            for p in l:
                self.follow[p] |= f  # self-loop
            for p in last_acc:
                self.follow[p] |= f
            if nullable_acc:
                first_acc = first_acc | f
            new_last = (last_acc | l) if n else l
            return (nullable_acc and n), first_acc, new_last
        # Bounded E{lo,hi}: lo mandatory copies + (hi-lo) optional copies
        items = [(node.item, False)] * lo + [(node.item, True)] * (hi - lo)
        if not items:
            return True, set(), set()
        return self._seq(items)


def compile_rules(rules: list[Rule]) -> UnionNFA:
    b = _Builder()
    rule_roots: list[tuple[bool, set[int], set[int]]] = []
    rule_ids = []
    for i, rule in enumerate(rules):
        b._rule = i
        rule_ids.append(rule.id)
        irn = parse_ir(goregex.go_to_python(rule.regex_src))
        rule_roots.append(b.build(irn))

    m = len(b.pos_bs)
    w = max((m + 31) // 32, 1)

    def pack(posset: set[int]) -> np.ndarray:
        arr = np.zeros(w, dtype=np.uint32)
        for p in posset:
            arr[p // 32] |= np.uint32(1 << (p % 32))
        return arr

    follow = np.stack([pack(s) for s in b.follow]) if m else np.zeros((0, w), np.uint32)
    first = np.zeros(w, dtype=np.uint32)
    rule_last = np.zeros((len(rules), w), dtype=np.uint32)
    for i, (_null, f, l) in enumerate(rule_roots):
        first |= pack(f)
        rule_last[i] = pack(l)

    # Byte-class compression: bytes with identical position membership share a class.
    sig: dict[tuple, int] = {}
    byte_class = np.zeros(256, dtype=np.int32)
    accept_rows: list[np.ndarray] = []
    for byte in range(256):
        members = pack({p for p in range(m) if b.pos_bs[p] >> byte & 1})
        key = members.tobytes()
        if key not in sig:
            sig[key] = len(accept_rows)
            accept_rows.append(members)
        byte_class[byte] = sig[key]
    accept = np.stack(accept_rows) if accept_rows else np.zeros((1, w), np.uint32)

    return UnionNFA(
        num_positions=m,
        num_words=w,
        num_classes=len(accept_rows),
        byte_class=byte_class,
        accept=accept,
        follow=follow,
        first=first,
        rule_last=rule_last,
        pos_rule=np.array(b.pos_rule, dtype=np.int32),
        rule_ids=rule_ids,
    )


def simulate(nfa: UnionNFA, content: bytes) -> np.ndarray:
    """Reference bit-parallel simulation.  Returns bool[R]: rule has a match
    end somewhere in content (over-approximate language)."""
    w = nfa.num_words
    state = np.zeros(w, dtype=np.uint32)
    ends = np.zeros(len(nfa.rule_ids), dtype=bool)
    for byte in content:
        c = nfa.byte_class[byte]
        if state.any():
            positions = []
            for wi in range(w):
                word = int(state[wi])
                while word:
                    low = word & -word
                    positions.append(wi * 32 + low.bit_length() - 1)
                    word ^= low
            reach = np.bitwise_or.reduce(nfa.follow[positions], axis=0)
        else:
            reach = np.zeros(w, dtype=np.uint32)
        state = (reach | nfa.first) & nfa.accept[c]
        if state.any():
            ends |= (nfa.rule_last & state).any(axis=1)
    return ends
