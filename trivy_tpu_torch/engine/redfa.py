"""Per-rule search DFAs: exact-ish match-existence tests for candidates.

The second verification stage of the hybrid engine (between the gram sieve's
candidate pairs and the byte-exact oracle confirm).  Rules whose keywords are
common substrings — the reference's own keyword prefilter has the same hole,
e.g. twilio-api-key's keyword is literally "SK" (builtin-rules.go:246-252) —
flood the confirm stage with files that contain the keyword but no match;
running Python `re` over each costs ~100us/file.  A DFA table walk in C
(`trivy_tpu_torch/native/dfa_verify.cpp` dfa_verify_pairs) answers "does this rule match
anywhere in this file?" at ~1 cycle-per-byte-class-lookup, so the oracle only
sees pairs that genuinely match.

Construction: Glushkov positions for the rule's regex (engine/nfa._Builder,
one rule per automaton) -> the *search* step relation

    S' = (follow(S) | first) & positions[class(byte)]

subset-constructed into a DFA over the rule's byte classes.  Accept states
are subsets intersecting the rule's last-positions.

Soundness: the IR drops zero-width anchors and widens large counted repeats
(engine/ir.py, engine/nfa.py) — the DFA therefore over-approximates the
language, so a "no match" verdict is trustworthy and a "match" verdict is
re-confirmed by the oracle.  Rules whose regex cannot be compiled, or whose
DFA exceeds the state/class caps, get no DFA and are passed through
unverified (has_dfa = 0).

Copied from `trivy_tpu/engine/redfa.py`.  The port's claim-killer is the
C walk only: `verify_pairs` and `verify_pairs_files` build the native
library on first use and raise when it does not build
(`trivy_tpu_torch/native/loader.py`), and `_python_walk` stays as the C
walk's plain version, which the tests hold it to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from trivy_tpu_torch.engine import goregex
from trivy_tpu_torch.engine.ir import UnsupportedRegex, max_len, parse_ir
from trivy_tpu_torch.engine.nfa import _Builder
from trivy_tpu_torch.rules.model import Rule

MAX_STATES = 768
MAX_CLASSES = 48


@dataclass
class RuleDfa:
    byte_class: np.ndarray  # [256] uint8
    trans: np.ndarray  # [S, C] uint16
    accept: np.ndarray  # [S] uint8
    num_classes: int


@dataclass
class RuleNfa64:
    """Bit-parallel search NFA in one machine word (<= 64 positions).

    Rules whose search-DFA subset construction explodes (counted runs whose
    alphabet overlaps their prefix, e.g. AKIA[A-Z0-9]{16}) are simulated
    directly:  S' = (follow(S) | first) & classmask[class(byte)], accept
    when S' & last != 0.
    """

    byte_class: np.ndarray  # [256] uint8
    follow: np.ndarray  # [m] uint64
    classmask: np.ndarray  # [C] uint64
    first: int
    last: int
    num_classes: int


def _glushkov(rule: Rule, max_rep: int):
    if not rule.regex_src:
        return None
    try:
        irn = parse_ir(goregex.go_to_python(rule.regex_src))
    except (UnsupportedRegex, goregex.GoRegexError):
        return None
    b = _Builder(max_rep=max_rep)
    b._rule = 0
    try:
        _nullable, first, last = b.build(irn)
    except (UnsupportedRegex, RecursionError):
        return None
    return b, first, last


def compile_search_dfa(rule: Rule) -> RuleDfa | None:
    g = _glushkov(rule, max_rep=64)
    if g is None:
        return None
    b, first, last = g
    m = len(b.pos_bs)
    if m == 0:
        return None  # matches empty string everywhere; not worth a DFA

    # Byte classes: bytes with identical position membership share a class.
    pos_of_byte: list[frozenset[int]] = []
    sig: dict[frozenset[int], int] = {}
    byte_class = np.zeros(256, dtype=np.uint8)
    class_pos: list[frozenset[int]] = []
    for byte in range(256):
        members = frozenset(
            p for p in range(m) if (b.pos_bs[p] >> byte) & 1
        )
        idx = sig.get(members)
        if idx is None:
            idx = len(class_pos)
            if idx >= MAX_CLASSES:
                return None
            sig[members] = idx
            class_pos.append(members)
        byte_class[byte] = idx
    num_classes = len(class_pos)

    first_f = frozenset(first)
    last_f = frozenset(last)
    follow = [frozenset(s) for s in b.follow]

    # Subset construction over the search step.
    start: frozenset[int] = frozenset()
    states: dict[frozenset[int], int] = {start: 0}
    order: list[frozenset[int]] = [start]
    trans_rows: list[list[int]] = []
    i = 0
    while i < len(order):
        state = order[i]
        reach: set[int] = set()
        for p in state:
            reach |= follow[p]
        reach |= first_f
        row = []
        for c in range(num_classes):
            nxt = frozenset(reach & class_pos[c])
            j = states.get(nxt)
            if j is None:
                j = len(order)
                if j >= MAX_STATES:
                    return None
                states[nxt] = j
                order.append(nxt)
            row.append(j)
        trans_rows.append(row)
        i += 1

    s = len(order)
    trans = np.zeros((s, num_classes), dtype=np.uint16)
    for k, row in enumerate(trans_rows):
        trans[k, :] = row
    accept = np.fromiter(
        (1 if (st & last_f) else 0 for st in order), dtype=np.uint8, count=s
    )
    return RuleDfa(
        byte_class=byte_class,
        trans=trans,
        accept=accept,
        num_classes=num_classes,
    )


def compile_search_nfa64(rule: Rule) -> RuleNfa64 | None:
    """Bit-parallel fallback; shrinks the counted-repeat cap until the
    position count fits one word (further widening = still sound)."""
    for max_rep in (64, 40, 24, 12):
        g = _glushkov(rule, max_rep=max_rep)
        if g is None:
            return None
        b, first, last = g
        m = len(b.pos_bs)
        if m == 0:
            return None
        if m <= 64:
            break
    else:
        return None
    if m > 64:
        return None

    sig: dict[int, int] = {}
    byte_class = np.zeros(256, dtype=np.uint8)
    masks: list[int] = []
    for byte in range(256):
        mask = 0
        for p in range(m):
            if (b.pos_bs[p] >> byte) & 1:
                mask |= 1 << p
        idx = sig.get(mask)
        if idx is None:
            idx = len(masks)
            if idx >= 255:
                return None
            sig[mask] = idx
            masks.append(mask)
        byte_class[byte] = idx
    follow = np.zeros(m, dtype=np.uint64)
    for p in range(m):
        acc = 0
        for q in b.follow[p]:
            acc |= 1 << q
        follow[p] = acc
    first_m = 0
    for p in first:
        first_m |= 1 << p
    last_m = 0
    for p in last:
        last_m |= 1 << p
    return RuleNfa64(
        byte_class=byte_class,
        follow=follow,
        classmask=np.array(masks, dtype=np.uint64),
        first=first_m,
        last=last_m,
        num_classes=len(masks),
    )


MODE_NONE, MODE_DFA, MODE_NFA = 0, 1, 2

NO_TRIM = np.iinfo(np.int32).max  # sentinel: unbounded match, no walk trim


def compute_prefix_bounds(rules: list[Rule], trimmable) -> np.ndarray:
    """int32[R] walk-trim bound per rule (NO_TRIM = none): a trimmable
    rule's match contains a gram occurrence and is at most max_len(regex)
    long, so its walk clips to [first_hint - bound, last_hint + bound + 8]
    (the dfa_verify_pairs formula).  Shared by the host DfaVerifier and
    the device NfaVerifier — refutation soundness depends on both using
    the identical clip."""
    out = np.full(len(rules), NO_TRIM, dtype=np.int32)
    if trimmable is None:
        return out
    for i, rule in enumerate(rules):
        if not (rule.regex_src and trimmable[i]):
            continue
        try:
            ml = max_len(parse_ir(goregex.go_to_python(rule.regex_src)))
        except (UnsupportedRegex, goregex.GoRegexError):
            continue
        if ml is not None:  # None = unbounded match length
            out[i] = min(ml, NO_TRIM - 1)
    return out


class DfaVerifier:
    """Batched (file, rule) match-existence verification over a byte stream.

    Per rule: a search DFA when subset construction stays small (one table
    walk per byte), else the bit-parallel NFA-64 (counted runs that explode
    the subset construction, e.g. aws-access-key-id), else pass-through.
    Tables for all rules are flattened into contiguous blobs once; each
    verify call walks candidate pairs in C (falls back to a Python walk when
    the native library is unavailable).
    """

    def __init__(self, rules: list[Rule], trimmable=None, prefix_bounds=None):
        """`trimmable`: optional bool[R] - rule r's walk may start at the
        file's first gram hit minus max_len.  Sound ONLY when every match
        of r contains a gram-backed factor occurrence, i.e. the rule has
        an anchor conjunct whose probes ALL carry grams (the engine
        computes this from its probe/gram sets).  Without it, no trim is
        applied: a match can occur before the file's first gram hit when
        candidacy came from gram-less (always-hit) probes.
        `prefix_bounds`: precomputed compute_prefix_bounds output (the
        engine shares one array between this and the device verifier)."""
        self.num_rules = len(rules)
        r = self.num_rules
        luts = np.zeros((r, 256), dtype=np.uint8)
        self.mode = np.zeros(r, dtype=np.uint8)
        self.n_classes = np.zeros(r, dtype=np.int32)
        trans_parts: list[np.ndarray] = []
        accept_parts: list[np.ndarray] = []
        self.trans_off = np.zeros(r, dtype=np.int64)
        self.accept_off = np.zeros(r, dtype=np.int64)
        follow_parts: list[np.ndarray] = []
        cmask_parts: list[np.ndarray] = []
        self.follow_off = np.zeros(r, dtype=np.int64)
        self.cmask_off = np.zeros(r, dtype=np.int64)
        self.nfa_first = np.zeros(r, dtype=np.uint64)
        self.nfa_last = np.zeros(r, dtype=np.uint64)
        # Start-state skip table (the RE2 memchr trick): byte b can move the
        # automaton out of its start state; the C walk fast-forwards over
        # bytes that cannot.
        self.start_ok = np.zeros((r, 256), dtype=np.uint8)
        # Walk-start trim bound: a match can begin at most max_len(regex)
        # bytes before the file's first gram hit; NO_TRIM = unbounded
        # match length, no trim.
        self.prefix_bound = (
            np.asarray(prefix_bounds, dtype=np.int32)
            if prefix_bounds is not None
            else compute_prefix_bounds(rules, trimmable)
        )
        toff = aoff = foff = coff = 0
        for i, rule in enumerate(rules):
            dfa = compile_search_dfa(rule)
            if dfa is not None:
                self.mode[i] = MODE_DFA
                self.n_classes[i] = dfa.num_classes
                luts[i] = dfa.byte_class
                self.trans_off[i] = toff
                self.accept_off[i] = aoff
                trans_parts.append(dfa.trans.ravel())
                accept_parts.append(dfa.accept)
                toff += dfa.trans.size
                aoff += dfa.accept.size
                # start-state skip (RE2 memchr trick): bytes that can leave
                # the DFA start state
                self.start_ok[i] = dfa.trans[0][dfa.byte_class] != 0
                continue
            nfa = compile_search_nfa64(rule)
            if nfa is not None:
                self.mode[i] = MODE_NFA
                self.n_classes[i] = nfa.num_classes
                luts[i] = nfa.byte_class
                self.follow_off[i] = foff
                self.cmask_off[i] = coff
                follow_parts.append(nfa.follow)
                cmask_parts.append(nfa.classmask)
                self.nfa_first[i] = nfa.first
                self.nfa_last[i] = nfa.last
                self.start_ok[i] = (
                    nfa.classmask[nfa.byte_class] & np.uint64(nfa.first)
                ) != 0
                foff += nfa.follow.size
                coff += nfa.classmask.size
        self.compiled = int((self.mode != MODE_NONE).sum())
        self.luts = luts
        # Enumerated start sets for the vectorized skip (memchr / AVX
        # compares in skip_to_start); nbytes 0 = set too large, generic
        # table walk.
        self.start_bytes = np.zeros((r, 4), dtype=np.uint8)
        self.start_nbytes = np.zeros(r, dtype=np.int32)
        for i in range(r):
            bs = np.flatnonzero(self.start_ok[i])
            if 0 < len(bs) <= 4:
                self.start_bytes[i, : len(bs)] = bs
                self.start_nbytes[i] = len(bs)
        self.trans_blob = (
            np.concatenate(trans_parts) if trans_parts else np.zeros(0, np.uint16)
        )
        self.accept_blob = (
            np.concatenate(accept_parts) if accept_parts else np.zeros(0, np.uint8)
        )
        self.follow_blob = (
            np.concatenate(follow_parts) if follow_parts else np.zeros(0, np.uint64)
        )
        self.cmask_blob = (
            np.concatenate(cmask_parts) if cmask_parts else np.zeros(0, np.uint64)
        )

    def verify_pairs(
        self,
        stream: np.ndarray,
        file_starts: np.ndarray,
        file_lens: np.ndarray,
        pair_file: np.ndarray,
        pair_rule: np.ndarray,
        pair_hint: np.ndarray | None = None,
        pair_hint_last: np.ndarray | None = None,
    ) -> np.ndarray:
        """uint8[N]: 1 when the pair's rule matches somewhere in the file
        (or has no automaton and must be confirmed by the oracle).

        `pair_hint`/`pair_hint_last`: per-pair offsets of the file's first
        and last screen-passing window; for rules with a finite
        prefix_bound the walk is clipped to
        [hint - bound, hint_last + bound + slack] (see dfa_verify_pairs)."""
        n = len(pair_file)
        out = np.ones(n, dtype=np.uint8)
        if n == 0 or not self.compiled:
            return out
        from trivy_tpu_torch.native import load_native

        lib = load_native()
        stream = np.ascontiguousarray(stream, dtype=np.uint8)
        file_starts = np.ascontiguousarray(file_starts, dtype=np.int64)
        file_lens = np.ascontiguousarray(file_lens, dtype=np.int64)
        pair_file = np.ascontiguousarray(pair_file, dtype=np.int32)
        pair_rule = np.ascontiguousarray(pair_rule, dtype=np.int32)
        if pair_hint is not None:
            pair_hint = np.ascontiguousarray(pair_hint, dtype=np.int32)
        if pair_hint_last is not None:
            pair_hint_last = np.ascontiguousarray(pair_hint_last, dtype=np.int32)
        lib.dfa_verify_pairs(
            stream.ctypes.data,
            file_starts.ctypes.data, file_lens.ctypes.data,
            pair_file.ctypes.data, pair_rule.ctypes.data,
            pair_hint.ctypes.data if pair_hint is not None else None,
            pair_hint_last.ctypes.data
            if pair_hint is not None and pair_hint_last is not None
            else None,
            n,
            *self._table_args(),
            out.ctypes.data,
        )
        return out

    def verify_pairs_files(
        self,
        file_ptrs,
        file_lens: np.ndarray,
        pair_file: np.ndarray,
        pair_rule: np.ndarray,
        pair_hint: np.ndarray | None = None,
        pair_hint_last: np.ndarray | None = None,
    ) -> np.ndarray:
        """verify_pairs over per-file ORIGINAL buffers (a ctypes pointer
        array): no packed stream exists on this path (the sieve folds
        straight from the file buffers).  The engine's claim-killer."""
        n = len(pair_file)
        out = np.ones(n, dtype=np.uint8)
        if n == 0 or not self.compiled:
            return out
        from trivy_tpu_torch.native import load_native

        lib = load_native()
        file_lens = np.ascontiguousarray(file_lens, dtype=np.int64)
        pair_file = np.ascontiguousarray(pair_file, dtype=np.int32)
        pair_rule = np.ascontiguousarray(pair_rule, dtype=np.int32)
        if pair_hint is not None:
            pair_hint = np.ascontiguousarray(pair_hint, dtype=np.int32)
        if pair_hint_last is not None:
            pair_hint_last = np.ascontiguousarray(pair_hint_last, dtype=np.int32)
        import ctypes

        lib.dfa_verify_pairs_files(
            ctypes.cast(file_ptrs, ctypes.c_void_p),
            file_lens.ctypes.data,
            pair_file.ctypes.data, pair_rule.ctypes.data,
            pair_hint.ctypes.data if pair_hint is not None else None,
            pair_hint_last.ctypes.data
            if pair_hint is not None and pair_hint_last is not None
            else None,
            n,
            *self._table_args(),
            out.ctypes.data,
        )
        return out

    def _table_args(self) -> tuple:
        """The rule-table argument tail shared by both native entry points
        (order must match the C signatures — one definition, two calls)."""
        return (
            self.prefix_bound.ctypes.data,
            self.mode.ctypes.data, self.luts.ctypes.data,
            self.trans_blob.ctypes.data, self.trans_off.ctypes.data,
            self.accept_blob.ctypes.data, self.accept_off.ctypes.data,
            self.n_classes.ctypes.data,
            self.follow_blob.ctypes.data, self.follow_off.ctypes.data,
            self.cmask_blob.ctypes.data, self.cmask_off.ctypes.data,
            self.nfa_first.ctypes.data, self.nfa_last.ctypes.data,
            self.start_ok.ctypes.data,
            self.start_bytes.ctypes.data, self.start_nbytes.ctypes.data,
        )

    def _python_walk(self, stream, file_starts, file_lens, pair_file, pair_rule, pair_hint, pair_hint_last, out, n):
        """The C walk's plain version, over the packed-stream layout of
        `verify_pairs`: writes each pair's verdict into `out`."""
        for k in range(n):
            r = int(pair_rule[k])
            mode = self.mode[r]
            if mode == MODE_NONE:
                continue
            f = int(pair_file[k])
            lo = int(file_starts[f])
            skip = 0
            walk_end = int(file_lens[f])
            if pair_hint is not None and self.prefix_bound[r] != np.iinfo(np.int32).max:
                skip = min(
                    max(int(pair_hint[k]) - int(self.prefix_bound[r]), 0),
                    walk_end,
                )
                if pair_hint_last is not None:
                    walk_end = min(
                        walk_end,
                        int(pair_hint_last[k]) + int(self.prefix_bound[r]) + 8,
                    )
            # int64 class ids: uint8 arithmetic would wrap in `s * c + ch`
            cls = self.luts[r][stream[lo + skip : lo + walk_end]].astype(np.int64)
            c = int(self.n_classes[r])
            ok = 0
            if mode == MODE_DFA:
                tblob = self.trans_blob[self.trans_off[r] :]
                accept = self.accept_blob[self.accept_off[r] :]
                s = 0
                for ch in cls:
                    s = int(tblob[s * c + ch])
                    if accept[s]:
                        ok = 1
                        break
            else:
                follow = self.follow_blob[self.follow_off[r] :]
                cmask = self.cmask_blob[self.cmask_off[r] :]
                first = int(self.nfa_first[r])
                last = int(self.nfa_last[r])
                s = 0
                for ch in cls:
                    reach = 0
                    t = s
                    while t:
                        p = (t & -t).bit_length() - 1
                        reach |= int(follow[p])
                        t &= t - 1
                    s = (reach | first) & int(cmask[ch])
                    if s & last:
                        ok = 1
                        break
            out[k] = ok
        return out
