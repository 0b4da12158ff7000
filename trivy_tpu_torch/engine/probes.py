"""Literal-factor probe extraction and the packed shift-AND sieve tables.

Copied from `trivy_tpu/engine/probes.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

This is stage A of the TPU secret engine: a multi-pattern matcher that decides,
per file, which rules *could* match, replacing the reference's per-rule scalar
loop (keyword prefilter bytes.Contains, scanner.go:169-181, plus the regex scan
itself scanner.go:403-408) with one data-parallel pass over all probes at once.

Two probe kinds, both expressed as short byte-class sequences:

* **keyword probes** — Trivy's keyword gate, bit-exact: a case-folded literal
  per (rule, keyword).  Long keywords are trimmed to a window (a substring of a
  keyword is an over-approximating gate).
* **anchor probes** — *necessary literal factors* mined from the rule's regex
  IR: every match of the regex must contain one of the rule's anchor factors,
  so "no anchor hit in file" soundly proves "no match in file".  Rules whose
  best factor set is too weak fall back to keyword gating alone (exactly the
  reference's behavior for those rules).

All probes compile into one LUT tensor [Jmax, 256, Pw]·uint32 where bit p of
word w says "byte b is acceptable at offset j of probe p" (always-true beyond
the probe's length).  The sieve is then, per position i:

    hits(i) = AND_{j<Jmax} LUT[j, content[i+j]]      (packed over all probes)

which is J gathers + J bitwise-ANDs per byte — VPU-shaped, batchable, and
shardable over a device mesh.  Content must be zero-padded by >= Jmax bytes at
file ends; probe classes never accept 0x00 within their true length.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from trivy_tpu_torch.bytefreq import FREQ as _FREQ
from trivy_tpu_torch.engine import goregex
from trivy_tpu_torch.engine.ir import (
    Alt,
    Empty,
    Lit,
    Rep,
    Seq,
    UnsupportedRegex,
    bs_fold_case,
    bs_popcount,
    parse_ir,
)
from trivy_tpu_torch.rules.model import Rule

MAX_PROBE_LEN = 12
MAX_FACTORS_PER_SET = 16
MIN_ANCHOR_SCORE = 10.0  # bits of selectivity required to trust an anchor
_WIDE_CLASS = 48  # popcount above which an element can't be part of a probe


Factor = list[int]  # list of byte-set bitmasks (256-bit ints)


def _elem_bits(bs: int) -> float:
    pc = bs_popcount(bs)
    p = float(sum(_FREQ[b] for b in range(256) if bs >> b & 1))
    bits = -math.log2(max(p, 1 / 4096))
    if pc > 16:
        return min(bits, 1.0)
    if pc > 4:
        return min(bits, 4.0)
    return bits


def _score_factor(f: Factor) -> float:
    return sum(_elem_bits(bs) for bs in f)


def _score_set(fs: list[Factor]) -> float:
    if not fs:
        return 0.0
    return min(_score_factor(f) for f in fs)


def _trim_factor(f: Factor) -> Factor:
    """Keep the best usable sub-factor of <= MAX_PROBE_LEN.

    A contiguous sub-sequence of a necessary factor is itself necessary, so we
    may split on elements that are unusable as probe classes (too wide, or
    accepting the 0x00 padding byte) and keep the highest-selectivity window.
    """
    NUL = 1
    segments: list[Factor] = []
    cur: Factor = []
    for bs in f:
        if bs_popcount(bs) > _WIDE_CLASS or bs & NUL:
            if cur:
                segments.append(cur)
                cur = []
        else:
            cur.append(bs)
    if cur:
        segments.append(cur)

    best: Factor = []
    best_s = -1.0
    for seg in segments:
        if len(seg) <= MAX_PROBE_LEN:
            windows = [seg]
        else:
            windows = [
                seg[i : i + MAX_PROBE_LEN]
                for i in range(len(seg) - MAX_PROBE_LEN + 1)
            ]
        for w in windows:
            s = _score_factor(w)
            if s > best_s:
                best, best_s = w, s
    return best


def _best(cands: list[list[Factor] | None]) -> list[Factor] | None:
    best, best_s = None, -1.0
    for c in cands:
        if c is None:
            continue
        s = _score_set(c)
        if s > best_s:
            best, best_s = c, s
    return best


def necessary_factors(node) -> list[Factor] | None:
    """Return a factor set (OR semantics) every match must contain, or None."""
    if isinstance(node, Empty):
        return None
    if isinstance(node, Lit):
        return [[node.bs]]
    if isinstance(node, Rep):
        if node.min >= 1:
            return necessary_factors(node.item)
        return None
    if isinstance(node, Alt):
        out: list[Factor] = []
        for b in node.branches:
            fs = necessary_factors(b)
            if fs is None:
                return None
            out.extend(fs)
            if len(out) > MAX_FACTORS_PER_SET:
                return None
        return out
    if isinstance(node, Seq):
        return _best(_seq_candidates(node))
    raise TypeError(node)


def _seq_candidates(node: Seq) -> list[list[Factor] | None]:
    """All independently-mandatory factor sets of a sequence.

    Each returned set (runs of consecutive mandatory literals, and each
    non-literal child's own factor set) must occur in every match, so any
    subset of them may be AND-combined as a sieve condition.
    """
    cands: list[list[Factor] | None] = []
    run: Factor = []
    runs: list[Factor] = []

    def close():
        nonlocal run
        if run:
            runs.append(run)
            run = []

    for item in node.items:
        if isinstance(item, Lit):
            run.append(item.bs)
        elif isinstance(item, Rep) and isinstance(item.item, Lit) and item.min >= 1:
            run.extend([item.item.bs] * min(item.min, MAX_PROBE_LEN))
            if item.max != item.min:
                close()
        else:
            close()
            cands.append(necessary_factors(item))
    close()
    cands.extend([[r] for r in runs])
    return cands


MAX_CONJUNCTS = 4


def necessary_factor_conjunction(node) -> list[list[Factor]]:
    """A conjunction (AND) of disjunctive factor sets, all mandatory.

    E.g. for the aws-secret-access-key shape `...aws...key...<token>...` this
    yields [{aws}, {key}, ...]: a file must contain every conjunct's factor for
    the rule to possibly match.  Returns [] when nothing usable exists.
    """
    if isinstance(node, Seq):
        sets = [c for c in _seq_candidates(node) if c is not None]
    else:
        one = necessary_factors(node)
        sets = [one] if one is not None else []
    usable = []
    for s in sets:
        trimmed = [t for t in (_trim_factor(f) for f in s) if t]
        if len(trimmed) == len(s) and _score_set(trimmed) >= MIN_ANCHOR_SCORE:
            usable.append(trimmed)
    usable.sort(key=_score_set, reverse=True)
    return usable[:MAX_CONJUNCTS]


# ---------------------------------------------------------------------------
# Probe set assembly
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Probe:
    classes: tuple[int, ...]  # byte-set bitmask per offset


@dataclass
class RuleProbePlan:
    """Per-rule sieve plan.

    candidate(file) = gate AND all conjuncts, where the gate is an OR over
    keyword probes (empty = always passes, like a keyword-less rule) and each
    anchor conjunct is an OR over factor probes (no conjuncts = no usable
    anchor, anchor side always passes).
    """

    rule_id: str
    gate_probe_ids: list[int] = field(default_factory=list)
    anchor_conjuncts: list[list[int]] = field(default_factory=list)


@dataclass
class ProbeSet:
    probes: list[Probe]
    plans: list[RuleProbePlan]
    jmax: int

    @property
    def num_probes(self) -> int:
        return len(self.probes)

    @property
    def num_words(self) -> int:
        return (len(self.probes) + 31) // 32


    def build_lut(self) -> np.ndarray:
        """LUT [Jmax, 256, Pw] uint32 for the packed shift-AND sieve."""
        pw = self.num_words
        lut = np.zeros((self.jmax, 256, pw), dtype=np.uint32)
        for p, probe in enumerate(self.probes):
            w, bit = p // 32, np.uint32(1 << (p % 32))
            for j in range(self.jmax):
                if j < len(probe.classes):
                    bs = probe.classes[j]
                    for b in range(256):
                        if bs >> b & 1:
                            lut[j, b, w] |= bit
                else:
                    lut[j, :, w] |= bit  # always-true padding beyond probe length
        return lut

    def gate_masks(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-rule packed probe masks for candidate resolution.

        Returns (gate_mask[R,Pw], gate_any[R], conj_mask[R,K,Pw], conj_any[R,K]):
        candidate(file, r) = (not gate_any[r] or hits & gate_mask[r])
                         and all_k (not conj_any[r,k] or hits & conj_mask[r,k])
        """
        r = len(self.plans)
        pw = self.num_words
        gate = np.zeros((r, pw), dtype=np.uint32)
        gate_any = np.zeros(r, dtype=bool)
        conj = np.zeros((r, MAX_CONJUNCTS, pw), dtype=np.uint32)
        conj_any = np.zeros((r, MAX_CONJUNCTS), dtype=bool)
        for i, plan in enumerate(self.plans):
            for p in plan.gate_probe_ids:
                gate[i, p // 32] |= np.uint32(1 << (p % 32))
                gate_any[i] = True
            for k, conjunct in enumerate(plan.anchor_conjuncts):
                for p in conjunct:
                    conj[i, k, p // 32] |= np.uint32(1 << (p % 32))
                    conj_any[i, k] = True
        return gate, gate_any, conj, conj_any


def _keyword_factor(kw: str) -> Factor:
    return [bs_fold_case(1 << b) for b in kw.lower().encode()]


def build_probe_set(rules: list[Rule]) -> ProbeSet:
    probes: list[Probe] = []
    index: dict[tuple[int, ...], int] = {}

    def intern(f: Factor) -> int | None:
        f = _trim_factor(f)
        if not f:
            return None
        key = tuple(f)
        if key not in index:
            index[key] = len(probes)
            probes.append(Probe(classes=key))
        return index[key]

    plans: list[RuleProbePlan] = []
    for rule in rules:
        plan = RuleProbePlan(rule_id=rule.id)
        for kw in rule.keywords:
            pid = intern(_keyword_factor(kw))
            if pid is None:
                # Keyword unusable as a probe => the gate must pass always.
                plan.gate_probe_ids = []
                break
            plan.gate_probe_ids.append(pid)
        if rule.regex_src:
            try:
                irn = parse_ir(goregex.go_to_python(rule.regex_src))
                conjunction = necessary_factor_conjunction(irn)
            except (UnsupportedRegex, goregex.GoRegexError):
                conjunction = []
            for conjunct in conjunction:
                ids = [intern(f) for f in conjunct]
                if all(i is not None for i in ids):
                    plan.anchor_conjuncts.append(sorted({i for i in ids if i is not None}))
        plans.append(plan)

    jmax = max((len(p.classes) for p in probes), default=1)
    return ProbeSet(probes=probes, plans=plans, jmax=jmax)


# ---------------------------------------------------------------------------
# NumPy reference sieve (oracle for the JAX/Pallas implementations)
# ---------------------------------------------------------------------------


