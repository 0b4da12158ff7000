"""Masked-gram compilation: probes -> (mask, value) uint32 compare constants.

Copied from `trivy_tpu/engine/grams.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

The TPU-shaped reformulation of the probe sieve (engine/probes.py).  The
gather-LUT shift-AND sieve is correct but gather-bound on TPU (byte-table
gathers don't vectorize onto the VPU).  Instead, each probe is compiled to a
small set of **masked 4-gram variants**: the device case-folds the content,
packs every 4-byte window into a uint32, and tests

    (window & mask_g) == val_g

for all grams at once — pure elementwise compare/AND/OR that XLA fuses into
one VPU kernel with no gathers (ops/gram_sieve.py).

Soundness: a gram is derived from a window of the probe's byte-class sequence;
positions with wide classes are masked out, small classes (<= MAX_CLASS_EXPAND
members after case folding) are expanded into variants.  Every true probe
occurrence therefore fires at least one of its grams ("no gram hit" soundly
proves "no probe occurrence").  Probes whose best window is below the
selectivity floor get no grams and are treated as always-hit (they stop
filtering but never drop matches).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from trivy_tpu_torch.engine.ir import bs_members
from trivy_tpu_torch.engine.probes import _FREQ, ProbeSet

GRAM_LEN = 4
MAX_CLASS_EXPAND = 4  # class wider than this (folded) is masked out
MAX_VARIANTS = 8  # max expanded (mask, val) pairs per probe
MIN_GRAM_BITS = 9.0  # selectivity floor (bits) for a usable gram


def fold_byte(b: int) -> int:
    return b + 32 if 0x41 <= b <= 0x5A else b


def fold_members(bs: int) -> list[int]:
    return sorted({fold_byte(b) for b in bs_members(bs)})


def _class_bits(members: list[int]) -> float:
    p = float(sum(_FREQ[b] for b in members))
    return -math.log2(max(p, 1e-12))


@dataclass
class _Position:
    members: list[int]  # folded byte values
    keep: bool  # participates in the mask
    bits: float


def _plan_window(classes: tuple[int, ...]) -> tuple[float, list[_Position]]:
    """Score one window; greedily mask out wide / low-value positions until
    the variant product fits MAX_VARIANTS."""
    positions = []
    for bs in classes:
        members = fold_members(bs)
        keep = 0 < len(members) <= MAX_CLASS_EXPAND and 0 not in members
        positions.append(
            _Position(members=members, keep=keep, bits=_class_bits(members))
        )

    def product() -> int:
        p = 1
        for pos in positions:
            if pos.keep and len(pos.members) > 1:
                p *= len(pos.members)
        return p

    while product() > MAX_VARIANTS:
        # Drop the kept multi-member position with the least selectivity.
        worst = min(
            (p for p in positions if p.keep and len(p.members) > 1),
            key=lambda p: p.bits,
        )
        worst.keep = False

    score = sum(p.bits for p in positions if p.keep)
    return score, positions


def _window_variants(plan: list[_Position]) -> list[tuple[int, int]]:
    variants: list[tuple[int, int]] = [(0, 0)]
    for j, pos in enumerate(plan):
        if not pos.keep:
            continue
        shift = 8 * j
        variants = [
            (mask | (0xFF << shift), val | (member << shift))
            for mask, val in variants
            for member in pos.members
        ]
    return variants


def probe_gram_windows(
    classes: tuple[int, ...], max_windows: int = 2
) -> list[tuple[int, list[tuple[int, int]]]]:
    """Select up to `max_windows` windows of the probe; each returns its
    (start, variants): the window's byte offset within the probe's class
    sequence (the per-hit probe-class confirm in the C scan aligns with
    it) and its (mask, val) uint32 variants.  A probe occurrence fires
    EVERY selected window (AND semantics across windows, OR across a
    window's variants).

    Single-window selection by letter-frequency score alone is fragile: the
    best-scored window of "atlassian" is "lass", a substring of "class",
    which fires on essentially all source code.  Requiring two well-separated
    windows ("atla" AND "sian") keeps soundness (both are necessary
    conditions) while multiplying selectivities.
    """
    wlen = min(GRAM_LEN, len(classes))
    scored: list[tuple[float, int, list[_Position]]] = []
    for start in range(len(classes) - wlen + 1):
        score, plan = _plan_window(tuple(classes[start : start + wlen]))
        if score >= MIN_GRAM_BITS:
            scored.append((score, start, plan))
    if not scored:
        return []

    best = max(scored, key=lambda t: t[0])
    chosen = [best]
    if max_windows >= 2 and len(scored) > 1:
        # Farthest usable window from the best one (ties: higher score);
        # require enough separation that one common word can't contain both.
        far = max(
            (t for t in scored if t != best),
            key=lambda t: (abs(t[1] - best[1]), t[0]),
        )
        if abs(far[1] - best[1]) >= 2:
            chosen.append(far)
        else:
            # No window sits >= 2 from the best one (6-byte factors have
            # starts 0..2 only), but a pair across the whole span may:
            # "twitch" -> "twit" AND "itch", which a containing word like
            # "switch" cannot satisfy — its best-scored window "witc" alone
            # fires on essentially every C file.  Overlap keeps soundness
            # (every factor occurrence contains all its sub-windows).
            pairs = [
                (a, b)
                for i, a in enumerate(scored)
                for b in scored[i + 1 :]
                if abs(a[1] - b[1]) >= 2
            ]
            if pairs:
                chosen = list(
                    max(
                        pairs,
                        key=lambda ab: (
                            abs(ab[0][1] - ab[1][1]),
                            ab[0][0] + ab[1][0],
                        ),
                    )
                )

    return [(start, _window_variants(plan)) for _score, start, plan in chosen]



@dataclass
class GramSet:
    """Compiled gram constants + probe attribution.

    Grams group into *windows* (a window's variants are case/class
    expansions of one probe window; OR semantics) and windows group into
    probes (a probe occurrence fires every one of its windows; AND
    semantics — see probe_gram_windows)."""

    masks: np.ndarray  # [G] uint32
    vals: np.ndarray  # [G] uint32
    gram_probe: np.ndarray  # [G] int32 — owning probe index
    gram_window: np.ndarray  # [G] int32 — owning window index
    window_probe: np.ndarray  # [W] int32 — window's probe index
    window_start: np.ndarray  # [W] int32 — window offset within its probe
    probe_has_gram: np.ndarray  # [P] bool
    num_probes: int
    _wmember: np.ndarray = field(init=False, repr=False)  # [G, W] f32 0/1
    _pmember: np.ndarray = field(init=False, repr=False)  # [W, P] f32 0/1
    _pwindows: np.ndarray = field(init=False, repr=False)  # [P] f32 counts

    def __post_init__(self) -> None:
        w = self.num_windows
        self._wmember = np.zeros((self.num_grams, w), dtype=np.float32)
        if self.num_grams:
            self._wmember[np.arange(self.num_grams), self.gram_window] = 1.0
        self._pmember = np.zeros((w, self.num_probes), dtype=np.float32)
        if w:
            self._pmember[np.arange(w), self.window_probe] = 1.0
        self._pwindows = self._pmember.sum(axis=0)

    @property
    def num_grams(self) -> int:
        return len(self.masks)

    @property
    def num_windows(self) -> int:
        return len(self.window_probe)

    def probe_hits_bool(self, gram_hits: np.ndarray) -> np.ndarray:
        """[F, G] bool gram hits -> [F, P] bool probe hits.

        Probes without grams are always-hit (sound over-approximation)."""
        return probe_hits_bool(self._wmember, self._pmember, self._pwindows,
                               self.probe_has_gram, gram_hits)

    def probe_hits(self, gram_hits: np.ndarray) -> np.ndarray:
        """[F, G] bool gram hits -> [F, Pw] packed uint32 probe bitmaps."""
        probe_hit = self.probe_hits_bool(gram_hits)
        pw = (self.num_probes + 31) // 32
        padded = np.zeros((len(probe_hit), pw * 32), dtype=bool)
        padded[:, : self.num_probes] = probe_hit
        return np.packbits(padded, axis=-1, bitorder="little").view("<u4")


def probe_hits_bool(wmember: np.ndarray, pmember: np.ndarray, pwindows: np.ndarray,
                    probe_has_gram: np.ndarray, gram_hits: np.ndarray) -> np.ndarray:
    """`GramSet.probe_hits_bool` over its membership arrays (which a
    `CompiledRules` carries too): a probe hits when every one of its
    windows has a gram hit, or when it has no gram."""
    window_hit = gram_hits.astype(np.float32) @ wmember > 0  # [F, W]
    probe_hit = (
        window_hit.astype(np.float32) @ pmember
    ) >= pwindows[None, :]  # all windows present
    probe_hit[:, ~probe_has_gram] = True
    return probe_hit


def build_gram_set(pset: ProbeSet) -> GramSet:
    masks: list[int] = []
    vals: list[int] = []
    gram_probe: list[int] = []
    gram_window: list[int] = []
    window_probe: list[int] = []
    window_start: list[int] = []
    has = np.zeros(len(pset.probes), dtype=bool)

    for p, probe in enumerate(pset.probes):
        windows = probe_gram_windows(probe.classes)
        if not windows:
            continue
        has[p] = True
        for wstart, variants in windows:
            wid = len(window_probe)
            window_probe.append(p)
            window_start.append(wstart)
            for mask, val in variants:
                masks.append(mask)
                vals.append(val)
                gram_probe.append(p)
                gram_window.append(wid)

    masks_a = np.array(masks, dtype=np.uint32)
    vals_a = np.array(vals, dtype=np.uint32)
    gram_probe_a = np.array(gram_probe, dtype=np.int32)
    gram_window_a = np.array(gram_window, dtype=np.int32)
    # Sort grams by (mask, val) for a deterministic layout; per-gram arrays
    # permute together, so attribution is unaffected.  (Kernels no longer
    # require this order — PallasGramSieve re-sorts via dedupe_grams — but
    # the numpy/native sieves and tests rely on a stable, reproducible
    # gram order across processes.)
    if len(masks_a):
        perm = np.lexsort((vals_a, masks_a))
        masks_a, vals_a = masks_a[perm], vals_a[perm]
        gram_probe_a, gram_window_a = gram_probe_a[perm], gram_window_a[perm]

    return GramSet(
        masks=masks_a,
        vals=vals_a,
        gram_probe=gram_probe_a,
        gram_window=gram_window_a,
        window_probe=np.array(window_probe, dtype=np.int32),
        window_start=np.array(window_start, dtype=np.int32),
        probe_has_gram=has,
        num_probes=len(pset.probes),
    )
