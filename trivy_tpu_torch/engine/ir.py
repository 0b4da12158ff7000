"""Regex intermediate representation for device compilation.

Copied from `trivy_tpu/engine/ir.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

Parses the (already Go→Python translated) rule regexes into a small IR that the
probe extractor (engine/probes.py) and the Glushkov NFA compiler (engine/nfa.py)
consume.  We reuse CPython's own sre parser so the IR is guaranteed to agree
with the Pattern objects the oracle matches with; byte-level semantics mirror
RE2-over-bytes (ASCII categories).

The device engines are *sieves*: they may over-approximate the language
(anchors dropped, wide counted repeats relaxed) because every device candidate
is re-confirmed exactly on the host.  They must never under-approximate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

try:  # Python 3.11+
    _parser = re._parser  # type: ignore[attr-defined]
    _constants = re._constants  # type: ignore[attr-defined]
except AttributeError:  # pragma: no cover
    import sre_constants as _constants
    import sre_parse as _parser

# ---------------------------------------------------------------------------
# Byte sets: a 256-bit Python int, bit b set => byte b is accepted.
# ---------------------------------------------------------------------------

ALL_BYTES = (1 << 256) - 1
NEWLINE = 1 << 0x0A
ANY_NO_NL = ALL_BYTES & ~NEWLINE

# RE2 ASCII categories (over bytes)
_DIGITS = range(0x30, 0x3A)
_WORD = list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) + list(range(0x61, 0x7B)) + [0x5F]
_SPACE = [0x09, 0x0A, 0x0C, 0x0D, 0x20]  # RE2 \s (translator expands it, but be safe)
_PY_SPACE = [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20]  # Python bytes \s


def bs_from_iter(it) -> int:
    m = 0
    for b in it:
        m |= 1 << b
    return m


def bs_range(lo: int, hi: int) -> int:
    return ((1 << (hi - lo + 1)) - 1) << lo


def bs_members(bs: int) -> list[int]:
    return [b for b in range(256) if bs >> b & 1]


def bs_popcount(bs: int) -> int:
    return bin(bs).count("1")


def bs_fold_case(bs: int) -> int:
    """ASCII case folding: add the other-cased variant of every letter."""
    out = bs
    for b in range(0x41, 0x5B):  # A-Z
        if bs >> b & 1:
            out |= 1 << (b + 0x20)
    for b in range(0x61, 0x7B):  # a-z
        if bs >> b & 1:
            out |= 1 << (b - 0x20)
    return out


DIGIT_BS = bs_from_iter(_DIGITS)
WORD_BS = bs_from_iter(_WORD)
PY_SPACE_BS = bs_from_iter(_PY_SPACE)

_CATEGORY_BS = {}
for _name, _bs in [
    ("CATEGORY_DIGIT", DIGIT_BS),
    ("CATEGORY_UNI_DIGIT", DIGIT_BS),
    ("CATEGORY_NOT_DIGIT", ALL_BYTES & ~DIGIT_BS),
    ("CATEGORY_UNI_NOT_DIGIT", ALL_BYTES & ~DIGIT_BS),
    ("CATEGORY_WORD", WORD_BS),
    ("CATEGORY_UNI_WORD", WORD_BS),
    ("CATEGORY_NOT_WORD", ALL_BYTES & ~WORD_BS),
    ("CATEGORY_UNI_NOT_WORD", ALL_BYTES & ~WORD_BS),
    ("CATEGORY_SPACE", PY_SPACE_BS),
    ("CATEGORY_UNI_SPACE", PY_SPACE_BS),
    ("CATEGORY_NOT_SPACE", ALL_BYTES & ~PY_SPACE_BS),
    ("CATEGORY_UNI_NOT_SPACE", ALL_BYTES & ~PY_SPACE_BS),
]:
    _code = getattr(_constants, _name, None)
    if _code is not None:
        _CATEGORY_BS[_code] = _bs


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclass
class Lit:
    """One byte consumed from a byte set."""

    bs: int


@dataclass
class Seq:
    items: list


@dataclass
class Alt:
    branches: list


@dataclass
class Rep:
    """item repeated [min, max] times; max=None means unbounded."""

    item: object
    min: int
    max: int | None


@dataclass
class Empty:
    """Zero-width (dropped anchors etc.)."""


class UnsupportedRegex(ValueError):
    pass


IGNORECASE = _constants.SRE_FLAG_IGNORECASE
DOTALL = _constants.SRE_FLAG_DOTALL


def _in_to_bs(items, flags: int) -> int:
    negate = False
    bs = 0
    for op, arg in items:
        opname = str(op)
        if opname == "NEGATE":
            negate = True
        elif opname == "LITERAL":
            if arg < 256:
                bs |= 1 << arg
        elif opname == "RANGE":
            lo, hi = arg
            bs |= bs_range(lo, min(hi, 255))
        elif opname == "CATEGORY":
            bs |= _CATEGORY_BS.get(arg, 0)
        else:
            raise UnsupportedRegex(f"class item {op}")
    if flags & IGNORECASE:
        bs = bs_fold_case(bs)
    if negate:
        bs = ALL_BYTES & ~bs
        # Folding after negation too: RE2 (?i)[^a] excludes both a and A.
        # Python behaves the same at match time; the fold above (pre-negation)
        # already handles it because we folded the positive set first.
    return bs


def _node(op, arg, flags: int):
    opname = str(op)
    if opname == "LITERAL":
        if arg >= 256:
            raise UnsupportedRegex("non-byte literal")
        bs = 1 << arg
        if flags & IGNORECASE:
            bs = bs_fold_case(bs)
        return Lit(bs)
    if opname == "NOT_LITERAL":
        bs = 1 << arg
        if flags & IGNORECASE:
            bs = bs_fold_case(bs)
        return Lit(ALL_BYTES & ~bs)
    if opname == "ANY":
        return Lit(ALL_BYTES if flags & DOTALL else ANY_NO_NL)
    if opname == "IN":
        return Lit(_in_to_bs(arg, flags))
    if opname == "BRANCH":
        _, branches = arg
        return Alt([_subpattern(b, flags) for b in branches])
    if opname == "SUBPATTERN":
        _group, add_flags, del_flags, sub = arg
        return _subpattern(sub, (flags | add_flags) & ~del_flags)
    if opname in ("MAX_REPEAT", "MIN_REPEAT", "POSSESSIVE_REPEAT"):
        lo, hi, sub = arg
        hi_val: int | None = None if hi is _constants.MAXREPEAT else hi
        return Rep(_subpattern(sub, flags), lo, hi_val)
    if opname == "AT":
        # Anchors are zero-width; the sieve over-approximates by dropping them.
        return Empty()
    if opname == "ATOMIC_GROUP":
        return _subpattern(arg, flags)
    raise UnsupportedRegex(f"unsupported op {op}")


def _subpattern(sub, flags: int):
    items = [_node(op, arg, flags) for op, arg in sub]
    items = [n for n in items if not isinstance(n, Empty)]
    if not items:
        return Empty()
    if len(items) == 1:
        return items[0]
    return Seq(items)


def parse_ir(python_pattern: str):
    """Parse a Python-dialect pattern (post goregex translation) into IR."""
    parsed = _parser.parse(python_pattern)
    global_flags = parsed.state.flags
    return _subpattern(parsed, global_flags)


# ---------------------------------------------------------------------------
# IR utilities
# ---------------------------------------------------------------------------


def min_len(node) -> int:
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Seq):
        return sum(min_len(i) for i in node.items)
    if isinstance(node, Alt):
        return min(min_len(b) for b in node.branches)
    if isinstance(node, Rep):
        return node.min * min_len(node.item)
    raise TypeError(node)


def max_len(node) -> int | None:
    """None = unbounded."""
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Seq):
        total = 0
        for i in node.items:
            m = max_len(i)
            if m is None:
                return None
            total += m
        return total
    if isinstance(node, Alt):
        out = 0
        for b in node.branches:
            m = max_len(b)
            if m is None:
                return None
            out = max(out, m)
        return out
    if isinstance(node, Rep):
        m = max_len(node.item)
        if node.max is None:
            # Unbounded repeat: bounded overall only if the item can't consume.
            return 0 if m == 0 else None
        if m is None:
            return None
        return node.max * m
    raise TypeError(node)
