"""The canonical answer of the `secret-license` configuration, shared by its
entry (`portbench/entries/programs.py`) and its reference
(`portbench/reference/license_scan.py`): a module of its own, so that the
answers the reference's workers pickle unpickle in the harness.

One file's answer is `()` when it has neither a secret finding nor a license
finding, else `(secret, license)`: `secret` is `secret_scan.canonical`'s form
(`()` when none), `license` is `()` when none, else `(corpus digest,
findings)`, each finding `(name, category, severity, confidence, link)`.
The corpus digest says which corpus the verdict was decided against, so a
program and a reference that classify against different corpora disagree on
every license-bearing file.

Confidences are scores rounded to 4 places and compare within one step of
that rounding (`TOLERANCE`): the program's float32 product and the
reference's float64 one sum in different orders, and a score within ~1e-7 of
a rounding edge may round either way.  A TF32 product's error is ~1e-3 of
the score, ten steps and more.
"""

from __future__ import annotations

TOLERANCE = 1e-4
_EDGE = 1e-9  # two 4-place roundings one step apart differ by 1e-4 plus float noise


class Confidence(float):
    """A confidence rounded to 4 places that equals any number within one
    step of it."""

    __slots__ = ()

    def __eq__(self, other):
        if isinstance(other, (int, float)):
            return abs(float(self) - float(other)) <= TOLERANCE + _EDGE
        return NotImplemented

    def __ne__(self, other):
        same = self.__eq__(other)
        return same if same is NotImplemented else not same

    __hash__ = float.__hash__

    def __repr__(self) -> str:
        return f"Confidence({float(self)!r})"


def answer(secret: tuple, findings, digest: int) -> tuple:
    """One file's canonical answer from its canonical secret answer, its
    license findings as `(name, category, severity, confidence, link)` and
    the corpus digest they were decided against."""
    rows = tuple((name, category, severity, Confidence(confidence), link)
                 for name, category, severity, confidence, link in findings)
    if not secret and not rows:
        return ()
    return (secret, (int(digest), rows) if rows else ())
