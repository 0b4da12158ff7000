"""A byte-frequency model of source and config text, shared by the probe
selection (`engine/probes.py`, `engine/grams.py`, `engine/link.py`) and the
byte-class numbering of the row sieves (`ops/gram_sieve.py` `SYMBOL_ORDER`)."""

from __future__ import annotations

import numpy as np


def byte_freqs() -> np.ndarray:
    """Rough byte-frequency model of source/config text [256], summing to 1.

    Probes are chosen to minimize expected false-positive rate on real corpora;
    a uniform model over-values wide classes like [A-Z0-9]{16} relative to
    exact literals like "AKIA"."""
    f = np.full(256, 5e-4)
    lower = dict(
        e=0.10, t=0.07, a=0.065, o=0.06, i=0.055, n=0.055, s=0.05, r=0.05,
        h=0.035, l=0.035, d=0.03, u=0.025, c=0.025, m=0.02, f=0.018, g=0.016,
        w=0.015, p=0.015, y=0.014, b=0.012, v=0.008, k=0.006, x=0.003,
        j=0.002, q=0.001, z=0.001,
    )
    for ch, v in lower.items():
        f[ord(ch)] = v
        f[ord(ch.upper())] = v / 10
    for d in range(10):
        f[ord("0") + d] = 0.008
    for ch, v in {
        " ": 0.12, "\n": 0.03, "\t": 0.01, "_": 0.02, ".": 0.02, ",": 0.01,
        '"': 0.01, "'": 0.008, ":": 0.012, "/": 0.012, "-": 0.015, "=": 0.01,
        "(": 0.006, ")": 0.006, "[": 0.004, "]": 0.004, "{": 0.004, "}": 0.004,
        "<": 0.003, ">": 0.003, "#": 0.003, "*": 0.002, "+": 0.002, "&": 0.002,
        ";": 0.005, "%": 0.002, "$": 0.001, "@": 0.001, "!": 0.001, "\\": 0.002,
        "|": 0.001, "?": 0.002, "~": 0.0005, "^": 0.0005, "`": 0.0005,
    }.items():
        f[ord(ch)] = v
    return f / f.sum()


FREQ = byte_freqs()
