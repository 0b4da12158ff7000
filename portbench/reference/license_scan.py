"""Plain reference of `trivy fs --scanners secret,license --license-full`,
the yardstick of `correct` for the `secret-license` configuration.

Every file gets both verdicts, and the license verdict is decided on every
file: there is no anchor sieve here, so a file the program never made a
license candidate still has its text classified, and a verdict the program
missed shows as a mismatch.

- Secrets: `secret_scan.SecretScanner` over the builtin rules, Trivy's
  `Scanner.Scan`.
- Licenses: a plain reading of the full-text classifier and its decision
  tree (google/licenseclassifier as Trivy's `pkg/licensing/classifier.go`
  uses it, and the port's `license/classifier.py`, `license/phrases.py`,
  `license/decide.py`):
  - tokens: the text lowercased, lines holding `copyright (c)`, `copyright
    ©` or `copyright <4 digits>` dropped, then the runs of `[a-z0-9]`;
  - a histogram of the token trigrams (the three tokens joined by single
    spaces) over `dim` buckets by CRC-32, and the cosine of the text's
    histogram against each corpus text's, in float64;
  - the best corpus text, if its cosine is at least `confidence` (0.9), at
    its cosine rounded to 4 places; from 0.99 that is the verdict;
  - else the phrase tier (the text lowercased, blanks collapsed; the first
    SPDX id whose phrases all appear, at 0.9) is the verdict where no corpus
    text reached 0.9, and where it names a license the corpus lacks (the
    corpus-blind veto); else the best corpus text is.
  - The corpus: the embedded templates, then the packaged texts
    (`licenses/*.txt`, each filling a name the templates lack), then the
    host's `/usr/share/common-licenses` under its SPDX names (filling the
    rest), the same override order as the program's; its digest is the
    program's CRC-32 chain over the sorted names and texts.

Its data (`license_tables.json`: the templates, the phrase table, the host
corpus's name map, the categories and severities; `licenses/`: the 24 SPDX
texts) are copies under `portbench/reference/`.  It imports nothing of the
program under test nor JAX.

The control (`answers(..., control=True)`) breaks a guarantee of each half:
`secret_scan`'s whole-match spans, and copyright lines kept in the license
tokens, which moves a LICENSE file's cosine by more than the comparison's
`_license_form.TOLERANCE`.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from pathlib import Path

import numpy as np

from portbench.reference import _license_form
from portbench.reference.secret_scan import SecretScanner

HERE = Path(__file__).resolve().parent
TABLES = json.loads((HERE / "license_tables.json").read_text())
DIM = TABLES["dim"]
CONFIDENCE = TABLES["confidence"]
EXACT = 0.99  # a corpus match this close is the verdict without the phrase tier
BLOCK = 2048  # texts a product

_WORD = re.compile(r"[a-z0-9]+")
_COPYRIGHT_LINE = re.compile(r"^.*copyright (\(c\)|©|[0-9]{4}).*$", re.M)
_BLANKS = re.compile(r"\s+")


def corpus(system_dir: str = TABLES["system_dir"]) -> dict[str, str]:
    """The classifier's corpus by SPDX name, in the program's override order."""
    texts = dict(TABLES["embedded"])
    for path in sorted((HERE / "licenses").glob("*.txt")):
        with open(path, encoding="utf-8", errors="replace") as f:
            texts.setdefault(path.stem, f.read())
    if os.path.isdir(system_dir):
        for fname, spdx in TABLES["system_licenses"].items():
            try:
                with open(os.path.join(system_dir, fname), encoding="utf-8",
                          errors="replace") as f:
                    texts.setdefault(spdx, f.read())
            except OSError:
                continue
    return texts


def corpus_digest(texts: dict[str, str]) -> int:
    digest = 0
    for name in sorted(texts):
        digest = zlib.crc32(texts[name].encode(), zlib.crc32(name.encode(), digest))
    return digest


class LicenseClassifier:
    """The cosine tier over the corpus and the decision tree."""

    def __init__(self, keep_copyright_lines: bool = False):
        self.keep_copyright_lines = keep_copyright_lines
        texts = corpus()
        self.names = sorted(texts)
        self.digest = corpus_digest(texts)
        self.matrix = _unit(np.stack([self.histogram(texts[n]) for n in self.names]))

    def tokens(self, text: str) -> list[str]:
        text = text.lower()
        if not self.keep_copyright_lines:
            text = _COPYRIGHT_LINE.sub(" ", text)
        return _WORD.findall(text)

    def histogram(self, text: str) -> np.ndarray:
        """[DIM] float64 counts of the text's token trigrams by bucket."""
        toks = self.tokens(text)
        buckets = [zlib.crc32(" ".join(toks[i:i + 3]).encode()) % DIM
                   for i in range(len(toks) - 2)]
        return np.bincount(np.asarray(buckets, dtype=np.int64), minlength=DIM).astype(np.float64)

    def cosines(self, texts: list[str]) -> np.ndarray:
        """[F, L] float64 cosines of each text against each corpus text (0
        for a text of fewer than three tokens)."""
        out = [(_unit(np.stack([self.histogram(t) for t in texts[lo:lo + BLOCK]]))
                @ self.matrix.T) for lo in range(0, len(texts), BLOCK)]
        return np.concatenate(out) if out else np.zeros((0, len(self.names)))

    def decide(self, text: str, cosines: np.ndarray) -> list[tuple[str, float]]:
        """The text's verdicts as `(SPDX id, confidence)`."""
        best = int(np.argmax(cosines))
        match = None
        if cosines[best] >= CONFIDENCE:
            match = (self.names[best], round(float(cosines[best]), 4))
        if match is not None and match[1] >= EXACT:
            return [match]
        phrase = phrase_tier(text)
        if match is None:
            return phrase
        if phrase and phrase[0][0] != match[0] and phrase[0][0] not in self.names:
            return phrase
        return [match]


def _unit(rows: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return np.divide(rows, norms, out=np.zeros_like(rows), where=norms > 0)


def phrase_tier(text: str) -> list[tuple[str, float]]:
    text = _BLANKS.sub(" ", text.lower())
    for spdx_id, phrases in TABLES["phrases"]:
        if all(p in text for p in phrases):
            return [(spdx_id, TABLES["phrase_confidence"])]
    return []


def finding(name: str, confidence: float) -> tuple:
    """`(name, category, severity, confidence, link)` as Trivy reports it."""
    category = TABLES["categories"].get(name, "unknown")
    link = f"https://spdx.org/licenses/{name}.html" if name in TABLES["categories"] else ""
    return (name, category, TABLES["severities"][category], confidence, link)


def answers(config: dict, items, control: bool = False) -> list[tuple]:
    """The canonical answer (`_license_form.answer`) of each `(path,
    content)` of `items`; with `control`, the control's."""
    scanner = SecretScanner(secret_group_spans=not control)
    clf = LicenseClassifier(keep_copyright_lines=control)
    texts = [content.decode("utf-8", errors="replace") for _, content in items]
    cos = clf.cosines(texts)
    return [_license_form.answer(scanner.scan(path, content),
                                 [finding(*v) for v in clf.decide(text, row)], clf.digest)
            for (path, content), text, row in zip(items, texts, cos)]
