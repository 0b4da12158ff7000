"""License classification as a device scan program.

A copy of `trivy_tpu/programs/license.py`, whose resolve classifies on the
engine's device.  The host classifier (license/classifier.py +
license/phrases.py) spends host time on every text it is given (the
fingerprint, the phrase tier and the tree), yet virtually no file in a
real scan is a license text.  This program turns that asymmetry into
sieve shape: a tiny ruleset of **anchor
tokens** (one distinctive single word per phrase entry plus the
generic license vocabulary, license/phrases.py) rides the SAME gram
sieve pass as the secret rules, and only files with an anchor hit reach
the exact host decision tree (license/decide.py).  Non-candidates
resolve to "no license" without touching the classifier.

Parity epistemics (mirroring the secret sieve's "grams are necessary
conditions" contract):

- phrase tier: every phrase entry's anchor token is a single word drawn
  from its required phrases, so any phrase match implies an anchor hit
  in the raw bytes (single tokens survive whitespace-collapse
  normalization; the probe's case fold IS the normalizer's lowercase).
  Checked at compile time by `_verify_anchor_coverage`.
- cosine tier: a >= 0.9-cosine match shares the overwhelming majority
  of its trigram mass with a corpus text, and every corpus text carries
  several anchors (also checked at compile time).  An adversarially
  anchor-stripped near-verbatim text sits outside this modeled space —
  the same line the secret sieve draws for regex factors.
- candidates run the IDENTICAL shared decision tree, so on any text
  both backends evaluate, the verdict is byte-identical.

Each anchor becomes one rule whose keyword feeds the case-folded gram
gate and whose `(?i)` literal regex gives the device NFA/vstack a real
pattern to hold; `verify=False` keeps the claim-killer off (anchor
candidacy is a union over tokens — refuting one token must not drop the
file).
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from trivy_tpu_torch.license.classifier import shared_classifier
from trivy_tpu_torch.license.decide import decide_findings
from trivy_tpu_torch.license.phrases import _PHRASE_ANCHORS, _PHRASES, anchor_tokens
from trivy_tpu_torch.ltypes import LicenseFinding
from trivy_tpu_torch.programs.base import ProgramCompileError, ScanProgram
from trivy_tpu_torch.registry.digest import ruleset_digest
from trivy_tpu_torch.rules.model import Rule, RuleSet


def _anchor_rule(idx: int, token: str) -> Rule:
    pat = re.escape(token)
    return Rule(
        id=f"license-anchor-{idx:02d}-{re.sub(r'[^a-z0-9]+', '-', token)}",
        category="license",
        title=f"license anchor token {token!r}",
        severity="UNKNOWN",
        regex=re.compile(b"(?i)" + pat.encode("utf-8")),
        keywords=[token],
        regex_src=f"(?i){pat}",
        group_renames={},
    )


class LicenseScanProgram(ScanProgram):
    program_id = "license"
    verify = False  # candidacy is a token union; see module docstring

    def build_ruleset(self) -> RuleSet:
        tokens = anchor_tokens()
        rules = [_anchor_rule(i, t) for i, t in enumerate(tokens)]
        self._verify_anchor_coverage(tokens)
        return RuleSet(rules=rules)

    @staticmethod
    def _verify_anchor_coverage(tokens: list[str]) -> None:
        """Compile-time necessary-condition check: every phrase entry and
        every corpus text must fire at least one anchor.  A corpus or
        phrase-table change that breaks coverage fails HERE, loudly, not
        as a silent device/host divergence in production."""
        for spdx_id, phrases in _PHRASES:
            anchor = _PHRASE_ANCHORS.get(spdx_id)
            if anchor is None or anchor not in tokens:
                raise ProgramCompileError(
                    f"phrase entry {spdx_id} has no anchor token"
                )
            if not any(anchor in p for p in phrases):
                raise ProgramCompileError(
                    f"anchor {anchor!r} is not a substring of any "
                    f"required phrase of {spdx_id} — a phrase match "
                    "would not imply an anchor hit"
                )
        # corpus texts only: the CPU classifier's are the same on any device
        clf = shared_classifier("cpu")
        for name in clf.names:
            text = clf.corpus_text(name).lower()
            if not any(t in text for t in tokens):
                raise ProgramCompileError(
                    f"license corpus text {name} contains no anchor "
                    "token; the sieve could never surface it"
                )

    def verdict_digest(self) -> str:
        """Ruleset digest + phrase table + classifier corpus: any of the
        three changes the verdicts, so all three key the caches."""
        h = hashlib.sha256()
        h.update(ruleset_digest(self.ruleset()).encode("utf-8"))
        h.update(b"\x00")
        for spdx_id, phrases in _PHRASES:
            h.update("|".join([spdx_id] + phrases).encode("utf-8"))
            h.update(b"\x00")
        h.update(str(shared_classifier("cpu").corpus_digest).encode("ascii"))
        return "sha256:" + h.hexdigest()

    def resolve(
        self, engine, items, cand, offset: int
    ) -> list[list[LicenseFinding]]:
        """Demux hook: decode + classify CANDIDATE files only, through
        the exact host decision tree; everything else is verdict-free."""
        out: list[list[LicenseFinding]] = [[] for _ in items]
        cand_files = np.flatnonzero(cand.any(axis=1))
        engine.stats.license_candidate_files += len(cand_files)
        if len(cand_files) == 0:
            return out
        texts = [
            items[int(fi)][1].decode("utf-8", errors="replace")
            for fi in cand_files
        ]
        for fi, findings in zip(
            cand_files,
            decide_findings(texts, device=engine.device, stats=engine.stats),
        ):
            out[int(fi)] = findings
        return out
