"""The license decision tree, backend-independent.

A copy of `trivy_tpu/license/decide.py`, whose classifier batch runs on
the caller's `device`.  One function computes the per-text license verdict
from the full-text cosine classifier plus the phrase sieve (fallback +
corpus-blind veto).  Both consumers call it on exactly the texts they
classify:

- the host analyzer (the reference's analyzer/license.py) on every
  claimed license file;
- the device license program (programs/license.py) on the files the
  anchor-token sieve marked candidates.

Because the decision code is shared and per-text independent (the cosine
matmul scores each row against the fixed corpus matrix, no cross-text
coupling), the two backends are byte-identical on any text they both
evaluate — the program's parity claim reduces to its candidate set
covering every text the host tree would accept, which the anchor tokens
in license/phrases.py are chosen to guarantee for the phrase tier and
programs/license.py verifies against the corpus at compile time for the
cosine tier.
"""

from __future__ import annotations

import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.license.classifier import shared_classifier
from trivy_tpu_torch.license.phrases import classify_text
from trivy_tpu_torch.ltypes import LicenseFinding
from trivy_tpu_torch.obs import trace as obs_trace


def decide_findings(
    texts: list[str], device: str | torch.device = DEFAULT_DEVICE, stats=None
) -> list[list[LicenseFinding]]:
    """Per-text license findings ([] = no license), one classifier batch on
    `device` (`stats`: `FullTextClassifier.classify_batch`'s), then the
    phrase tier and the tree under the `license.decide` span."""
    if not texts:
        return []
    clf = shared_classifier(device)
    matches = clf.classify_batch(texts, stats=stats)
    with obs_trace.span("license.decide", texts=len(texts)):
        return [_decide(clf, text, match) for text, match in zip(texts, matches)]


def _decide(clf, text: str, match) -> list[LicenseFinding]:
    """One text's findings from its best corpus match (None below the
    threshold)."""
    if match is not None and match.confidence >= 0.99:
        # Essentially-exact corpus match: the phrase sieve can add nothing
        # (a verbatim corpus text merely MENTIONING another license must
        # not be vetoed) — skip its pass.
        return [LicenseFinding.of(match.license, confidence=match.confidence)]
    phrase = classify_text(text)
    if match is None:
        return phrase
    # Corpus-blind veto: licenses absent from the full-text corpus score
    # high against near-identical relatives (AGPL-3.0 vs GPL-3.0 is ~0.98
    # cosine).  When the phrase sieve names a license the corpus cannot
    # represent, its more specific answer wins.
    if phrase and phrase[0].name != match.license and phrase[0].name not in clf.names:
        return phrase
    return [LicenseFinding.of(match.license, confidence=match.confidence)]
