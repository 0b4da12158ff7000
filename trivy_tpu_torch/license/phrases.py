"""Distinctive-phrase license sieve (the corpus-blind tier).

A copy of `trivy_tpu/license/phrases.py`.  It mirrors
pkg/licensing/classifier.go's keyword classification: each SPDX id is
pinned by a phrase set over normalized text (lowercase, collapsed
whitespace), ALL of which must appear; the first (most specific) match
wins.  The device license program (programs/license.py) and the host
decision (license/decide.py) share it, and the decision code living in
ONE place is what makes the two backends byte-identical.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.ltypes import LicenseFinding

# Each entry: (SPDX id, [phrases — ALL must appear in normalized text]).
_PHRASES: list[tuple[str, list[str]]] = [
    ("Apache-2.0", ["apache license", "version 2.0"]),
    # "remote network interaction" is AGPL-3.0's own section 13 heading;
    # the license NAME appears in GPL-3.0 section 13 and MPL-2.0's
    # Secondary Licenses clause, so it cannot distinguish on its own.
    ("AGPL-3.0", ["gnu affero general public license", "remote network interaction"]),
    ("LGPL-3.0", ["gnu lesser general public license", "version 3"]),
    ("LGPL-2.1", ["gnu lesser general public license", "version 2.1"]),
    ("GPL-3.0", ["gnu general public license", "version 3"]),
    ("GPL-2.0", ["gnu general public license", "version 2"]),
    ("MPL-2.0", ["mozilla public license", "version 2.0"]),
    ("EPL-2.0", ["eclipse public license", "v 2.0"]),
    (
        "BSD-3-Clause",
        [
            "redistribution and use in source and binary forms",
            "neither the name",
        ],
    ),
    (
        "BSD-2-Clause",
        ["redistribution and use in source and binary forms"],
    ),
    (
        "MIT",
        [
            "permission is hereby granted, free of charge",
            "the software is provided \"as is\"",
        ],
    ),
    (
        "ISC",
        [
            "permission to use, copy, modify, and/or distribute this software",
        ],
    ),
    ("Unlicense", ["this is free and unencumbered software"]),
    ("CC0-1.0", ["cc0 1.0"]),
    ("Zlib", ["this software is provided 'as-is'", "zlib"]),
]

# Per-entry anchor tokens for the device sieve: one single-word token
# drawn from each entry's REQUIRED phrases.  Single words only — phrase
# matching runs over whitespace-collapsed text, so a multi-word phrase
# can span a raw line break that a contiguous byte probe would miss,
# while a single token survives normalization verbatim (lowercasing is
# exactly the probe's case fold, and collapsing whitespace never creates
# new intra-word adjacencies).  Every phrase match therefore implies its
# anchor token is present in the raw bytes — the necessary-condition
# contract the gram sieve needs (engine/probes.py epistemics).
_PHRASE_ANCHORS: dict[str, str] = {
    "Apache-2.0": "apache",
    "AGPL-3.0": "affero",
    "LGPL-3.0": "lesser",
    "LGPL-2.1": "lesser",
    "GPL-3.0": "general",
    "GPL-2.0": "general",
    "MPL-2.0": "mozilla",
    "EPL-2.0": "eclipse",
    "BSD-3-Clause": "redistribution",
    "BSD-2-Clause": "redistribution",
    "MIT": "permission",
    "ISC": "permission",
    "Unlicense": "unencumbered",
    "CC0-1.0": "cc0",
    "Zlib": "zlib",
}

# Generic tokens that pin the full-text similarity tier: any text the
# cosine classifier accepts (>= 0.9 against a corpus license) shares the
# overwhelming majority of its trigram mass with that license, and every
# corpus text contains several of these (verified at program compile
# time by programs/license.py).  An adversarially anchor-stripped
# near-verbatim text sits outside this modeled space — the same
# epistemic line the secret sieve draws for its regex factors.
_GENERIC_ANCHORS: tuple[str, ...] = (
    "license",
    "licence",
    "copyright",
    "warranty",
    "warranties",
    "permission",
    "redistribution",
    "public domain",
    "copying",
)


def anchor_tokens() -> list[str]:
    """The deduplicated device-sieve gate vocabulary, stable order."""
    seen: dict[str, None] = {}
    for tok in list(_PHRASE_ANCHORS.values()) + list(_GENERIC_ANCHORS):
        seen.setdefault(tok)
    return list(seen)


def normalize(text: str) -> str:
    return re.sub(r"\s+", " ", text.lower())


def classify_text(text: str) -> list[LicenseFinding]:
    """pkg/licensing/classifier.go Classify, phrase-based."""
    text = normalize(text)
    findings = []
    for spdx_id, phrases in _PHRASES:
        if all(p in text for p in phrases):
            findings.append(LicenseFinding.of(spdx_id, confidence=0.9))
            break  # first (most specific) match wins
    return findings


def classify(content: bytes) -> list[LicenseFinding]:
    return classify_text(content.decode("utf-8", errors="replace"))
