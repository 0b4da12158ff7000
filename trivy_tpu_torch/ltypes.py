"""License finding types (pkg/fanal/types/license.go).

A copy of what the license path reaches in `trivy_tpu/ltypes.py`: the
category tables, `categorize` and `LicenseFinding`.
"""

from __future__ import annotations

from dataclasses import dataclass

# license categories (pkg/licensing/category.go buckets)
CATEGORY_FORBIDDEN = "forbidden"
CATEGORY_RESTRICTED = "restricted"
CATEGORY_RECIPROCAL = "reciprocal"
CATEGORY_NOTICE = "notice"
CATEGORY_PERMISSIVE = "permissive"
CATEGORY_UNENCUMBERED = "unencumbered"
CATEGORY_UNKNOWN = "unknown"

# SPDX id -> category (subset of pkg/licensing/category.go)
LICENSE_CATEGORIES: dict[str, str] = {
    "AGPL-1.0": CATEGORY_FORBIDDEN,
    "AGPL-3.0": CATEGORY_FORBIDDEN,
    "GPL-2.0": CATEGORY_RESTRICTED,
    "GPL-3.0": CATEGORY_RESTRICTED,
    "LGPL-2.1": CATEGORY_RESTRICTED,
    "LGPL-3.0": CATEGORY_RESTRICTED,
    "MPL-2.0": CATEGORY_RECIPROCAL,
    "EPL-2.0": CATEGORY_RECIPROCAL,
    "Apache-2.0": CATEGORY_NOTICE,
    "BSD-2-Clause": CATEGORY_NOTICE,
    "BSD-3-Clause": CATEGORY_NOTICE,
    "MIT": CATEGORY_NOTICE,
    "ISC": CATEGORY_NOTICE,
    "Zlib": CATEGORY_NOTICE,
    "Unlicense": CATEGORY_UNENCUMBERED,
    "CC0-1.0": CATEGORY_UNENCUMBERED,
    "0BSD": CATEGORY_UNENCUMBERED,
}

# category -> default severity (pkg/licensing scanner)
CATEGORY_SEVERITIES: dict[str, str] = {
    CATEGORY_FORBIDDEN: "CRITICAL",
    CATEGORY_RESTRICTED: "HIGH",
    CATEGORY_RECIPROCAL: "MEDIUM",
    CATEGORY_NOTICE: "LOW",
    CATEGORY_PERMISSIVE: "LOW",
    CATEGORY_UNENCUMBERED: "LOW",
    CATEGORY_UNKNOWN: "UNKNOWN",
}


def categorize(license_name: str) -> tuple[str, str]:
    category = LICENSE_CATEGORIES.get(license_name, CATEGORY_UNKNOWN)
    return category, CATEGORY_SEVERITIES[category]


@dataclass
class LicenseFinding:
    """types.LicenseFinding."""

    name: str
    category: str = CATEGORY_UNKNOWN
    severity: str = "UNKNOWN"
    confidence: float = 1.0
    link: str = ""

    @classmethod
    def of(cls, name: str, confidence: float = 1.0) -> "LicenseFinding":
        category, severity = categorize(name)
        link = (
            f"https://spdx.org/licenses/{name}.html"
            if name in LICENSE_CATEGORIES
            else ""
        )
        return cls(
            name=name,
            category=category,
            severity=severity,
            confidence=confidence,
            link=link,
        )
