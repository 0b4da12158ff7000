"""License scanning types (pkg/fanal/types/license.go).

Copied from `trivy_tpu/ltypes.py` (the port imports nothing from the JAX
package): the category tables, `categorize`, `LicenseFinding` and
`LicenseFile`, with the JSON forms the serving wire carries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

LICENSE_TYPE_DPKG = "dpkg"
LICENSE_TYPE_HEADER = "header"
LICENSE_TYPE_FILE = "license-file"

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

    def to_json(self) -> dict[str, Any]:
        return {
            "Severity": self.severity,
            "Category": self.category,
            "PkgName": "",
            "FilePath": "",
            "Name": self.name,
            "Confidence": round(self.confidence, 2),
            "Link": self.link,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "LicenseFinding":
        return cls(
            name=d.get("Name", ""),
            category=d.get("Category", CATEGORY_UNKNOWN),
            severity=d.get("Severity", "UNKNOWN"),
            confidence=d.get("Confidence", 1.0),
            link=d.get("Link", ""),
        )


@dataclass
class LicenseFile:
    """types.LicenseFile."""

    license_type: str
    file_path: str
    pkg_name: str = ""
    findings: list[LicenseFinding] = field(default_factory=list)
    layer: Any = None

    def to_json(self) -> dict[str, Any]:
        return {
            "Type": self.license_type,
            "FilePath": self.file_path,
            "PkgName": self.pkg_name,
            "Findings": [f.to_json() for f in self.findings],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "LicenseFile":
        return cls(
            license_type=d.get("Type", ""),
            file_path=d.get("FilePath", ""),
            pkg_name=d.get("PkgName", ""),
            findings=[
                LicenseFinding.from_json(f) for f in (d.get("Findings") or [])
            ],
        )
