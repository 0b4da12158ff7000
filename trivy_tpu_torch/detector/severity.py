"""Severity-source precedence (pkg/vulnerability/vulnerability.go:112
getVendorSeverity).

When an advisory carries per-source severities (trivy-db VendorSeverity),
the reported severity prefers: the detection's own data source, then GHSA
for GHSA-* ids, then NVD, then the advisory's bare severity, then UNKNOWN.
The chosen source is reported as SeveritySource, so consumers can see whose
judgment they are trusting.

Copied from `trivy_tpu/detector/severity.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from trivy_tpu_torch.db.vulndb import Advisory

# Vendor severity vocabularies normalized to the canonical five levels the
# result filter understands (result/filter.py SEVERITIES); anything unmapped
# degrades to UNKNOWN instead of silently vanishing in the filter.
_CANON = {"UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"}
_ALIASES = {
    "MODERATE": "MEDIUM",   # GHSA
    "IMPORTANT": "HIGH",    # Red Hat / SUSE
    "NEGLIGIBLE": "LOW",    # Ubuntu/Debian
    "UNTRIAGED": "UNKNOWN",  # Amazon
    "NONE": "UNKNOWN",
}


def normalize_severity(s: str) -> str:
    up = (s or "").upper()
    if up in _CANON:
        return up
    return _ALIASES.get(up, "UNKNOWN")


def resolve_severity(adv: Advisory, source_id: str) -> tuple[str, str]:
    """Returns (severity, severity_source)."""
    vs = adv.severity_sources
    if source_id and source_id in vs:
        return normalize_severity(vs[source_id]), source_id
    if adv.vulnerability_id.startswith("GHSA-") and "ghsa" in vs:
        return normalize_severity(vs["ghsa"]), "ghsa"
    if "nvd" in vs:
        return normalize_severity(vs["nvd"]), "nvd"
    if adv.severity:
        return normalize_severity(adv.severity), ""
    return "UNKNOWN", ""
