"""Compliance reporting (pkg/compliance).

A compliance spec maps named controls to check/vulnerability IDs; scan
results roll up per control into PASS/FAIL (or WARN for controls without
automated checks), rendered as a summary or a full per-control report.

Copied from `trivy_tpu/compliance/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.compliance.spec import ComplianceSpec, load_spec
from trivy_tpu_torch.compliance.report import build_compliance_report, write_compliance

__all__ = [
    "ComplianceSpec",
    "load_spec",
    "build_compliance_report",
    "write_compliance",
]
