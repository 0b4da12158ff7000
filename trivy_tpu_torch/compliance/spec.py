"""Compliance spec model + loading (pkg/compliance/spec/compliance.go).

Specs load from a YAML file (``--compliance @path.yaml``) or by builtin
name; each control lists the check IDs that implement it (misconfig check
IDs like DS002/KSV012/AVD-AWS-0086, or CVE ids), a severity, and an
optional defaultStatus for controls with no automated checks (rendered
WARN/FAIL without evidence, compliance.go defaultStatus semantics).

Copied from `trivy_tpu/compliance/spec.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import yaml


class ComplianceError(ValueError):
    pass


@dataclass
class Control:
    id: str
    name: str = ""
    description: str = ""
    severity: str = "UNKNOWN"
    checks: list[str] = field(default_factory=list)
    default_status: str = ""


@dataclass
class ComplianceSpec:
    id: str
    title: str = ""
    description: str = ""
    version: str = ""
    related_resources: list[str] = field(default_factory=list)
    controls: list[Control] = field(default_factory=list)

    def check_ids(self) -> set[str]:
        out: set[str] = set()
        for c in self.controls:
            out.update(c.checks)
        return out


def _parse_spec(doc: dict) -> ComplianceSpec:
    spec = doc.get("spec") or {}
    controls = []
    for c in spec.get("controls") or []:
        controls.append(
            Control(
                id=str(c.get("id", "")),
                name=c.get("name", ""),
                description=c.get("description", ""),
                severity=str(c.get("severity", "UNKNOWN")).upper(),
                checks=[
                    str(chk.get("id", "")) for chk in (c.get("checks") or [])
                ],
                default_status=str(c.get("defaultStatus", "")).upper(),
            )
        )
    return ComplianceSpec(
        id=spec.get("id", ""),
        title=spec.get("title", ""),
        description=spec.get("description", ""),
        version=str(spec.get("version", "")),
        related_resources=list(spec.get("relatedResources") or []),
        controls=controls,
    )


_BUILTIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs")


def load_spec(name: str) -> ComplianceSpec:
    """``@/path.yaml`` loads a file; bare names resolve to builtin specs
    (compliance.go GetComplianceSpec)."""
    if name.startswith("@"):
        path = name[1:]
    else:
        path = os.path.join(_BUILTIN_DIR, f"{name}.yaml")
        if not os.path.exists(path):
            builtin = sorted(
                f[:-5] for f in os.listdir(_BUILTIN_DIR) if f.endswith(".yaml")
            )
            raise ComplianceError(
                f"unknown compliance spec {name!r}; builtin: {builtin}, "
                "or use @/path/to/spec.yaml"
            )
    try:
        with open(path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        raise ComplianceError(f"cannot load compliance spec {path}: {e}") from e
    spec = _parse_spec(doc)
    if not spec.id or not spec.controls:
        raise ComplianceError(f"compliance spec {path} has no id/controls")
    return spec
