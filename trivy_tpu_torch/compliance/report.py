"""Compliance report assembly + writers (pkg/compliance/report).

Scan results roll up per control: a control FAILs when any of its check IDs
appears as a failing finding (misconfig FAIL, secret, vulnerability),
PASSes otherwise; controls without automated checks take their
defaultStatus (usually WARN).  Rendered as the summary table/JSON or the
full per-control report (``--report summary|all``).

Copied from `trivy_tpu/compliance/report.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from trivy_tpu_torch.compliance.spec import ComplianceSpec, Control
from trivy_tpu_torch.ftypes import Report


@dataclass
class ControlResult:
    control: Control
    status: str  # PASS | FAIL | WARN
    findings: list[dict] = field(default_factory=list)

    def to_json(self, full: bool) -> dict[str, Any]:
        out: dict[str, Any] = {
            "ID": self.control.id,
            "Name": self.control.name,
            "Severity": self.control.severity,
            "Status": self.status,
            "TotalFail": len(self.findings) if self.status == "FAIL" else 0,
        }
        if full and self.findings:
            out["Results"] = self.findings
        return out


@dataclass
class ComplianceReport:
    spec: ComplianceSpec
    controls: list[ControlResult]

    def to_json(self, full: bool = False) -> dict[str, Any]:
        key = "ControlResults" if full else "SummaryControls"
        body = {
            "ID": self.spec.id,
            "Title": self.spec.title,
            "Version": self.spec.version,
            key: [c.to_json(full) for c in self.controls],
        }
        if full:
            return body
        return {
            "ID": self.spec.id,
            "Title": self.spec.title,
            "SummaryReport": body,
        }


def _failing_findings_by_id(report: Report) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}

    def add(fid: str, finding: dict) -> None:
        out.setdefault(fid, []).append(finding)

    for result in report.results:
        for m in result.misconfigurations:
            if getattr(m, "status", "FAIL") == "FAIL":
                fid = getattr(m, "check_id", "")
                add(fid, {"Target": result.target, **m.to_json()})
        for s in result.secrets:
            add(s.rule_id, {"Target": result.target, **s.to_json()})
        for v in result.vulnerabilities:
            add(v.vulnerability_id, {"Target": result.target, **v.to_json()})
        for l in result.licenses:
            name = getattr(l, "name", "")
            if name:
                add(name, {"Target": result.target})
    return out


def build_compliance_report(
    report: Report, spec: ComplianceSpec
) -> ComplianceReport:
    failing = _failing_findings_by_id(report)
    controls: list[ControlResult] = []
    for control in spec.controls:
        if not control.checks:
            controls.append(
                ControlResult(
                    control=control, status=control.default_status or "WARN"
                )
            )
            continue
        findings: list[dict] = []
        for cid in control.checks:
            findings.extend(failing.get(cid, []))
        controls.append(
            ControlResult(
                control=control,
                status="FAIL" if findings else "PASS",
                findings=findings,
            )
        )
    return ComplianceReport(spec=spec, controls=controls)


def write_compliance(
    creport: ComplianceReport, fmt: str = "table", full: bool = False, out=None
) -> None:
    import json
    import sys

    out = out or sys.stdout
    if fmt == "json":
        json.dump(creport.to_json(full), out, indent=2)
        out.write("\n")
        return
    # summary table (compliance/report/table.go shape)
    out.write(f"\nCompliance: {creport.spec.title} ({creport.spec.id})\n")
    header = f"{'ID':8} {'Severity':9} {'Status':6} {'Fail':>4}  Name\n"
    out.write(header)
    out.write("-" * max(60, len(header)) + "\n")
    for c in creport.controls:
        fails = len(c.findings) if c.status == "FAIL" else 0
        out.write(
            f"{c.control.id:8} {c.control.severity:9} {c.status:6} "
            f"{fails:>4}  {c.control.name}\n"
        )
