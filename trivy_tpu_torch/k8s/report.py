"""k8s report model + writers (pkg/k8s/report).

Per-resource results aggregate into the summary table (rows per resource,
finding counts bucketed by severity per scanner class) or the full report
(every inner Result, the reference's --report all).

Copied from `trivy_tpu/k8s/report.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

_SEV_ORDER = ("CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN")


@dataclass
class K8sResource:
    namespace: str = ""
    kind: str = ""
    name: str = ""
    results: list = field(default_factory=list)
    error: str = ""

    def counts(self) -> dict[str, dict[str, int]]:
        """Per scanner class, severity -> count."""
        out: dict[str, dict[str, int]] = {}

        def bump(klass: str, severity: str) -> None:
            sev = severity if severity in _SEV_ORDER else "UNKNOWN"
            out.setdefault(klass, {})
            out[klass][sev] = out[klass].get(sev, 0) + 1

        for r in self.results:
            for v in getattr(r, "vulnerabilities", []) or []:
                bump("Vulnerabilities", v.severity)
            for m in getattr(r, "misconfigurations", []) or []:
                if getattr(m, "status", "FAIL") == "FAIL":
                    bump("Misconfigurations", m.severity)
            for s in getattr(r, "secrets", []) or []:
                bump("Secrets", s.severity)
        return out

    def to_json(self, full: bool) -> dict:
        out: dict = {
            "Namespace": self.namespace,
            "Kind": self.kind,
            "Name": self.name,
        }
        if self.error:
            out["Error"] = self.error
        if full:
            out["Results"] = [r.to_json() for r in self.results]
        else:
            out["Summary"] = self.counts()
        return out


RBAC_RESOURCE_KINDS = frozenset(
    {"Role", "RoleBinding", "ClusterRole", "ClusterRoleBinding"}
)


def rbac_resource(res: "K8sResource") -> bool:
    """The reference's rbacResource split (pkg/k8s/report/report.go:201):
    RBAC kinds report under a separate 'RBAC Assessment' section."""
    return res.kind in RBAC_RESOURCE_KINDS


@dataclass
class K8sReport:
    cluster_name: str = ""
    resources: list[K8sResource] = field(default_factory=list)

    def to_json(self, full: bool = False) -> dict:
        out = {
            "SchemaVersion": 2,
            "ClusterName": self.cluster_name,
            "Resources": [
                r.to_json(full)
                for r in self.resources
                if not rbac_resource(r)
            ],
        }
        rbac = [r.to_json(full) for r in self.resources if rbac_resource(r)]
        if rbac:
            out["RBACAssessment"] = rbac
        return out


def write_k8s_report(
    report: K8sReport, fmt: str = "table", full: bool = False, out=None
) -> None:
    out = out or sys.stdout
    if fmt == "json":
        json.dump(report.to_json(full), out, indent=2)
        out.write("\n")
        return
    out.write(f"\nCluster: {report.cluster_name or '(unnamed)'}\n")

    def write_rows(resources, title):
        if not resources:
            return
        out.write(f"\n{title}\n")
        header = (
            f"{'Namespace':12} {'Kind':12} {'Name':28} "
            f"{'Vuln C/H/M/L':14} {'Misconf C/H/M/L':16} {'Secrets':8}\n"
        )
        out.write(header)
        out.write("-" * len(header) + "\n")
        for res in resources:
            counts = res.counts()

            def fmt4(klass: str) -> str:
                c = counts.get(klass, {})
                return "/".join(
                    str(c.get(s, 0))
                    for s in ("CRITICAL", "HIGH", "MEDIUM", "LOW")
                )

            secrets = sum(counts.get("Secrets", {}).values())
            out.write(
                f"{res.namespace:12} {res.kind:12} {res.name:28} "
                f"{fmt4('Vulnerabilities'):14} {fmt4('Misconfigurations'):16} "
                f"{secrets:<8}\n"
            )
            if res.error:
                out.write(f"    error: {res.error}\n")

    write_rows(
        [r for r in report.resources if not rbac_resource(r)],
        "Workload Assessment",
    )
    write_rows(
        [r for r in report.resources if rbac_resource(r)],
        "RBAC Assessment",
    )
