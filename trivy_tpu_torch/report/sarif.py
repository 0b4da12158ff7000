"""SARIF 2.1.0 report writer (pkg/report/sarif.go).

Copied from `trivy_tpu/report/sarif.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from typing import Any

from trivy_tpu_torch.ftypes import Report, ResultClass

_SARIF_LEVELS = {
    "CRITICAL": "error",
    "HIGH": "error",
    "MEDIUM": "warning",
    "LOW": "note",
    "UNKNOWN": "note",
}


def to_sarif(report: Report) -> dict[str, Any]:
    rules: dict[str, dict[str, Any]] = {}
    results: list[dict[str, Any]] = []

    for result in report.results:
        if result.result_class == ResultClass.SECRET:
            for f in result.secrets:
                rule_id = f"secret:{f.rule_id}"
                rules.setdefault(
                    rule_id,
                    {
                        "id": rule_id,
                        "name": f.title or f.rule_id,
                        "shortDescription": {"text": f.title or f.rule_id},
                        "fullDescription": {"text": f.title or f.rule_id},
                        "help": {
                            "text": f"Secret {f.title}\nSeverity: {f.severity}",
                        },
                        "properties": {"tags": ["secret", f.severity]},
                    },
                )
                results.append(
                    {
                        "ruleId": rule_id,
                        "level": _SARIF_LEVELS.get(f.severity, "note"),
                        "message": {
                            "text": f"Artifact: {result.target}\n"
                            f"Type: secret\nSecret {f.title}\n"
                            f"Severity: {f.severity}\nMatch: {f.match}"
                        },
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {
                                        "uri": result.target.lstrip("/"),
                                        "uriBaseId": "ROOTPATH",
                                    },
                                    "region": {
                                        "startLine": f.start_line,
                                        "endLine": f.end_line,
                                        "startColumn": 1,
                                        "endColumn": 1,
                                    },
                                }
                            }
                        ],
                    }
                )
        else:
            for v in result.vulnerabilities:
                vid = getattr(v, "vulnerability_id", "")
                rules.setdefault(
                    vid,
                    {
                        "id": vid,
                        "name": getattr(v, "title", vid),
                        "shortDescription": {"text": vid},
                        "fullDescription": {"text": getattr(v, "title", vid)},
                    },
                )
                results.append(
                    {
                        "ruleId": vid,
                        "level": _SARIF_LEVELS.get(
                            getattr(v, "severity", "UNKNOWN"), "note"
                        ),
                        "message": {"text": getattr(v, "title", vid)},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {
                                        "uri": result.target,
                                        "uriBaseId": "ROOTPATH",
                                    },
                                    "region": {
                                        "startLine": 1,
                                        "endLine": 1,
                                        "startColumn": 1,
                                        "endColumn": 1,
                                    },
                                }
                            }
                        ],
                    }
                )

    return {
        "version": "2.1.0",
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "TrivyTPU",
                        "informationUri": "https://github.com/trivy-tpu",
                        "fullName": "TrivyTPU Scanner",
                        "version": "0.1.0",
                        "rules": sorted(rules.values(), key=lambda r: r["id"]),
                    }
                },
                "results": results,
                "columnKind": "utf16CodeUnits",
                "originalUriBaseIds": {
                    "ROOTPATH": {"uri": "file:///"},
                },
            }
        ],
    }
