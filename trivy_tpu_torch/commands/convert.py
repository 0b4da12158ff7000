"""`convert` command: re-filter/re-render a saved JSON report
(pkg/commands/convert/run.go).

Copied from `trivy_tpu/commands/convert.py`; the port imports nothing from
the JAX package.  The report goes through the port's `atypes`,
`result/filter.py` and `report/` writers.  Unlike the reference, each
result is rebuilt by `rpc/convert.result_from_json`, the wire's converter,
so its vulnerabilities, misconfigurations, licenses and packages come back
as the typed findings the writers render: the reference keeps them as raw
JSON objects, which its table and SARIF writers print as empty UNKNOWN
rows (ROADMAP C7).  Where the reference renders a report right (secrets,
and the JSON, CycloneDX, SPDX and GitHub formats), the two print the same
bytes.
"""

from __future__ import annotations

import json
import sys

from trivy_tpu_torch.ftypes import ArtifactType, Metadata, Report
from trivy_tpu_torch.report.writer import write_report
from trivy_tpu_torch.result.filter import FilterOptions, filter_report
from trivy_tpu_torch.rpc.convert import result_from_json


def report_from_json(d: dict) -> Report:
    results = [result_from_json(r) for r in d.get("Results") or []]
    meta = d.get("Metadata") or {}
    os_meta = meta.get("OS") or {}
    return Report(
        artifact_name=d.get("ArtifactName", ""),
        artifact_type=ArtifactType(d.get("ArtifactType", "filesystem")),
        results=results,
        metadata=Metadata(
            image_id=meta.get("ImageID", ""),
            diff_ids=list(meta.get("DiffIDs") or []),
            repo_tags=list(meta.get("RepoTags") or []),
            repo_digests=list(meta.get("RepoDigests") or []),
            os_family=os_meta.get("Family", ""),
            os_name=os_meta.get("Name", ""),
        ),
        schema_version=d.get("SchemaVersion", 2),
        created_at=d.get("CreatedAt", ""),
    )


def run_convert(
    report_path: str, fmt: str, output: str, severity: str, template: str = ""
) -> int:
    if fmt == "template" and not template:
        print(
            "trivy-tpu: '--format template' requires '--template'",
            file=sys.stderr,
        )
        return 2
    if template.startswith("@"):
        with open(template[1:], encoding="utf-8") as f:
            template = f.read()
    with open(report_path, encoding="utf-8") as f:
        report = report_from_json(json.load(f))
    report = filter_report(
        report, FilterOptions(severities=severity.upper().split(","))
    )
    if output:
        with open(output, "w", encoding="utf-8") as f:
            write_report(report, fmt, f, template=template)
    else:
        write_report(report, fmt, sys.stdout, template=template)
    return 0
