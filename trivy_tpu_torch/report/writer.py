"""Report writer dispatch (pkg/report/writer.go:28 format switch).

Copied from `trivy_tpu/report/writer.py`; the port imports nothing from the
JAX package.  `check_format` refuses an unknown format before a scan runs.
"""

from __future__ import annotations

import json
import sys
from typing import IO

from trivy_tpu_torch.ftypes import Report
from trivy_tpu_torch.report.sarif import to_sarif
from trivy_tpu_torch.report.table import write_table

FORMATS = [
    "table", "json", "sarif", "cyclonedx", "spdx", "spdx-json", "template",
    "github", "cosign-vuln",
]


def check_format(fmt: str) -> None:
    """Raise for a format the writer does not know, before any scan runs."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format: {fmt} (supported: {FORMATS})")


def write_report(
    report: Report,
    fmt: str = "table",
    out: IO[str] | None = None,
    template: str = "",
) -> None:
    out = out if out is not None else sys.stdout
    if fmt == "json":
        json.dump(report.to_json(), out, indent=2)
        out.write("\n")
    elif fmt == "table":
        write_table(report, out)
    elif fmt == "sarif":
        json.dump(to_sarif(report), out, indent=2)
        out.write("\n")
    elif fmt == "cyclonedx":
        from trivy_tpu_torch.sbom.cyclonedx import encode_report

        json.dump(encode_report(report), out, indent=2)
        out.write("\n")
    elif fmt == "spdx-json":
        from trivy_tpu_torch.sbom.spdx import encode_report

        json.dump(encode_report(report), out, indent=2)
        out.write("\n")
    elif fmt == "spdx":
        from trivy_tpu_torch.sbom.spdx import encode_tag_value

        out.write(encode_tag_value(report))
    elif fmt == "template":
        from trivy_tpu_torch.report.extra import write_template

        write_template(report, template, out)
    elif fmt == "github":
        from trivy_tpu_torch.report.extra import write_github

        write_github(report, out)
    elif fmt == "cosign-vuln":
        from trivy_tpu_torch.report.extra import write_cosign_vuln

        write_cosign_vuln(report, out)
    else:
        raise ValueError(f"unknown format: {fmt} (supported: {FORMATS})")
