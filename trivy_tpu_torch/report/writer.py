"""Report writer dispatch (pkg/report/writer.go:28 format switch).

Copied from `trivy_tpu/report/writer.py`; the port imports nothing from the
JAX package.  It writes `table`, `json` and `sarif`.  The other formats
(`cyclonedx`, `spdx`, `spdx-json`, `template`, `github`, `cosign-vuln`)
need `sbom/`, `report/extra.py` and `purl.py`, which wait for ROADMAP A13d:
asked for one, the writer raises `FormatNotPorted`.
"""

from __future__ import annotations

import json
import sys
from typing import IO

from trivy_tpu_torch.ftypes import Report
from trivy_tpu_torch.report.sarif import to_sarif
from trivy_tpu_torch.report.table import write_table

FORMATS = ["table", "json", "sarif"]
# The reference's other formats and the ROADMAP item that ports them.
NOT_PORTED_FORMATS = {
    fmt: "A13d"
    for fmt in ("cyclonedx", "spdx", "spdx-json", "template", "github", "cosign-vuln")
}


class FormatNotPorted(ValueError):
    """A report format of the reference the port does not write yet."""


def check_format(fmt: str) -> None:
    """Raise for a format the port cannot write, before any scan runs."""
    if fmt in NOT_PORTED_FORMATS:
        raise FormatNotPorted(
            f"--format {fmt} is not ported yet (ROADMAP {NOT_PORTED_FORMATS[fmt]}: "
            "sbom/, report/extra.py, purl.py)"
        )
    if fmt not in FORMATS:
        raise ValueError(f"unknown format: {fmt} (supported: {FORMATS})")


def write_report(
    report: Report,
    fmt: str = "table",
    out: IO[str] | None = None,
) -> None:
    check_format(fmt)
    out = out if out is not None else sys.stdout
    if fmt == "json":
        json.dump(report.to_json(), out, indent=2)
        out.write("\n")
    elif fmt == "table":
        write_table(report, out)
    else:
        json.dump(to_sarif(report), out, indent=2)
        out.write("\n")
