"""Table report renderer.

Mirrors pkg/report/table/ — per-result sections with a severity summary line,
and the secret sub-renderer (table/secret.go:24-111) that prints each finding
with its highlighted code context.

Copied from `trivy_tpu/report/table.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from typing import IO

from trivy_tpu_torch.ftypes import Report, Result, ResultClass

SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]


def _severity_counts(findings) -> dict[str, int]:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        sev = getattr(f, "severity", "UNKNOWN") or "UNKNOWN"
        counts[sev if sev in counts else "UNKNOWN"] += 1
    return counts


def _summary_line(counts: dict[str, int], total: int) -> str:
    parts = ", ".join(f"{s}: {counts[s]}" for s in SEVERITIES if counts[s])
    return f"Total: {total} ({parts})" if parts else f"Total: {total}"


def write_table(report: Report, out: IO[str]) -> None:
    wrote = False
    for result in report.results:
        if result.is_empty():
            continue
        wrote = True
        if result.result_class == ResultClass.SECRET:
            _write_secret_result(result, out)
        else:
            _write_generic_result(result, out)
    if not wrote:
        out.write(f"{report.artifact_name}: no findings\n")


def _rule(out: IO[str], title: str) -> None:
    out.write("\n" + title + "\n")
    out.write("=" * max(len(title), 8) + "\n")


def _write_secret_result(result: Result, out: IO[str]) -> None:
    """table/secret.go:24-111."""
    _rule(out, f"{result.target} (secrets)")
    counts = _severity_counts(result.secrets)
    out.write(_summary_line(counts, len(result.secrets)) + "\n\n")
    for f in result.secrets:
        out.write(f"{f.severity}: {f.category} ({f.rule_id})\n")
        out.write(f"{f.title}\n")
        out.write("-" * 40 + "\n")
        for line in f.code.lines:
            marker = " " if not line.is_cause else ">"
            out.write(f"{line.number:4d} {marker} {line.content}\n")
        out.write("-" * 40 + "\n\n")


def _write_generic_result(result: Result, out: IO[str]) -> None:
    findings = (
        result.vulnerabilities or result.misconfigurations or result.licenses
    )
    _rule(out, f"{result.target} ({result.result_class.value})")
    counts = _severity_counts(findings)
    out.write(_summary_line(counts, len(findings)) + "\n\n")
    for f in findings:
        fid = (
            getattr(f, "vulnerability_id", "")
            or getattr(f, "id", "")
            or getattr(f, "name", "")
        )
        sev = getattr(f, "severity", "UNKNOWN")
        title = getattr(f, "title", "") or getattr(f, "message", "")
        pkg = getattr(f, "pkg_name", "")
        installed = getattr(f, "installed_version", "")
        fixed = getattr(f, "fixed_version", "")
        cols = [c for c in (fid, sev, pkg, installed, fixed, title) if c]
        out.write("  " + " | ".join(str(c) for c in cols) + "\n")
    out.write("\n")
