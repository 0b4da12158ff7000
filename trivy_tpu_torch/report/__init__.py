"""Report writers (a copy of `trivy_tpu/report/`: table, json, sarif)."""

from trivy_tpu_torch.report.writer import write_report

__all__ = ["write_report"]
