"""Result filtering (a copy of `trivy_tpu/result/`)."""

from trivy_tpu_torch.result.filter import FilterOptions, filter_report

__all__ = ["FilterOptions", "filter_report"]
