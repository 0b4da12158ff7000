"""Analyzer plugin layer (a copy of `trivy_tpu/analyzer/`: the group and
the secret and license analyzers; the rest wait for ROADMAP A13c/A13d)."""

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerGroup,
    AnalyzerOptions,
    BatchAnalyzer,
    register_analyzer,
    registered_analyzers,
)

__all__ = [
    "AnalysisInput",
    "AnalysisResult",
    "Analyzer",
    "AnalyzerGroup",
    "AnalyzerOptions",
    "BatchAnalyzer",
    "register_analyzer",
    "registered_analyzers",
]
