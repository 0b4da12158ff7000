"""Analyzer plugin layer (a copy of `trivy_tpu/analyzer/`: the group, the
secret and license analyzers and the package analyzers; the misconfig
`config` analyzers wait for ROADMAP A13d)."""

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
