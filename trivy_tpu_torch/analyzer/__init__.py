"""Analyzer plugin layer (a copy of `trivy_tpu/analyzer/`: the group, the
secret and license analyzers, the misconfig `config` analyzers and the
package analyzers)."""

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
