"""License analyzers.

Mirrors pkg/fanal/analyzer/licensing/ (license-file analyzer) and
pkg/licensing/classifier.go with a two-tier design: the primary
classifier is the batched full-text similarity matmul in
trivy_tpu_torch/license/classifier.py (the licenseclassifier analogue), and
the distinctive-phrase sieve (trivy_tpu_torch/license/phrases.py) is the
fallback for texts under the confidence threshold plus the corpus-blind
veto for licenses the full-text corpus cannot represent (AGPL-3.0 vs
GPL-3.0).  The decision tree itself lives in trivy_tpu_torch/license/decide.py
so the device license scan program (trivy_tpu_torch/programs/license.py)
shares it verbatim.

Backend selection (TRIVY_TPU_LICENSE_BACKEND):
  auto    (default) the device license program
  device  the same
  host    the direct classifier path, no sieve

The device backend runs the anchor-token gram sieve over every claimed
file and classifies only sieve candidates — on real scans virtually no
claimed file is a license text, so the ~3-20ms/text host fingerprint is
paid for the handful of true candidates instead of every COPYING-shaped
path.  Verdicts are byte-identical to the host path (the program's
necessary-condition contract; see programs/license.py).

Copied from `trivy_tpu/analyzer/license.py`; the port imports nothing from
the JAX package.  Both backends run on the analyzer's `device`
(`AnalyzerOptions.device`, default "cuda"): the program engine is kept one
per device, like `license.shared_classifier`, and a failure to build or run
it raises instead of falling back to the host classifier (the reference
pins the host path after any failure).  `version()` reads the corpus digest
of the classifier on the analyzer's device; the digest does not depend on
the device.
"""

from __future__ import annotations

import logging
import os
import re

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerOptions,
    BatchAnalyzer,
    register_analyzer,
)
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.license.decide import decide_findings
from trivy_tpu_torch.license.phrases import classify
from trivy_tpu_torch.ltypes import LICENSE_TYPE_FILE, LicenseFile

logger = logging.getLogger(__name__)

# Filenames the license-file analyzer claims
# (pkg/fanal/analyzer/licensing/license.go requiredFiles + patterns).
_LICENSE_FILE_RE = re.compile(
    r"^(licen[sc]e|copying|copyright|notice)([-._].*)?$", re.IGNORECASE
)
SKIP_DIRS = {"node_modules", ".git", "vendor"}

_BACKEND_ENV = "TRIVY_TPU_LICENSE_BACKEND"

# The license-program engine of the device backend, one per device.
_program_engines: dict = {}


def _device_engine(device):
    """The shared license-only program engine on `device`, built on first
    use (one anchor-ruleset compile per process and device); a build
    failure raises."""
    from trivy_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    eng = _program_engines.get(dev)
    if eng is None:
        from trivy_tpu_torch.programs import LicenseScanProgram, make_program_engine

        eng = _program_engines[dev] = make_program_engine(
            [LicenseScanProgram()], device=dev
        )
    return eng


def _decide_batch(paths: list[str], texts: list[str], device) -> list[list]:
    """Per-file findings via the selected backend on `device`.  Device and
    host run the same decision tree (license/decide.py); the device backend
    just prunes non-candidates with the anchor sieve first."""
    backend = os.environ.get(_BACKEND_ENV, "auto").strip().lower() or "auto"
    if backend not in ("auto", "device", "host"):
        logger.warning("unknown %s=%r; using auto", _BACKEND_ENV, backend)
        backend = "auto"
    if backend == "host":
        return decide_findings(texts, device=device)
    items = [
        (p, t.encode("utf-8", errors="replace")) for p, t in zip(paths, texts)
    ]
    return _device_engine(device).scan_programs(items)["license"]


class LicenseFileAnalyzer(BatchAnalyzer):
    """analyzer/licensing/license.go + pkg/licensing/classifier.go.

    Batch-first: every claimed license file in the scan classifies in ONE
    hashed-trigram similarity matmul (trivy_tpu_torch/license/classifier.py) —
    the full-text analogue of google/licenseclassifier — with the phrase
    sieve as fallback for texts below the confidence threshold (heavily
    edited or truncated license files).  On the device backend the
    anchor-token gram sieve prunes the batch first (see module
    docstring)."""

    def __init__(self) -> None:
        self._device = DEFAULT_DEVICE

    def init(self, options: AnalyzerOptions) -> None:
        self._device = options.device

    def type(self) -> str:
        return "license-file"

    def version(self) -> int:
        # v1 was the phrase sieve alone.  The classification outcome also
        # depends on the host's license corpus (/usr/share/common-licenses
        # presence and contents), so the corpus digest participates in the
        # version — two hosts with different corpora must not share
        # cached blobs for the same artifact.
        from trivy_tpu_torch.license import shared_classifier

        return 2_000_000 + shared_classifier(self._device).corpus_digest % 1_000_000

    def required(self, file_path: str, size: int, mode: int) -> bool:
        parts = file_path.split("/")
        if SKIP_DIRS.intersection(parts[:-1]):
            return False
        return bool(_LICENSE_FILE_RE.match(parts[-1])) and size < 1 << 20

    def analyze_batch(self, inputs: list) -> AnalysisResult | None:
        if not inputs:
            return None
        texts = [
            inp.content.decode("utf-8", errors="replace") for inp in inputs
        ]
        paths = [inp.file_path for inp in inputs]
        licenses = []
        for inp, findings in zip(inputs, _decide_batch(paths, texts, self._device)):
            if not findings:
                continue
            licenses.append(
                LicenseFile(
                    license_type=LICENSE_TYPE_FILE,
                    file_path=inp.file_path,
                    findings=findings,
                )
            )
        return AnalysisResult(licenses=licenses) if licenses else None


class DpkgLicenseAnalyzer(Analyzer):
    """analyzer/licensing dpkg copyright files
    (usr/share/doc/<pkg>/copyright) — machine-readable DEP-5 headers."""

    _RE = re.compile(r"^usr/share/doc/([^/]+)/copyright$")

    def type(self) -> str:
        return "dpkg-license"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return bool(self._RE.match(file_path))

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        m = self._RE.match(inp.file_path)
        pkg_name = m.group(1) if m else ""
        licenses: list[str] = []
        for line in inp.content.decode("utf-8", errors="replace").splitlines():
            if line.lower().startswith("license:"):
                name = line.split(":", 1)[1].strip()
                if name and name not in licenses:
                    licenses.append(name)
        if not licenses:
            findings = classify(inp.content)
            licenses = [f.name for f in findings]
        if not licenses:
            return None
        from trivy_tpu_torch.ltypes import LicenseFinding

        return AnalysisResult(
            licenses=[
                LicenseFile(
                    license_type="dpkg",
                    file_path=inp.file_path,
                    pkg_name=pkg_name,
                    findings=[LicenseFinding.of(n) for n in licenses],
                )
            ]
        )


register_analyzer(LicenseFileAnalyzer)
register_analyzer(DpkgLicenseAnalyzer)
