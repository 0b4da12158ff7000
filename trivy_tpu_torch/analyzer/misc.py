"""Discovery analyzers: embedded SBOMs, executable digests, Red Hat
buildinfo, installed Python package metadata.

Mirrors pkg/fanal/analyzer/{sbom,executable,buildinfo} and the python-pkg
analyzer under language/python/packaging.

Copied from `trivy_tpu/analyzer/misc.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import hashlib
import json
import re

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Application, Package

# ---------------------------------------------------------------------------
# Embedded SBOMs (pkg/fanal/analyzer/sbom/sbom.go)
# ---------------------------------------------------------------------------

_SBOM_SUFFIXES = (".spdx", ".spdx.json", ".cdx", ".cdx.json")


class SbomFileAnalyzer(Analyzer):
    """SBOMs shipped inside the artifact (e.g. bitnami images publish
    per-component SPDX files) feed their packages straight into the scan."""

    def type(self) -> str:
        return "sbom"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.lower().endswith(_SBOM_SUFFIXES) and size < 8 << 20

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        from trivy_tpu_torch.sbom import decode_sbom

        try:
            detail, _fmt = decode_sbom(inp.content.decode("utf-8", "replace"))
        except Exception:
            return None
        apps = list(detail.applications)
        # Bitnami layout: jars listed in opt/bitnami SBOMs exist next to the
        # SBOM file; anchor the application path there (sbom.go:45-57).
        for app in apps:
            if not app.file_path:
                app.file_path = inp.file_path
        # OS packages (apk/deb/rpm purls) land in detail.packages; wrap
        # them like build_sbom_reference does so they are not dropped.
        pkg_infos = list(detail.package_infos)
        if detail.packages:
            from trivy_tpu_torch.atypes import PackageInfo

            pkg_infos.append(
                PackageInfo(file_path=inp.file_path, packages=detail.packages)
            )
        if not apps and not pkg_infos:
            return None
        return AnalysisResult(package_infos=pkg_infos, applications=apps)


# ---------------------------------------------------------------------------
# Executable digests (pkg/fanal/analyzer/executable) — Rekor lookup keys
# ---------------------------------------------------------------------------

_ELF_MAGIC = b"\x7fELF"


class ExecutableAnalyzer(Analyzer):
    """Disabled unless the scan opts into Rekor SBOM sources
    (--sbom-sources rekor): hashing every binary costs a full-content pass
    per executable and nothing else consumes the digests (the reference
    gates the same way, artifact.Option.RekorURL/SBOMSources)."""

    def __init__(self) -> None:
        self._enabled = False

    def init(self, options) -> None:
        self._enabled = "rekor" in getattr(options, "sbom_sources", [])

    def version(self) -> int:
        return 1

    def type(self) -> str:
        return "executable"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return self._enabled and bool(mode & 0o111) and size > 0

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        if not inp.content.startswith(_ELF_MAGIC):
            return None
        digest = "sha256:" + hashlib.sha256(inp.content).hexdigest()
        result = AnalysisResult()
        result.configs.append(
            {
                "Type": "executable",
                "FilePath": inp.file_path,
                "Digest": digest,
            }
        )
        return result


# ---------------------------------------------------------------------------
# Red Hat buildinfo (pkg/fanal/analyzer/buildinfo)
# ---------------------------------------------------------------------------

_NVR_RE = re.compile(r'"com\.redhat\.component"\s*=\s*"([^"]+)"')
_ARCH_RE = re.compile(r'"architecture"\s*=\s*"([^"]+)"')
_RELEASE_RE = re.compile(r'"release"\s*=\s*"([^"]+)"')
_VERSION_RE = re.compile(r'"version"\s*=\s*"([^"]+)"')


class ContentManifestAnalyzer(Analyzer):
    """root/buildinfo/content_manifests/*.json -> content sets (the Red Hat
    repo identifiers vuln matching keys off)."""

    def type(self) -> str:
        return "redhat-content-manifest"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return (
            file_path.startswith("root/buildinfo/content_manifests/")
            and file_path.endswith(".json")
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except ValueError:
            return None
        sets = doc.get("content_sets") or []
        if not sets:
            return None
        result = AnalysisResult()
        result.build_info = {"ContentSets": list(sets)}
        return result


class DockerfileLabelAnalyzer(Analyzer):
    """root/buildinfo/Dockerfile-* -> nvr + arch from Red Hat labels."""

    def type(self) -> str:
        return "redhat-dockerfile"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        name = file_path.rsplit("/", 1)[-1]
        return file_path.startswith("root/buildinfo/") and name.startswith(
            "Dockerfile-"
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", errors="replace")
        comp = _NVR_RE.search(text)
        arch = _ARCH_RE.search(text)
        if not comp:
            return None
        version = _VERSION_RE.search(text)
        release = _RELEASE_RE.search(text)
        nvr = comp.group(1)
        if version and release:
            nvr = f"{comp.group(1)}-{version.group(1)}-{release.group(1)}"
        result = AnalysisResult()
        result.build_info = {
            "Nvr": nvr,
            "Arch": arch.group(1) if arch else "",
        }
        return result


# ---------------------------------------------------------------------------
# Installed Python packages (language/python/packaging) — egg-info/dist-info
# ---------------------------------------------------------------------------

_META_NAME = re.compile(r"^Name:\s*(.+)$", re.MULTILINE)
_META_VERSION = re.compile(r"^Version:\s*(.+)$", re.MULTILINE)
_META_LICENSE = re.compile(r"^License:\s*(.+)$", re.MULTILINE)


class PythonPkgAnalyzer(Analyzer):
    """Installed distributions: *.egg-info, *.egg-info/PKG-INFO,
    *.dist-info/METADATA."""

    def type(self) -> str:
        return "python-pkg"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        if file_path.endswith(".egg-info"):
            return True
        return file_path.endswith(
            (".egg-info/PKG-INFO", ".dist-info/METADATA")
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", errors="replace")
        name = _META_NAME.search(text)
        version = _META_VERSION.search(text)
        if not name or not version:
            return None
        lic = _META_LICENSE.search(text)
        pkg = Package(
            id=f"{name.group(1).strip()}@{version.group(1).strip()}",
            name=name.group(1).strip().lower(),
            version=version.group(1).strip(),
            licenses=[lic.group(1).strip()] if lic else [],
            file_path=inp.file_path,
        )
        return AnalysisResult(
            applications=[
                Application(
                    app_type="python-pkg",
                    file_path=inp.file_path,
                    packages=[pkg],
                )
            ]
        )


register_analyzer(SbomFileAnalyzer)
register_analyzer(ExecutableAnalyzer)
register_analyzer(ContentManifestAnalyzer)
register_analyzer(DockerfileLabelAnalyzer)
register_analyzer(PythonPkgAnalyzer)
