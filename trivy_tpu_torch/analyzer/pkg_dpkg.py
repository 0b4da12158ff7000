"""dpkg package database analyzer (pkg/fanal/analyzer/pkg/dpkg/dpkg.go).

Parses `var/lib/dpkg/status` and `var/lib/dpkg/status.d/*` — RFC822 stanzas
with Package/Status/Version/Source/Architecture fields.  The `Source:` field
may carry an explicit version in parentheses.

Copied from `trivy_tpu/analyzer/pkg_dpkg.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Package, PackageInfo
from trivy_tpu_torch.detector.version_cmp import _deb_split as split_version

STATUS_FILE = "var/lib/dpkg/status"
STATUS_DIR = "var/lib/dpkg/status.d/"

_SOURCE_RE = re.compile(r"^(\S+)(?:\s+\((.+)\))?$")


def parse_dpkg_status(content: bytes) -> list[Package]:
    packages: list[Package] = []
    for stanza in re.split(r"\n\s*\n", content.decode("utf-8", errors="replace")):
        fields: dict[str, str] = {}
        key = ""
        for line in stanza.splitlines():
            if line.startswith((" ", "\t")):
                if key:
                    fields[key] += "\n" + line.strip()
                continue
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()

        name = fields.get("Package", "")
        version = fields.get("Version", "")
        status = fields.get("Status", "installed")
        if not name or not version or "installed" not in status.split():
            continue

        src_name, src_version = name, version
        if fields.get("Source"):
            m = _SOURCE_RE.match(fields["Source"])
            if m:
                src_name = m.group(1)
                if m.group(2):
                    src_version = m.group(2)

        epoch, _, _ = split_version(version)
        s_epoch, _, _ = split_version(src_version)
        depends = []
        for dep in fields.get("Depends", "").split(","):
            dep = dep.strip().split(" ")[0].split(":")[0]
            if dep:
                depends.append(dep)

        packages.append(
            Package(
                id=f"{name}@{version}",
                name=name,
                version=version,
                epoch=epoch,
                arch=fields.get("Architecture", ""),
                src_name=src_name,
                src_version=src_version,
                src_epoch=s_epoch,
                depends_on=sorted(set(depends)),
            )
        )
    return packages


class DpkgAnalyzer(Analyzer):
    def type(self) -> str:
        return "dpkg"

    def version(self) -> int:
        return 3

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == STATUS_FILE or file_path.startswith(STATUS_DIR)

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        packages = parse_dpkg_status(inp.content)
        if not packages:
            return None
        return AnalysisResult(
            package_infos=[
                PackageInfo(file_path=inp.file_path, packages=packages)
            ]
        )


register_analyzer(DpkgAnalyzer)
