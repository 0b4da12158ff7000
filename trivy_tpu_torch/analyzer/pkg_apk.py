"""apk package database analyzer (pkg/fanal/analyzer/pkg/apk/apk.go).

Parses `lib/apk/db/installed` — stanzas of single-letter fields:
P: name, V: version, A: arch, L: license, o: origin (source package),
D/r: dependencies/provides.

Copied from `trivy_tpu/analyzer/pkg_apk.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Package, PackageInfo

REQUIRED_FILE = "lib/apk/db/installed"


def parse_apk_db(content: bytes) -> tuple[list[Package], list[str]]:
    """Returns (packages, installed_files): F:/R: stanza fields list each
    package's directory/file entries (apk.go collects them for the
    system-file filter, SystemInstalledFiles)."""
    packages: list[Package] = []
    installed_files: list[str] = []
    cur: dict[str, str] = {}
    depends: list[str] = []
    cur_dir = ""

    def flush() -> None:
        nonlocal cur, depends, cur_dir
        cur_dir = ""
        if cur.get("P") and cur.get("V"):
            name, version = cur["P"], cur["V"]
            packages.append(
                Package(
                    id=f"{name}@{version}",
                    name=name,
                    version=version,
                    arch=cur.get("A", ""),
                    src_name=cur.get("o", name),
                    src_version=version,
                    licenses=[l for l in cur.get("L", "").split(" AND ") if l],
                    depends_on=sorted(set(depends)),
                )
            )
        cur, depends = {}, []

    for raw in content.decode("utf-8", errors="replace").splitlines():
        if not raw.strip():
            flush()
            continue
        key, _, value = raw.partition(":")
        if key == "F":
            cur_dir = value
            continue
        if key == "R":
            installed_files.append(f"{cur_dir}/{value}" if cur_dir else value)
            continue
        if key == "D":
            for dep in value.split():
                dep = dep.split("=")[0].split("<")[0].split(">")[0].split("~")[0]
                if dep and not dep.startswith("!"):
                    depends.append(dep)
        elif key:
            cur[key] = value
    flush()
    return packages, installed_files


class ApkAnalyzer(Analyzer):
    def type(self) -> str:
        return "apk"

    def version(self) -> int:
        return 2

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == REQUIRED_FILE

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        packages, installed_files = parse_apk_db(inp.content)
        if not packages:
            return None
        return AnalysisResult(
            package_infos=[
                PackageInfo(file_path=inp.file_path, packages=packages)
            ],
            system_installed_files=installed_files,
        )


register_analyzer(ApkAnalyzer)
