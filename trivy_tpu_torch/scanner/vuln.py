"""Vulnerability scanning: ArtifactDetail -> per-target vuln Results.

Mirrors pkg/scanner/ospkg/scan.go + pkg/scanner/langpkg/scan.go: the OS
package set becomes one result targeted "<artifact> (<family> <release>)";
each application becomes a result targeted at its lockfile path.

Copied from `trivy_tpu/scanner/vuln.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.atypes import ArtifactDetail
from trivy_tpu_torch.db.vulndb import VulnDB
from trivy_tpu_torch.detector.library import LibraryDetector
from trivy_tpu_torch.detector.ospkg import OSPkgDetector
from trivy_tpu_torch.ftypes import Result, ResultClass


def init_vuln_scanner(
    db_dir: str = "", cache_dir: str = ""
) -> "VulnerabilityScanner | None":
    """Single DB bootstrap used by the runner and the RPC server: resolve
    db_dir (explicit, or <cache_dir>/db), open, wrap.  An explicitly given
    but missing directory is an error, not a silent all-clear."""
    import os

    from trivy_tpu_torch.db.vulndb import load_db

    explicit = bool(db_dir)
    if not db_dir and cache_dir:
        db_dir = os.path.join(cache_dir, "db")
    if not db_dir:
        return None
    db = load_db(db_dir)
    if db is None:
        if explicit:
            raise FileNotFoundError(f"vulnerability DB not found: {db_dir}")
        return None
    return VulnerabilityScanner(db)


def os_pkgs_result(target: str, detail, vulns, packages) -> Result:
    """The OS-packages result shape — one definition so the DB-less
    inventory path (service.py) and detection agree on target naming."""
    return Result(
        target=f"{target} ({detail.os.family} {detail.os.name})",
        result_class=ResultClass.OS_PKGS,
        result_type=detail.os.family,
        vulnerabilities=sorted(
            vulns, key=lambda v: (v.pkg_name, v.vulnerability_id)
        ),
        packages=list(packages),
    )


def lang_pkgs_result(app, vulns, packages) -> Result:
    return Result(
        target=app.file_path or app.app_type,
        result_class=ResultClass.LANG_PKGS,
        result_type=app.app_type,
        vulnerabilities=sorted(
            vulns, key=lambda v: (v.pkg_name, v.vulnerability_id)
        ),
        packages=list(packages),
    )


def has_os_pkgs(detail) -> bool:
    return (
        detail.os is not None
        and not detail.os.is_empty()
        and bool(detail.packages)
    )


@dataclass
class VulnerabilityScanner:
    db: VulnDB

    def detect(self, target: str, detail: ArtifactDetail, options) -> list[Result]:
        results: list[Result] = []
        pkg_types = getattr(options, "pkg_types", ["os", "library"])
        list_all = getattr(options, "list_all_packages", False)

        if "os" in pkg_types and has_os_pkgs(detail):
            vulns = OSPkgDetector(self.db).detect(detail.os, detail.packages)
            if vulns or list_all:
                results.append(
                    os_pkgs_result(
                        target, detail, vulns,
                        detail.packages if list_all else [],
                    )
                )

        if "library" in pkg_types:
            detector = LibraryDetector(self.db)
            for app in detail.applications:
                vulns = detector.detect_app(app)
                if not vulns and not list_all:
                    continue
                results.append(
                    lang_pkgs_result(
                        app, vulns, app.packages if list_all else []
                    )
                )
        return results
