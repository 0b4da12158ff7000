"""Language-ecosystem vulnerability detectors.

Mirrors pkg/detector/library (driver.go:25-84): per-ecosystem drivers with
their version comparators; advisories carry vulnerable ranges (language DBs)
or fixed versions.

Copied from `trivy_tpu/detector/library.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.atypes import Application
from trivy_tpu_torch.db.vulndb import VulnDB
from trivy_tpu_torch.detector.severity import resolve_severity
from trivy_tpu_torch.detector.version_cmp import COMPARATORS, version_in_range
from trivy_tpu_torch.ftypes import DetectedVulnerability

# app type -> (db source, comparator flavor); mirrors driver.go:24-90
_ECOSYSTEMS: dict[str, tuple[str, str]] = {
    "npm": ("npm", "semver"),
    "yarn": ("npm", "semver"),
    "pnpm": ("npm", "semver"),
    "node-pkg": ("npm", "semver"),
    "pip": ("pip", "pep440"),
    "pipenv": ("pip", "pep440"),
    "poetry": ("pip", "pep440"),
    "python-pkg": ("pip", "pep440"),
    "gomod": ("go", "semver"),
    "gobinary": ("go", "semver"),
    "cargo": ("cargo", "semver"),
    "rustbinary": ("cargo", "semver"),
    "composer": ("composer", "semver"),
    "bundler": ("rubygems", "generic"),
    "gemspec": ("rubygems", "generic"),
    "nuget": ("nuget", "semver"),
    "pom": ("maven", "maven"),
    "gradle": ("maven", "maven"),
    "jar": ("maven", "maven"),
    "war": ("maven", "maven"),
    "pub": ("pub", "generic"),
    "hex": ("erlang", "generic"),
    "conan": ("conan", "generic"),
    "swift": ("swift", "generic"),
    "cocoapods": ("cocoapods", "generic"),
    "dotnet-core": ("nuget", "semver"),
    "packages-props": ("nuget", "semver"),
    "julia": ("julia", "semver"),
    # conda-pkg / conda-environment: SBOM-only, no vuln DB (driver.go:75-77)
}


@dataclass
class LibraryDetector:
    db: VulnDB

    def detect_app(self, app: Application) -> list[DetectedVulnerability]:
        eco = _ECOSYSTEMS.get(app.app_type)
        if eco is None:
            return []
        source, flavor = eco
        cmp = COMPARATORS[flavor]

        out: list[DetectedVulnerability] = []
        for pkg in app.packages:
            if not pkg.version:
                # Unversioned packages (unstamped Go '(devel)' main modules,
                # unpinned conda specs) compare below every fixed version and
                # would match every advisory — skip, don't false-positive.
                continue
            for adv in self.db.advisories(source, pkg.name):
                vulnerable = False
                if adv.vulnerable_versions:
                    vulnerable = version_in_range(
                        pkg.version, adv.vulnerable_versions, flavor
                    )
                elif adv.fixed_version:
                    vulnerable = cmp(pkg.version, adv.fixed_version) < 0
                if not vulnerable:
                    continue
                severity, severity_source = resolve_severity(adv, source)
                out.append(
                    DetectedVulnerability(
                        vulnerability_id=adv.vulnerability_id,
                        pkg_id=pkg.id,
                        pkg_name=pkg.name,
                        installed_version=pkg.version,
                        fixed_version=adv.fixed_version,
                        severity=severity,
                        severity_source=severity_source,
                        title=adv.title,
                        description=adv.description,
                        references=list(adv.references),
                        layer=pkg.layer,
                        status="fixed" if adv.fixed_version else "affected",
                    )
                )
        return out
