"""OS package vulnerability detectors.

Mirrors pkg/detector/ospkg (driver map detect.go:32-49): per-family drivers
that look up advisories by (release bucket, source package name) and compare
the installed version against the fixed version with the family's comparator.

Copied from `trivy_tpu/detector/ospkg.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch.atypes import OS, Package
from trivy_tpu_torch.db.vulndb import VulnDB
from trivy_tpu_torch.detector.eol import is_supported_version
from trivy_tpu_torch.detector.severity import resolve_severity
from trivy_tpu_torch.detector.version_cmp import COMPARATORS
from trivy_tpu_torch.ftypes import DetectedVulnerability

# family -> (db source prefix, version comparator flavor, release precision)
_DRIVERS: dict[str, tuple[str, str, int]] = {
    "alpine": ("alpine", "apk", 2),  # bucket "alpine 3.15"
    "wolfi": ("wolfi", "apk", 0),
    "chainguard": ("chainguard", "apk", 0),
    "debian": ("debian", "deb", 1),  # bucket "debian 11"
    "ubuntu": ("ubuntu", "deb", 2),  # bucket "ubuntu 22.04"
    "redhat": ("redhat", "rpm", 1),
    "centos": ("centos", "rpm", 1),
    "rocky": ("rocky", "rpm", 1),
    "alma": ("alma", "rpm", 1),
    "oracle": ("oracle", "rpm", 1),
    "amazon": ("amazon", "rpm", 1),
    "photon": ("photon", "rpm", 1),
    "cbl-mariner": ("cbl-mariner", "rpm", 1),
    "fedora": ("fedora", "rpm", 1),
    # SUSE family (detect.go:43-44; trivy-db buckets "SUSE Linux
    # Enterprise 15.4" / "openSUSE Leap 15.4" resolve through the
    # BoltVulnDB alias map)
    "suse linux enterprise server": ("suse", "rpm", 2),
    "opensuse-leap": ("opensuse-leap", "rpm", 2),
}


def _release_bucket(prefix: str, name: str, precision: int) -> str:
    if precision == 0:
        return prefix
    # Codename suffixes ("2 (Karoo)") and 'release N' forms never reach
    # the bucket: the reference strips to the first whitespace field
    # before versioning (amazon driver strings.Fields(osVer)[0]).
    name = name.split()[0] if name.split() else name
    parts = name.split(".")
    return f"{prefix} {'.'.join(parts[:precision])}"


@dataclass
class OSPkgDetector:
    """detector/ospkg Detect (detect.go:52)."""

    db: VulnDB

    def supported(self, family: str) -> bool:
        return family in _DRIVERS

    def detect(
        self, os_info: OS, packages: list[Package]
    ) -> list[DetectedVulnerability]:
        driver = _DRIVERS.get(os_info.family)
        if driver is None:
            return []
        prefix, flavor, precision = driver
        source = _release_bucket(prefix, os_info.name, precision)
        cmp = COMPARATORS[flavor]
        # EOL gate (detect.go:32-49 drivers + osver.Supported): warn on
        # outdated or unknown OS versions; detection proceeds regardless.
        release = source.partition(" ")[2] or os_info.name
        is_supported_version(os_info.family, release)

        out: list[DetectedVulnerability] = []
        for pkg in packages:
            names = {pkg.name, pkg.src_name} - {""}
            seen: set[str] = set()
            for name in sorted(names):
                for adv in self.db.advisories(source, name):
                    if adv.vulnerability_id in seen:
                        continue
                    installed = pkg.version
                    if pkg.release:
                        installed = f"{pkg.version}-{pkg.release}"
                    if pkg.epoch:
                        # utils.FormatVersion includes the epoch; compare_rpm
                        # and compare_deb both parse the N: prefix.
                        installed = f"{pkg.epoch}:{installed}"
                    if adv.fixed_version and cmp(installed, adv.fixed_version) >= 0:
                        continue
                    seen.add(adv.vulnerability_id)
                    severity, severity_source = resolve_severity(adv, prefix)
                    out.append(
                        DetectedVulnerability(
                            vulnerability_id=adv.vulnerability_id,
                            pkg_id=pkg.id,
                            pkg_name=pkg.name,
                            installed_version=installed,
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
