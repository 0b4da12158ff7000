"""OS detection analyzers.

Mirrors pkg/fanal/analyzer/os/: the generic os-release analyzer
(release/release.go) plus the distro-specific release files (alpine, debian,
ubuntu, amazon, redhat-base families).

Copied from `trivy_tpu/analyzer/os_release.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import OS

# OS family constants (pkg/fanal/analyzer/const.go / types const)
ALPINE = "alpine"
DEBIAN = "debian"
UBUNTU = "ubuntu"
REDHAT = "redhat"
CENTOS = "centos"
ROCKY = "rocky"
ALMA = "alma"
FEDORA = "fedora"
ORACLE = "oracle"
AMAZON = "amazon"
SUSE_ENTERPRISE = "suse linux enterprise server"
OPENSUSE = "opensuse"
OPENSUSE_LEAP = "opensuse-leap"
OPENSUSE_TUMBLEWEED = "opensuse-tumbleweed"
PHOTON = "photon"
WOLFI = "wolfi"
CHAINGUARD = "chainguard"
MARINER = "cbl-mariner"

# release/release.go:51-77 ID -> family mapping
_OS_RELEASE_IDS = {
    "alpine": ALPINE,
    "opensuse-tumbleweed": OPENSUSE_TUMBLEWEED,
    "opensuse-leap": OPENSUSE_LEAP,
    "opensuse": OPENSUSE_LEAP,
    "sles": SUSE_ENTERPRISE,
    "photon": PHOTON,
    "wolfi": WOLFI,
    "chainguard": CHAINGUARD,
    "mariner": MARINER,
    "fedora": FEDORA,
}


def parse_os_release(content: bytes) -> tuple[str, str]:
    """Returns (id, version_id)."""
    os_id = version_id = ""
    for line in content.decode("utf-8", errors="replace").splitlines():
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("\"'")
        if key == "ID":
            os_id = value
        elif key == "VERSION_ID":
            version_id = value
    return os_id, version_id


class OSReleaseAnalyzer(Analyzer):
    """analyzer/os/release/release.go."""

    REQUIRED = {"etc/os-release", "usr/lib/os-release"}

    def type(self) -> str:
        return "os-release"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path in self.REQUIRED

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        os_id, version_id = parse_os_release(inp.content)
        family = _OS_RELEASE_IDS.get(os_id)
        if family is None or not version_id:
            return None
        return AnalysisResult(os=OS(family=family, name=version_id))


class AlpineReleaseAnalyzer(Analyzer):
    """analyzer/os/alpine/alpine.go — etc/alpine-release holds the version."""

    def type(self) -> str:
        return "alpine-release"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == "etc/alpine-release"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        ver = inp.content.decode("utf-8", errors="replace").strip()
        if not ver:
            return None
        return AnalysisResult(os=OS(family=ALPINE, name=ver))


class DebianVersionAnalyzer(Analyzer):
    """analyzer/os/debian — etc/debian_version (when no os-release ID)."""

    def type(self) -> str:
        return "debian-version"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == "etc/debian_version"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        ver = inp.content.decode("utf-8", errors="replace").strip()
        if not ver or "/" in ver:  # sid/testing strings carry no version
            return None
        return AnalysisResult(os=OS(family=DEBIAN, name=ver))


class LsbReleaseAnalyzer(Analyzer):
    """analyzer/os/ubuntu — etc/lsb-release (DISTRIB_ID=Ubuntu)."""

    def type(self) -> str:
        return "ubuntu"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == "etc/lsb-release"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        fields = {}
        for line in inp.content.decode("utf-8", errors="replace").splitlines():
            k, _, v = line.partition("=")
            fields[k.strip()] = v.strip().strip('"')
        if fields.get("DISTRIB_ID") == "Ubuntu" and fields.get("DISTRIB_RELEASE"):
            return AnalysisResult(
                os=OS(family=UBUNTU, name=fields["DISTRIB_RELEASE"])
            )
        return None


class RedHatReleaseAnalyzer(Analyzer):
    """analyzer/os/redhatbase — etc/redhat-release & friends."""

    FILES = {
        "etc/redhat-release",
        "etc/centos-release",
        "etc/rocky-release",
        "etc/almalinux-release",
        "etc/oracle-release",
        "etc/fedora-release",
        "etc/system-release",
    }
    _FAMILIES = [
        ("CentOS", CENTOS),
        ("Rocky", ROCKY),
        ("AlmaLinux", ALMA),
        ("Oracle", ORACLE),
        ("Fedora", FEDORA),
        ("Amazon", AMAZON),
        ("Red Hat", REDHAT),
    ]

    def type(self) -> str:
        return "redhatbase"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path in self.FILES

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        import re

        text = inp.content.decode("utf-8", errors="replace")
        m = re.search(r"(\d+(?:\.\d+)*)", text)
        if not m:
            return None
        for marker, family in self._FAMILIES:
            if marker.lower() in text.lower():
                return AnalysisResult(os=OS(family=family, name=m.group(1)))
        return None


class AmazonReleaseAnalyzer(Analyzer):
    """analyzer/os/amazonlinux/amazonlinux.go — etc/system-release (AL1/2)
    or usr/lib/system-release (AL2022/2023); version text follows the
    'Amazon Linux [release]' prefix."""

    REQUIRED = {"etc/system-release", "usr/lib/system-release"}

    def type(self) -> str:
        return "amazon"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path in self.REQUIRED

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        for line in inp.content.decode("utf-8", "replace").splitlines():
            fields = line.split()
            if not line.startswith("Amazon Linux") or len(fields) < 3:
                continue
            # "Amazon Linux release 2 (Karoo)" / "Amazon Linux release
            # 2023.3.x" -> version after 'release'; "Amazon Linux 2023.x"
            # (AL2022/2023 usr/lib form) has no 'release' token.
            if fields[2] == "release" and len(fields) >= 4:
                name = " ".join(fields[3:])
            else:
                name = " ".join(fields[2:])
            return AnalysisResult(os=OS(family=AMAZON, name=name))
        return None


class MarinerReleaseAnalyzer(Analyzer):
    """analyzer/os/mariner/mariner.go — etc/mariner-release:
    'CBL-Mariner <version>'."""

    def type(self) -> str:
        return "cbl-mariner"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path == "etc/mariner-release"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        for line in inp.content.decode("utf-8", "replace").splitlines():
            fields = line.split()
            if line.startswith("CBL-Mariner") and len(fields) >= 2:
                return AnalysisResult(os=OS(family=MARINER, name=fields[1]))
        return None


register_analyzer(OSReleaseAnalyzer)
register_analyzer(AlpineReleaseAnalyzer)
register_analyzer(DebianVersionAnalyzer)
register_analyzer(LsbReleaseAnalyzer)
register_analyzer(RedHatReleaseAnalyzer)
register_analyzer(AmazonReleaseAnalyzer)
register_analyzer(MarinerReleaseAnalyzer)
