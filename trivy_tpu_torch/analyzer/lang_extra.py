"""Additional language ecosystem analyzers: Conan, Conda, Pub, Mix,
CocoaPods, Swift.

Reference parity targets: dependency/parser/c/conan/parse.go (v1
graph_lock nodes + v2 requires), conda/meta/parse.go and
conda/environment/parse.go, dart/pub/parse.go (pubspec.lock packages),
hex/mix/parse.go (mix.lock :hex tuples), swift/cocoapods/parse.go
(Podfile.lock PODS) and swift/swift/parse.go (Package.resolved v1/v2).

Copied from `trivy_tpu/analyzer/lang_extra.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import json
import logging
import os
import re

import yaml

from trivy_tpu_torch.analyzer.core import (
    Analyzer,
    AnalysisInput,
    AnalysisResult,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Application, Package

logger = logging.getLogger(__name__)


def _app(app_type: str, file_path: str, pkgs: list[Package]) -> AnalysisResult:
    result = AnalysisResult()
    result.applications.append(
        Application(app_type=app_type, file_path=file_path, packages=pkgs)
    )
    return result


def _pkg(name: str, version: str) -> Package:
    return Package(id=f"{name}@{version}" if version else name, name=name, version=version)


class _FileNameAnalyzer(Analyzer):
    """Analyzer triggered by an exact basename match."""

    FILE_NAME = ""
    TYPE = ""
    VERSION = 1

    def version(self) -> int:
        return self.VERSION

    def type(self) -> str:
        return self.TYPE

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return os.path.basename(file_path) == self.FILE_NAME

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            pkgs = self.parse(inp.content)
        except Exception as e:
            logger.warning("%s: cannot parse %s: %s", self.TYPE, inp.file_path, e)
            return None
        if not pkgs:
            return None
        return _app(self.TYPE, inp.file_path, pkgs)

    def parse(self, content: bytes) -> list[Package]:
        raise NotImplementedError


class ConanLockAnalyzer(_FileNameAnalyzer):
    """conan.lock (parse.go:60-120): v1 graph_lock nodes keyed by id ("0"
    is the consumer project, skipped); v2 flat requires list.  Refs look
    like name/version[@user/channel][#rev]."""

    FILE_NAME = "conan.lock"
    TYPE = "conan"

    @staticmethod
    def _ref_to_pkg(ref: str) -> Package | None:
        ref = ref.split("#")[0].split("@")[0].split("%")[0]
        name, _, version = ref.partition("/")
        if not name or not version:
            return None
        return _pkg(name, version)

    def parse(self, content: bytes) -> list[Package]:
        doc = json.loads(content)
        pkgs = []
        nodes = (doc.get("graph_lock") or {}).get("nodes") or {}
        for node_id, node in nodes.items():
            if node_id == "0":  # the consumer project itself
                continue
            p = self._ref_to_pkg(node.get("ref") or "")
            if p:
                pkgs.append(p)
        for ref in doc.get("requires") or []:  # lockfile v2
            p = self._ref_to_pkg(ref)
            if p:
                pkgs.append(p)
        return pkgs


class CondaMetaAnalyzer(Analyzer):
    """conda-meta/<pkg>.json environment records (conda/meta/parse.go)."""

    def version(self) -> int:
        return 1

    def type(self) -> str:
        return "conda-pkg"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        norm = file_path.replace(os.sep, "/")
        return norm.endswith(".json") and "conda-meta/" in norm

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except ValueError:
            return None
        name, version = doc.get("name", ""), doc.get("version", "")
        if not name or not version:
            return None
        pkg = _pkg(name, version)
        if doc.get("license"):
            pkg.licenses = [doc["license"]]
        return _app("conda-pkg", inp.file_path, [pkg])


class CondaEnvironmentAnalyzer(_FileNameAnalyzer):
    """environment.yml (conda/environment/parse.go): "name=version[=build]"
    entries; unpinned specs keep an empty version."""

    FILE_NAME = "environment.yml"
    TYPE = "conda-environment"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return os.path.basename(file_path) in (
            "environment.yml",
            "environment.yaml",
        )

    _DEP = re.compile(
        r"^(?P<name>[A-Za-z0-9_.-]+)\s*(?P<spec>(?:[=<>!~].*)?)$"
    )

    def parse(self, content: bytes) -> list[Package]:
        doc = yaml.safe_load(content) or {}
        pkgs = []
        for dep in doc.get("dependencies") or []:
            if not isinstance(dep, str):
                continue  # nested pip: lists etc.
            m = self._DEP.match(dep.strip())
            if m is None:
                continue
            # Only exact "=version[=build]" pins count as versions; range
            # specs (">=3.9", "<2", "=1.2.*") cannot be vuln-matched and
            # keep an empty version like the reference's unpinned warning.
            vm = re.fullmatch(
                r"={1,2}(?P<v>[0-9][\w.!+-]*)(=.*)?", m["spec"]
            )
            pkgs.append(_pkg(m["name"], vm["v"] if vm else ""))
        return pkgs


class PubLockAnalyzer(_FileNameAnalyzer):
    """pubspec.lock (dart/pub/parse.go): YAML packages map; dev and
    transitive dependencies are all kept (the lock cannot distinguish
    transitive-dev from transitive-main)."""

    FILE_NAME = "pubspec.lock"
    TYPE = "pub"

    def parse(self, content: bytes) -> list[Package]:
        doc = yaml.safe_load(content) or {}
        pkgs = []
        for name, dep in (doc.get("packages") or {}).items():
            version = str((dep or {}).get("version", ""))
            if name and version:
                pkgs.append(_pkg(name, version))
        return pkgs


_MIX_LINE = re.compile(
    rb'^\s*"(?P<name>[^"]+)":\s*\{:hex,\s*:[\w]+,\s*"(?P<version>[^"]+)"'
)


class MixLockAnalyzer(_FileNameAnalyzer):
    """mix.lock (hex/mix/parse.go): one Elixir tuple per line,
    '"name": {:hex, :name, "version", ...}'.  Git tuples carry a quoted
    URL where :hex lines carry the package atom, so they never match the
    pattern — mirroring the reference's skip of git dependencies."""

    FILE_NAME = "mix.lock"
    TYPE = "hex"

    def parse(self, content: bytes) -> list[Package]:
        pkgs = []
        for line in content.splitlines():
            m = _MIX_LINE.match(line)
            if m is not None:
                pkgs.append(_pkg(m["name"].decode(), m["version"].decode()))
        return pkgs


_POD_DEP = re.compile(r"^(?P<name>\S+)\s+\((?P<version>[^()\s]+)\)$")


class CocoaPodsAnalyzer(_FileNameAnalyzer):
    """Podfile.lock (swift/cocoapods/parse.go): PODS entries are either
    plain strings "Name (1.2.3)" or one-key maps with child dep lists;
    subspec names like Alamofire/Core are kept as-is."""

    FILE_NAME = "Podfile.lock"
    TYPE = "cocoapods"

    def parse(self, content: bytes) -> list[Package]:
        doc = yaml.safe_load(content) or {}
        pkgs = {}
        for pod in doc.get("PODS") or []:
            entries = [pod] if isinstance(pod, str) else list(pod or {})
            for entry in entries:
                m = _POD_DEP.match(str(entry).strip())
                if m is None:
                    logger.debug("cocoapods: cannot parse %r", entry)
                    continue
                pkgs[m["name"]] = _pkg(m["name"], m["version"])
        return list(pkgs.values())


class SwiftAnalyzer(_FileNameAnalyzer):
    """Package.resolved (swift/swift/parse.go): v1 object.pins use
    repositoryURL, v2 pins use location; names are the URL without the
    https:// prefix and .git suffix, versions fall back to the branch."""

    FILE_NAME = "Package.resolved"
    TYPE = "swift"

    def parse(self, content: bytes) -> list[Package]:
        doc = json.loads(content)
        version = doc.get("version", 1)
        pins = (
            doc.get("pins")
            if version > 1
            else (doc.get("object") or {}).get("pins")
        ) or []
        pkgs = []
        for pin in pins:
            url = pin.get("location" if version > 1 else "repositoryURL", "")
            name = url.removeprefix("https://").removesuffix(".git")
            state = pin.get("state") or {}
            ver = state.get("version") or state.get("branch") or ""
            if name and ver:
                pkgs.append(_pkg(name, ver))
        return pkgs


register_analyzer(ConanLockAnalyzer)
register_analyzer(CondaMetaAnalyzer)
register_analyzer(CondaEnvironmentAnalyzer)
register_analyzer(PubLockAnalyzer)
register_analyzer(MixLockAnalyzer)
register_analyzer(CocoaPodsAnalyzer)
register_analyzer(SwiftAnalyzer)


class _PathAnalyzer(Analyzer):
    """Analyzer with TYPE/VERSION class attrs; subclasses define
    required() and analyze()."""

    TYPE = ""
    VERSION = 1

    def version(self) -> int:
        return self.VERSION

    def type(self) -> str:
        return self.TYPE


def _components(file_path: str) -> list[str]:
    return file_path.replace(os.sep, "/").split("/")


class GemspecAnalyzer(_PathAnalyzer):
    """Installed gem specifications (ruby/gemspec/parse.go): .gemspec files
    under a specifications/ directory carry `s.name = "x"` /
    `s.version = "1.2"` assignments (quoted or .freeze forms)."""

    TYPE = "gemspec"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return (
            file_path.endswith(".gemspec")
            and "specifications" in _components(file_path)[:-1]
        )

    _NAME_RE = re.compile(
        rb'\.name\s*=\s*["\']([^"\']+)["\']'
    )
    _VERSION_RE = re.compile(
        rb'\.version\s*=\s*(?:Gem::Version\.new\()?["\']([^"\']+)["\']'
    )
    _LICENSE_RE = re.compile(
        rb'\.licenses?\s*=\s*\[?["\']([^"\']+)["\']'
    )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        name = self._NAME_RE.search(inp.content)
        version = self._VERSION_RE.search(inp.content)
        if not name or not version:
            return None
        pkg = _pkg(
            name.group(1).decode("utf-8", "replace"),
            version.group(1).decode("utf-8", "replace"),
        )
        lic = self._LICENSE_RE.search(inp.content)
        if lic:
            pkg.licenses = [lic.group(1).decode("utf-8", "replace")]
        return _app(self.TYPE, inp.file_path, [pkg])


class DotnetDepsAnalyzer(_PathAnalyzer):
    """.deps.json runtime dependency files (dotnet/core_deps/parse.go):
    libraries keyed "Name/Version" with type "package" (case-insensitive,
    as the reference's EqualFold)."""

    TYPE = "dotnet-core"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.endswith(".deps.json")

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except ValueError as e:
            logger.warning("deps.json %s: %s", inp.file_path, e)
            return None
        pkgs = []
        for key, lib in (doc.get("libraries") or {}).items():
            if not isinstance(lib, dict) or str(lib.get("type", "")).lower() != "package":
                continue
            name, _, ver = key.partition("/")
            if name and ver:
                pkgs.append(_pkg(name, ver))
        if not pkgs:
            return None
        return _app(self.TYPE, inp.file_path, pkgs)


class PackagesPropsAnalyzer(_PathAnalyzer):
    """Central package management props files (dotnet packages_props
    parser): <PackageVersion Include="x" Version="1.2"/> items, any
    attribute order; $()-interpolated values are skipped."""

    TYPE = "packages-props"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        base = os.path.basename(file_path).lower()
        return base in ("directory.packages.props", "packages.props")

    _ELEM_RE = re.compile(
        rb"<Package(?:Version|Reference)\s([^>]*?)/?>", re.IGNORECASE
    )
    _ATTR_RE = re.compile(rb"""(\w+)\s*=\s*["']([^"']*)["']""")

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = []
        for m in self._ELEM_RE.finditer(inp.content):
            attrs = {
                k.lower(): v
                for k, v in self._ATTR_RE.findall(m.group(1))
            }
            name = attrs.get(b"include", b"")
            ver = attrs.get(b"version", b"")
            if name and ver and b"$" not in name and b"$" not in ver:
                pkgs.append(_pkg(name.decode(), ver.decode()))
        if not pkgs:
            return None
        return _app(self.TYPE, inp.file_path, pkgs)


class NodePkgAnalyzer(_PathAnalyzer):
    """Installed node packages (nodejs/packagejson parser): package.json
    under node_modules/ carries the installed package's own name/version.
    Scoped to node_modules (unlike the reference's any-package.json) so the
    npm composite-FS post-analyzer keeps owning project manifests."""

    TYPE = "node-pkg"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        parts = _components(file_path)
        return parts[-1] == "package.json" and "node_modules" in parts[:-1]

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except ValueError:
            return None
        name = doc.get("name", "")
        ver = doc.get("version", "")
        if not isinstance(name, str) or not name or not isinstance(ver, str):
            return None
        pkg = _pkg(name, ver)
        lic = doc.get("license")
        if isinstance(lic, str) and lic:
            pkg.licenses = [lic]
        elif isinstance(lic, dict) and lic.get("type"):
            pkg.licenses = [lic["type"]]
        return _app(self.TYPE, inp.file_path, [pkg])


class JuliaManifestAnalyzer(_FileNameAnalyzer):
    """Julia Manifest.toml (julia/manifest/parse.go): [[deps.Name]]
    entries with version (stdlib entries without version are skipped)."""

    FILE_NAME = "Manifest.toml"
    TYPE = "julia"

    def parse(self, content: bytes) -> list[Package]:
        from trivy_tpu_torch.compat import tomllib

        doc = tomllib.loads(content.decode("utf-8", "replace"))
        deps = doc.get("deps") or {
            k: v for k, v in doc.items() if isinstance(v, list)
        }
        pkgs = []
        for name, entries in deps.items():
            if not isinstance(entries, list):
                continue
            for e in entries:
                if isinstance(e, dict) and e.get("version"):
                    pkgs.append(_pkg(name, str(e["version"])))
        return pkgs


register_analyzer(GemspecAnalyzer)
register_analyzer(DotnetDepsAnalyzer)
register_analyzer(PackagesPropsAnalyzer)
register_analyzer(NodePkgAnalyzer)
register_analyzer(JuliaManifestAnalyzer)
