"""Language lockfile analyzers.

Mirrors pkg/fanal/analyzer/language/* over the parsers in
pkg/dependency/parser/*: each analyzer claims its ecosystem's lockfile and
yields an Application with the pinned package list.  Pure text/JSON/TOML/YAML
parsing — the per-ecosystem vulnerability matching lives in
trivy_tpu_torch/detector/library.py.

Copied from `trivy_tpu/analyzer/lang.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import json
import re

import yaml

from trivy_tpu_torch.analyzer.core import (
    PostAnalyzer,
    register_post_analyzer,
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Application, Package

# App type constants (pkg/fanal/types/const.go)
NPM = "npm"
YARN = "yarn"
PNPM = "pnpm"
PIP = "pip"
PIPENV = "pipenv"
POETRY = "poetry"
GO_MOD = "gomod"
CARGO = "cargo"
COMPOSER = "composer"
BUNDLER = "bundler"
NUGET = "nuget"
GRADLE = "gradle"


class _LockfileAnalyzer(Analyzer):
    """Base: claim by filename, parse to a package list."""

    app_type = ""
    analyzer_version = 1
    filenames: tuple[str, ...] = ()

    def type(self) -> str:
        return self.app_type

    def version(self) -> int:
        return self.analyzer_version

    def required(self, file_path: str, size: int, mode: int) -> bool:
        name = file_path.rsplit("/", 1)[-1]
        return name in self.filenames

    def parse(self, content: bytes) -> list[Package]:
        raise NotImplementedError

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            packages = self.parse(inp.content)
        except Exception:
            return None  # unparseable lockfiles are skipped, not fatal
        if not packages:
            return None
        packages.sort(key=lambda p: (p.name, p.version))
        return AnalysisResult(
            applications=[
                Application(
                    app_type=self.app_type,
                    file_path=inp.file_path,
                    packages=packages,
                )
            ]
        )


def _pkg(name: str, version: str, **kw) -> Package:
    return Package(id=f"{name}@{version}", name=name, version=version, **kw)


class NpmLockAnalyzer(_LockfileAnalyzer):
    """package-lock.json v1 (dependencies) and v2/v3 (packages)."""

    app_type = NPM
    filenames = ("package-lock.json",)

    def parse(self, content: bytes) -> list[Package]:
        data = json.loads(content)
        out: dict[str, Package] = {}
        if "packages" in data:  # lockfile v2/v3
            for path, meta in data["packages"].items():
                if not path:  # the root project itself
                    continue
                name = meta.get("name") or path.rpartition("node_modules/")[2]
                version = meta.get("version", "")
                if not name or not version or meta.get("link"):
                    continue
                out[f"{name}@{version}"] = _pkg(
                    name, version, dev=bool(meta.get("dev"))
                )
        else:  # v1
            def walk(deps: dict, indirect: bool) -> None:
                for name, meta in (deps or {}).items():
                    version = meta.get("version", "")
                    if version:
                        out[f"{name}@{version}"] = _pkg(
                            name, version,
                            dev=bool(meta.get("dev")),
                            indirect=indirect,
                        )
                    walk(meta.get("dependencies"), True)

            walk(data.get("dependencies"), False)
        return list(out.values())


_YARN_HEADER = re.compile(r'^"?((?:@[^/"]+/)?[^@/"]+)@')
_YARN_VERSION = re.compile(r'^\s{2}version:?\s+"?([^"\s]+)"?')


class YarnLockAnalyzer(_LockfileAnalyzer):
    app_type = YARN
    filenames = ("yarn.lock",)

    def parse(self, content: bytes) -> list[Package]:
        out: dict[str, Package] = {}
        current: str | None = None
        for line in content.decode("utf-8", errors="replace").splitlines():
            if not line or line.startswith("#"):
                continue
            if not line.startswith(" "):
                m = _YARN_HEADER.match(line)
                current = m.group(1) if m else None
                continue
            m = _YARN_VERSION.match(line)
            if m and current:
                out[f"{current}@{m.group(1)}"] = _pkg(current, m.group(1))
                current = None
        return list(out.values())


class PnpmLockAnalyzer(_LockfileAnalyzer):
    app_type = PNPM
    filenames = ("pnpm-lock.yaml",)

    def parse(self, content: bytes) -> list[Package]:
        data = yaml.safe_load(content) or {}
        out = []
        for key in data.get("packages") or {}:
            # "/name@version(peer@dep)" or "/@scope/name@version" (v6);
            # "/name/1.0.0" (v5).  Peer-dependency suffixes are parenthesized
            # and contain '@'s of their own — strip them first.
            k = key.lstrip("/").split("(")[0]
            if "@" in k[1:]:
                name, _, version = k.rpartition("@")
            else:
                name, _, version = k.rpartition("/")
            if name and version:
                out.append(_pkg(name, version))
        return out


_REQ_LINE = re.compile(
    r"^([A-Za-z0-9._-]+)\s*(?:\[[^\]]*\])?\s*==\s*([A-Za-z0-9.*+!_-]+)"
)


class PipRequirementsAnalyzer(_LockfileAnalyzer):
    app_type = PIP
    filenames = ("requirements.txt",)

    def parse(self, content: bytes) -> list[Package]:
        out = []
        for line in content.decode("utf-8", errors="replace").splitlines():
            line = line.split("#")[0].strip()
            m = _REQ_LINE.match(line)
            if m:
                out.append(_pkg(m.group(1).lower(), m.group(2)))
        return out


class PipenvLockAnalyzer(_LockfileAnalyzer):
    app_type = PIPENV
    filenames = ("Pipfile.lock",)

    def parse(self, content: bytes) -> list[Package]:
        data = json.loads(content)
        out = []
        for section in ("default", "develop"):
            for name, meta in (data.get(section) or {}).items():
                version = (meta.get("version") or "").lstrip("=")
                if version:
                    out.append(_pkg(name.lower(), version, dev=section == "develop"))
        return out


class PoetryLockAnalyzer(_LockfileAnalyzer):
    app_type = POETRY
    filenames = ("poetry.lock",)

    def parse(self, content: bytes) -> list[Package]:
        from trivy_tpu_torch.compat import tomllib

        data = tomllib.loads(content.decode("utf-8", errors="replace"))
        return [
            _pkg(p["name"].lower(), p["version"])
            for p in data.get("package", [])
            if p.get("name") and p.get("version")
        ]


class GoModAnalyzer(_LockfileAnalyzer):
    app_type = GO_MOD
    analyzer_version = 2
    filenames = ("go.mod",)

    def parse(self, content: bytes) -> list[Package]:
        out = []
        in_require = False
        for raw in content.decode("utf-8", errors="replace").splitlines():
            indirect = "// indirect" in raw
            line = raw.split("//")[0].strip()
            if line.startswith("require ("):
                in_require = True
                continue
            if in_require and line == ")":
                in_require = False
                continue
            parts = line.split()
            if in_require and len(parts) >= 2:
                out.append(_pkg(parts[0], parts[1].lstrip("v"), indirect=indirect))
            elif parts[:1] == ["require"] and len(parts) >= 3:
                out.append(_pkg(parts[1], parts[2].lstrip("v"), indirect=indirect))
        return out


class CargoLockAnalyzer(_LockfileAnalyzer):
    app_type = CARGO
    filenames = ("Cargo.lock",)

    def parse(self, content: bytes) -> list[Package]:
        from trivy_tpu_torch.compat import tomllib

        data = tomllib.loads(content.decode("utf-8", errors="replace"))
        return [
            _pkg(p["name"], p["version"])
            for p in data.get("package", [])
            if p.get("name") and p.get("version")
        ]


class ComposerLockAnalyzer(_LockfileAnalyzer):
    app_type = COMPOSER
    filenames = ("composer.lock",)

    def parse(self, content: bytes) -> list[Package]:
        data = json.loads(content)
        out = []
        for section, dev in (("packages", False), ("packages-dev", True)):
            for p in data.get(section) or []:
                if p.get("name") and p.get("version"):
                    out.append(
                        _pkg(p["name"], p["version"].lstrip("v"), dev=dev)
                    )
        return out


_GEM_RE = re.compile(r"^\s{4}([A-Za-z0-9._-]+)\s+\(([^)]+)\)")


class GemfileLockAnalyzer(_LockfileAnalyzer):
    app_type = BUNDLER
    filenames = ("Gemfile.lock",)

    def parse(self, content: bytes) -> list[Package]:
        out = []
        in_gem = False
        for line in content.decode("utf-8", errors="replace").splitlines():
            if line.strip() == "GEM":
                in_gem = True
                continue
            if in_gem and line and not line.startswith(" "):
                in_gem = False
            if in_gem:
                m = _GEM_RE.match(line)
                if m:
                    out.append(_pkg(m.group(1), m.group(2)))
        return out


class NugetLockAnalyzer(_LockfileAnalyzer):
    app_type = NUGET
    filenames = ("packages.lock.json",)

    def parse(self, content: bytes) -> list[Package]:
        data = json.loads(content)
        out: dict[str, Package] = {}
        for deps in (data.get("dependencies") or {}).values():
            for name, meta in deps.items():
                version = meta.get("resolved", "")
                if version:
                    out[f"{name}@{version}"] = _pkg(name, version)
        return list(out.values())


# NpmLockAnalyzer is not registered per-file: npm runs as a post-analyzer
# (NpmPostAnalyzer below) so it can see the manifest and node_modules
# metadata through the composite FS.
for _cls in (
    PnpmLockAnalyzer,
    PipRequirementsAnalyzer,
    PipenvLockAnalyzer,
    PoetryLockAnalyzer,
    GoModAnalyzer,
    CargoLockAnalyzer,
    ComposerLockAnalyzer,
    GemfileLockAnalyzer,
    NugetLockAnalyzer,
    YarnLockAnalyzer,
):
    register_analyzer(_cls)


class NpmPostAnalyzer(PostAnalyzer):
    """pkg/fanal/analyzer/language/nodejs/npm/npm.go: the lockfile parse
    plus cross-file context from the composite FS — direct-dependency
    marking from the sibling package.json and license enrichment from
    node_modules/<name>/package.json.  The per-file analyzer cannot see
    those neighbors; this is the post-analyzer mechanism's seat
    (analyzer.go:506)."""

    def type(self) -> str:
        return NPM

    def version(self) -> int:
        return 2  # v1 was the plain per-file lock analyzer

    def required(self, file_path: str, size: int, mode: int) -> bool:
        name = file_path.rsplit("/", 1)[-1]
        if name == "package-lock.json":
            return True
        return name == "package.json" and size < 1 << 20

    def post_analyze(self, fs) -> AnalysisResult | None:
        import posixpath

        apps = []
        for lock_path in fs.glob("**/package-lock.json") + (
            ["package-lock.json"] if fs.exists("package-lock.json") else []
        ):
            try:
                pkgs = NpmLockAnalyzer().parse(fs.read(lock_path))
            except (ValueError, KeyError, TypeError):
                continue  # unparseable lockfiles are skipped, not fatal
            base = posixpath.dirname(lock_path)

            direct: set[str] = set()
            manifest = fs.siblings(lock_path, "package.json")
            if manifest is not None:
                try:
                    m = json.loads(fs.read(manifest))
                    for sect in ("dependencies", "devDependencies"):
                        direct.update((m.get(sect) or {}).keys())
                except ValueError:
                    pass

            for p in pkgs:
                if direct:
                    p.indirect = p.name not in direct
                nm = posixpath.join(base, "node_modules", p.name, "package.json")
                if fs.exists(nm):
                    try:
                        meta = json.loads(fs.read(nm))
                    except ValueError:
                        continue
                    lic = meta.get("license")
                    if isinstance(lic, dict):
                        lic = lic.get("type")
                    if isinstance(lic, str) and lic:
                        p.licenses = [lic]
            if not pkgs:
                continue  # empty lockfile: no Application, like the per-file path
            pkgs.sort(key=lambda p: (p.name, p.version))
            apps.append(
                Application(
                    app_type=NPM, file_path=lock_path, packages=pkgs
                )
            )
        if not apps:
            return None
        return AnalysisResult(applications=apps)


register_post_analyzer(NpmPostAnalyzer)
