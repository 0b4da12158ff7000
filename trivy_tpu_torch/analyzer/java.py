"""Java analyzers: jar/war/ear archives, pom.xml, gradle lockfiles.

Mirrors pkg/fanal/analyzer/language/java/jar/jar.go (archive walking:
pom.properties GAV extraction, nested WEB-INF/BOOT-INF jars, manifest and
filename fallbacks, digest->GAV lookup in the Java DB) and the pom/gradle
parsers under pkg/dependency/parser/java/.

Copied from `trivy_tpu/analyzer/java.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import hashlib
import io
import re
import zipfile
import xml.etree.ElementTree as ET

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Application, Package

JAR = "jar"
POM = "pom"
GRADLE = "gradle"

_JAR_EXTS = (".jar", ".war", ".ear", ".par")
_NESTED_DIRS = ("WEB-INF/lib/", "BOOT-INF/lib/")
_FILENAME_RE = re.compile(r"^(?P<artifact>[A-Za-z0-9_.-]+?)-(?P<version>\d[\w.+-]*?)(?:-(?:sources|javadoc|tests))?$")


def _pkg(name: str, version: str, file_path: str = "") -> Package:
    return Package(
        id=f"{name}@{version}" if version else name,
        name=name,
        version=version,
        file_path=file_path,
    )


def parse_jar(
    content: bytes, file_path: str, javadb=None, depth: int = 0
) -> list[Package]:
    """One archive -> packages (jar.go parseArtifact).

    Resolution order per archive: pom.properties inside (authoritative,
    possibly several for shaded jars), else Java-DB digest lookup, else
    manifest/filename heuristics.  Nested jars under WEB-INF/BOOT-INF lib
    dirs recurse (depth-capped)."""
    if depth > 2:
        return []
    try:
        zf = zipfile.ZipFile(io.BytesIO(content))
    except (zipfile.BadZipFile, ValueError):
        return []
    out: list[Package] = []
    props_found = False
    manifest: dict[str, str] = {}
    for name in zf.namelist():
        if name.endswith("pom.properties"):
            try:
                props = _parse_properties(zf.read(name))
            except (KeyError, OSError):
                continue
            g, a, v = (
                props.get("groupId", ""),
                props.get("artifactId", ""),
                props.get("version", ""),
            )
            if g and a and v:
                props_found = True
                out.append(_pkg(f"{g}:{a}", v, file_path))
        elif name == "META-INF/MANIFEST.MF":
            try:
                manifest = _parse_manifest(zf.read(name))
            except (KeyError, OSError):
                pass
        elif depth < 2 and name.lower().endswith(_JAR_EXTS) and any(
            name.startswith(d) for d in _NESTED_DIRS
        ):
            try:
                nested = zf.read(name)
            except (KeyError, OSError):
                continue
            out.extend(
                parse_jar(nested, f"{file_path}/{name}", javadb, depth + 1)
            )

    if not props_found:
        gav = None
        if javadb is not None:
            sha1 = hashlib.sha1(content).hexdigest()
            gav = javadb.lookup(sha1)
        if gav:
            out.append(_pkg(f"{gav[0]}:{gav[1]}", gav[2], file_path))
        else:
            pkg = _from_manifest_or_name(manifest, file_path)
            if pkg is not None:
                # SearchByArtifactID fallback (client.go:149): a DB that
                # indexes by artifactId (the SQLite trivy-java-db) can
                # recover the groupId for a bare artifact-version name.
                search = getattr(javadb, "search_by_artifact_id", None)
                if search is not None and ":" not in pkg.name:
                    gid = search(pkg.name, pkg.version)
                    if gid:
                        pkg.name = f"{gid}:{pkg.name}"
                out.append(pkg)
    return out


def _parse_properties(data: bytes) -> dict[str, str]:
    props: dict[str, str] = {}
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        k, _, v = line.partition("=")
        props[k.strip()] = v.strip()
    return props


def _parse_manifest(data: bytes) -> dict[str, str]:
    out: dict[str, str] = {}
    for line in data.decode("utf-8", "replace").splitlines():
        if ":" in line and not line.startswith(" "):
            k, _, v = line.partition(":")
            out[k.strip()] = v.strip()
    return out


def _from_manifest_or_name(manifest: dict[str, str], file_path: str):
    """jar.go's fallbacks: bundle/implementation attributes, then the
    artifact-version filename convention."""
    group = manifest.get("Implementation-Vendor-Id") or ""
    artifact = (
        manifest.get("Implementation-Title")
        or manifest.get("Bundle-SymbolicName")
        or ""
    )
    version = (
        manifest.get("Implementation-Version")
        or manifest.get("Bundle-Version")
        or ""
    )
    if artifact and version:
        name = f"{group}:{artifact}" if group else artifact
        return _pkg(name, version, file_path)
    stem = file_path.rsplit("/", 1)[-1]
    for ext in _JAR_EXTS:
        if stem.lower().endswith(ext):
            stem = stem[: -len(ext)]
            break
    m = _FILENAME_RE.match(stem)
    if m:
        return _pkg(m.group("artifact"), m.group("version"), file_path)
    return None


class JarAnalyzer(Analyzer):
    """pkg/fanal/analyzer/language/java/jar/jar.go (post-analyzer seat)."""

    def __init__(self) -> None:
        self._javadb = None
        self._javadb_loaded = False

    def type(self) -> str:
        return JAR

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.lower().endswith(_JAR_EXTS)

    def _db(self):
        if not self._javadb_loaded:
            from trivy_tpu_torch.javadb import open_default_javadb

            self._javadb = open_default_javadb()
            self._javadb_loaded = True
        return self._javadb

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = parse_jar(inp.content, inp.file_path, self._db())
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(
                    app_type=JAR, file_path=inp.file_path, packages=pkgs
                )
            ]
        )


# ---------------------------------------------------------------------------
# pom.xml
# ---------------------------------------------------------------------------

_NS_RE = re.compile(r"\{[^}]*\}")
_PROP_RE = re.compile(r"\$\{([^}]+)\}")


def parse_pom(content: bytes) -> list[Package]:
    """pkg/dependency/parser/java/pom: project GAV + dependencies, with
    property interpolation and parent-version inheritance inside the file.
    Versions that stay unresolved (external parents/BOMs) are dropped, like
    the reference without remote repository access."""
    try:
        root = ET.fromstring(content)
    except ET.ParseError:
        return []

    def local(el):
        return _NS_RE.sub("", el.tag)

    def find(el, name):
        for child in el:
            if local(child) == name:
                return child
        return None

    def text(el, name, default=""):
        child = find(el, name)
        return (child.text or "").strip() if child is not None else default

    props: dict[str, str] = {}
    parent = find(root, "parent")
    group = text(root, "groupId") or (text(parent, "groupId") if parent is not None else "")
    version = text(root, "version") or (text(parent, "version") if parent is not None else "")
    artifact = text(root, "artifactId")
    props["project.groupId"] = props["pom.groupId"] = group
    props["project.version"] = props["pom.version"] = version
    props["project.artifactId"] = artifact
    props_el = find(root, "properties")
    if props_el is not None:
        for child in props_el:
            props[local(child)] = (child.text or "").strip()

    def interp(s: str) -> str:
        for _ in range(5):
            m = _PROP_RE.search(s)
            if not m:
                return s
            val = props.get(m.group(1))
            if val is None:
                return ""
            s = s[: m.start()] + val + s[m.end():]
        return s

    out: list[Package] = []
    ig, iv = interp(group), interp(version)
    if ig and artifact and iv:
        out.append(_pkg(f"{ig}:{artifact}", iv))
    deps = find(root, "dependencies")
    if deps is not None:
        for dep in deps:
            if local(dep) != "dependency":
                continue
            g = interp(text(dep, "groupId"))
            a = interp(text(dep, "artifactId"))
            v = interp(text(dep, "version"))
            scope = text(dep, "scope")
            if scope in ("test", "provided", "system"):
                continue
            if g and a and v:
                out.append(_pkg(f"{g}:{a}", v))
    return out


class PomAnalyzer(Analyzer):
    def type(self) -> str:
        return POM

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.rsplit("/", 1)[-1] == "pom.xml"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = parse_pom(inp.content)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(app_type=POM, file_path=inp.file_path, packages=pkgs)
            ]
        )


# ---------------------------------------------------------------------------
# gradle.lockfile
# ---------------------------------------------------------------------------


def parse_gradle_lock(content: bytes) -> list[Package]:
    """pkg/dependency/parser/java/gradle: "group:artifact:version=configs"."""
    out = []
    for line in content.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("empty="):
            continue
        coord = line.partition("=")[0]
        parts = coord.split(":")
        if len(parts) == 3:
            g, a, v = parts
            out.append(_pkg(f"{g}:{a}", v))
    return out


class GradleLockAnalyzer(Analyzer):
    def type(self) -> str:
        return GRADLE

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.rsplit("/", 1)[-1] == "gradle.lockfile"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = parse_gradle_lock(inp.content)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(
                    app_type=GRADLE, file_path=inp.file_path, packages=pkgs
                )
            ]
        )


register_analyzer(JarAnalyzer)
register_analyzer(PomAnalyzer)
register_analyzer(GradleLockAnalyzer)
