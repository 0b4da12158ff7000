"""The port's package analyzers (`analyzer/os_release.py`, `pkg_dpkg.py`,
`pkg_apk.py`, `pkg_rpm.py`, `lang.py` with its npm post-analyzer,
`lang_extra.py`, `java.py`, `binary.py`, `misc.py`) against the reference
analyzers they were copied from, on the CPU, on the reference tests'
inputs (`tests/test_vuln.py`, `test_lang_extra.py`, `test_java_rpm.py`,
`test_misc_analyzers.py`, `test_post_analyzers.py`, whose writers for
jars, rpm databases and Go and Rust binaries this module calls):

* every analyzer of both registries on every file of `ecosystem_tree()` (a
  lockfile of each ecosystem, jars, a war, a pom, a gradle lockfile, a Go
  and a Rust binary, site-packages metadata, an embedded CycloneDX SBOM,
  Red Hat build info) and of the OS roots (`os_roots()`: Alpine, Debian,
  Ubuntu, RHEL over rpm sqlite, CentOS over bdb, SUSE over ndb, Amazon,
  CBL-Mariner): `required()` and the `AnalysisResult` as a plain dict;
* the group over each whole tree: claims, per-file analyzers, the npm
  post-analyzer's cross-file context and the system-file handler.

`tests/test_torch_vuln_cli.py` scans the same trees through both CLIs.

Tolerance: exact.
"""

import dataclasses
import io
import json
import os
import zipfile
import zlib

import pytest

import test_java_rpm as jr
import test_lang_extra as le
from trivy_tpu.analyzer import core as ref_core
from trivy_tpu.handler import run_post_handlers as ref_post_handlers
from trivy_tpu.walker import fs as ref_walker
from trivy_tpu_torch.analyzer import core
from trivy_tpu_torch.handler import run_post_handlers
from trivy_tpu_torch.walker import fs as walker

# The reference's misconfig analyzers, which the port does not have (ROADMAP
# A13d), and the two analyzers whose engines other test files hold.
LEFT_OUT = {"dockerfile", "config-json", "config-toml", "kubernetes", "terraform", "helm",
            "terraform-module", "secret", "license-file"}


def _jar(props=None, manifest=None, nested=None) -> bytes:
    return jr._make_jar(props=props, manifest=manifest, nested=nested)


def bare_jar() -> bytes:
    """A jar with no pom.properties and no manifest: named by the Java index."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("com/acme/W.class", b"\xca\xfe\xba\xbe")
    return buf.getvalue()


def ecosystem_tree() -> dict[str, tuple[bytes, int]]:
    """{path: (content, mode)}: one manifest of each ecosystem the language
    analyzers parse, binaries, jars, site-packages and an embedded SBOM."""
    npm_lock = json.dumps({"lockfileVersion": 3, "packages": {
        "": {"name": "app"}, "node_modules/lodash": {"version": "4.17.20"},
        "node_modules/left-pad": {"version": "1.3.0"},
        "node_modules/@scope/pkg": {"version": "1.0.0", "dev": True}}}).encode()
    rust = le._elf_with_dep_section(zlib.compress(json.dumps({"packages": [
        {"name": "serde", "version": "1.0.190", "kind": "runtime"},
        {"name": "cc", "version": "1.0.83", "kind": "build"},
        {"name": "rusty", "version": "0.1.0", "kind": "runtime", "root": True}]}).encode()))
    cdx = json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
        {"type": "library", "name": "log4j-core", "group": "org.apache.logging.log4j",
         "version": "2.14.1", "purl": "pkg:maven/org.apache.logging.log4j/log4j-core@2.14.1"},
        {"type": "library", "name": "musl", "version": "1.2.2-r7",
         "purl": "pkg:apk/alpine/musl@1.2.2-r7?distro=3.15.4"}]}).encode()
    files = {
        "app/package-lock.json": npm_lock,
        "app/package.json": json.dumps({"dependencies": {"lodash": "^4.17.0"}}).encode(),
        "app/node_modules/lodash/package.json":
            b'{"name": "lodash", "version": "4.17.20", "license": "MIT"}',
        "app/.sbom.cdx.json": cdx,
        "web/yarn.lock": b'# yarn lockfile v1\n\nlodash@^4.17.0:\n  version "4.17.20"\n',
        "web/pnpm-lock.yaml":
            b"lockfileVersion: '6.0'\npackages:\n  /lodash@4.17.20:\n    resolution: {}\n",
        "py/requirements.txt": b"requests==2.28.0\n# comment\nflask == 2.0.1\n-e git+https://x\n",
        "py/Pipfile.lock": json.dumps({"default": {"requests": {"version": "==2.28.0"}},
                                       "develop": {"pytest": {"version": "==7.0.0"}}}).encode(),
        "py/poetry.lock": b'[[package]]\nname = "requests"\nversion = "2.28.0"\n',
        "go/go.mod": b"module example.com/app\n\nrequire (\n\tgithub.com/gin-gonic/gin v1.7.0\n"
                     b"\tgolang.org/x/text v0.3.7 // indirect\n)\n",
        "rs/Cargo.lock": b'[[package]]\nname = "serde"\nversion = "1.0.100"\n',
        "php/composer.lock":
            json.dumps({"packages": [{"name": "guzzlehttp/guzzle", "version": "7.4.0"}]}).encode(),
        "rb/Gemfile.lock": b"GEM\n  remote: https://rubygems.org/\n  specs:\n    rails (6.1.4)\n"
                           b"\nDEPENDENCIES\n  rails\n",
        "cs/packages.lock.json": json.dumps({"dependencies": {"net6.0": {
            "Newtonsoft.Json": {"resolved": "12.0.1"}}}}).encode(),
        "cpp/conan.lock": json.dumps({"requires": ["fmt/10.1.1#abc%1699",
                                                   "spdlog/1.12.0"]}).encode(),
        "envs/e/conda-meta/numpy-1.26.0.json":
            json.dumps({"name": "numpy", "version": "1.26.0", "license": "BSD-3-Clause"}).encode(),
        "conda/environment.yml":
            b"name: test\ndependencies:\n  - python=3.11.5=h123\n  - numpy=1.26.*\n  - requests\n",
        "dart/pubspec.lock":
            b'packages:\n  http:\n    dependency: "direct main"\n    version: "0.13.0"\n',
        "ex/mix.lock": b'%{\n  "phoenix": {:hex, :phoenix, "1.7.10", "cafe", [:mix], [], '
                       b'"hexpm", "sum"},\n}\n',
        "ios/Podfile.lock": b"PODS:\n  - Alamofire (5.8.0)\n  - AppCenter/Core (5.0.4)\n",
        "swift/Package.resolved": json.dumps({"version": 2, "pins": [
            {"identity": "alamofire", "location": "https://github.com/Alamofire/Alamofire.git",
             "state": {"version": "5.8.1"}}]}).encode(),
        "usr/lib/ruby/gems/3.1.0/specifications/rake-13.0.6.gemspec":
            b'Gem::Specification.new do |s|\n  s.name = "rake".freeze\n  s.version = "13.0.6"\n'
            b'  s.licenses = ["MIT".freeze]\nend\n',
        "dotnet/MyApp.deps.json": json.dumps({"libraries": {
            "Newtonsoft.Json/13.0.1": {"type": "package"},
            "MyApp/1.0.0": {"type": "project"}}}).encode(),
        "src/Directory.Packages.props":
            b'<Project>\n  <ItemGroup>\n    <PackageVersion Include="Serilog" Version="3.1.1" />\n'
            b'  </ItemGroup>\n</Project>\n',
        "julia/Manifest.toml": b'julia_version = "1.9.0"\nmanifest_format = "2.0"\n\n'
                               b'[[deps.JSON]]\nuuid = "682c06a0"\nversion = "0.21.4"\n',
        "java/log4j-core-2.14.1.jar": _jar(props=("org.apache.logging.log4j", "log4j-core",
                                                  "2.14.1")),
        "java/app.war": _jar(nested={"WEB-INF/lib/jackson-databind-2.9.1.jar": _jar(
            props=("com.fasterxml.jackson.core", "jackson-databind", "2.9.1"))}),
        "java/guava.jar": _jar(manifest={"Implementation-Title": "guava",
                                         "Implementation-Version": "31.0",
                                         "Implementation-Vendor-Id": "com.google.guava"}),
        "java/commons-io-2.11.0.jar": _jar(nested={"org/apache/X.class": b"\xca\xfe"}),
        "java/lib/widget.jar": bare_jar(),
        "java/pom.xml": b'<project><groupId>com.example</groupId><artifactId>svc</artifactId>'
                        b'<version>2.0.0</version><dependencies><dependency>'
                        b'<groupId>org.slf4j</groupId><artifactId>slf4j-api</artifactId>'
                        b'<version>1.7.30</version></dependency></dependencies></project>',
        "java/gradle.lockfile": b"com.squareup.okio:okio:2.8.0=compileClasspath\n"
                                b"org.slf4j:slf4j-api:1.7.30=runtimeClasspath\nempty=annotation\n",
        "usr/lib/python3.11/site-packages/requests-2.31.0.dist-info/METADATA":
            b"Metadata-Version: 2.1\nName: Requests\nVersion: 2.31.0\nLicense: Apache-2.0\n",
        "opt/venv/lib/flask.egg-info": b"Name: Flask\nVersion: 2.0.1\n",
        "root/buildinfo/content_manifests/ubi8.json":
            json.dumps({"content_sets": ["rhel-8-for-x86_64-baseos-rpms"]}).encode(),
        "root/buildinfo/Dockerfile-ubi8-8.9":
            b'LABEL "com.redhat.component"="ubi8-container" "version"="8.9" "release"="1023" '
            b'"architecture"="x86_64"\n',
    }
    tree = {p: (c, 0o644) for p, c in files.items()}
    tree["bin/tool"] = (le._inline_go_binary(), 0o755)
    tree["bin/rusty"] = (rust, 0o755)
    tree["bin/script.sh"] = (b"#!/bin/sh\necho hi\n", 0o755)
    return tree


DPKG_STATUS = (
    b"Package: libssl1.1\nStatus: install ok installed\nArchitecture: amd64\n"
    b"Source: openssl (1.1.1n-0+deb11u1)\nVersion: 1.1.1n-0+deb11u1\n\n"
    b"Package: removed-pkg\nStatus: deinstall ok config-files\nVersion: 1.0\n\n"
    b"Package: zlib1g\nStatus: install ok installed\nSource: zlib\n"
    b"Version: 1:1.2.11.dfsg-2+deb11u2\n"
)
APK_INSTALLED = (
    b"P:musl\nV:1.2.2-r7\nA:x86_64\nL:MIT\no:musl\nD:so:libc.musl\n"
    b"F:lib\nR:ld-musl-x86_64.so.1\n\n"
    b"P:busybox\nV:1.34.1-r5\nA:x86_64\nL:GPL-2.0-only\no:busybox\n\n"
)


def os_roots() -> dict[str, dict[str, tuple[bytes, int]]]:
    bash, openssl = jr.encode_header_blob(jr.BASH_HDR), jr.encode_header_blob(jr.OPENSSL_HDR)
    roots = {
        "alpine": {"etc/os-release": b"ID=alpine\nVERSION_ID=3.15.4\n",
                   "etc/alpine-release": b"3.15.4\n", "lib/apk/db/installed": APK_INSTALLED},
        "debian": {"etc/os-release": b'PRETTY_NAME="Debian GNU/Linux 11"\nID=debian\n'
                                     b'VERSION_ID="11"\n',
                   "etc/debian_version": b"11.6\n", "var/lib/dpkg/status": DPKG_STATUS,
                   "var/lib/dpkg/status.d/extra": b"Package: tzdata\nStatus: install ok "
                                                  b"installed\nVersion: 2021a-1\n",
                   "usr/share/doc/zlib1g/copyright": b"License: Zlib\n"},
        "ubuntu": {"etc/lsb-release": b"DISTRIB_ID=Ubuntu\nDISTRIB_RELEASE=22.04\n",
                   "etc/os-release": b"ID=ubuntu\nVERSION_ID=22.04\n",
                   "var/lib/dpkg/status": DPKG_STATUS},
        "rhel-sqlite": {"etc/redhat-release": b"Red Hat Enterprise Linux release 9.2 (Plow)\n",
                        "var/lib/rpm/rpmdb.sqlite": jr._rpm_sqlite([jr.OPENSSL_HDR])},
        "centos-bdb": {"etc/centos-release": b"CentOS Linux release 7.9.2009 (Core)\n",
                       "var/lib/rpm/Packages": jr.build_bdb_packages([bash, openssl])},
        "suse-ndb": {"etc/os-release": b'ID="sles"\nVERSION_ID="15.4"\n',
                     "usr/lib/sysimage/rpm/Packages.db": jr.build_ndb_packages([bash])},
        "amazon": {"etc/system-release": b"Amazon Linux release 2 (Karoo)\n"},
        "mariner": {"etc/mariner-release": b"CBL-Mariner 2.0.20230630\n"},
    }
    return {k: {p: (c, 0o644) for p, c in v.items()} for k, v in roots.items()}


def write_tree(root, tree: dict[str, tuple[bytes, int]]) -> None:
    for path, (content, mode) in tree.items():
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(content)
        os.chmod(full, mode)


def build_javadb_dir(d: str) -> None:
    """A Java index that names `bare_jar()` by its digest."""
    import hashlib

    from trivy_tpu_torch.javadb import build_javadb

    build_javadb(d, {hashlib.sha1(bare_jar()).hexdigest(): "com.acme:widget:1.4"})


@pytest.fixture(scope="module", autouse=True)
def java_index(tmp_path_factory):
    """Both packages read the Java index from TRIVY_TPU_JAVA_DB_DIR."""
    d = tmp_path_factory.mktemp("javadb")
    build_javadb_dir(str(d))
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIVY_TPU_JAVA_DB_DIR", str(d))
    yield str(d)
    mp.undo()


def _groups():
    port = core.AnalyzerGroup(core.AnalyzerOptions(disabled_analyzers=sorted(LEFT_OUT),
                                                   device="cpu"))
    ref = ref_core.AnalyzerGroup(ref_core.AnalyzerOptions(disabled_analyzers=sorted(LEFT_OUT)))
    return port, ref


def _doc(result):
    return None if result is None else dataclasses.asdict(result)


def _all_files():
    out = [("eco", p) for p in ecosystem_tree()]
    for name, tree in os_roots().items():
        out += [(name, p) for p in tree]
    return out


@pytest.mark.parametrize("tree, path", _all_files(), ids=lambda v: v)
def test_each_analyzer_equals_the_reference(tree, path):
    content, mode = (ecosystem_tree() if tree == "eco" else os_roots()[tree])[path]
    port, ref = _groups()
    # paired by type: a registry's order is its modules' import order
    by_type = {r.type(): r for r in ref.analyzers}
    assert sorted(by_type) == sorted(a.type() for a in port.analyzers)
    claimed = 0
    for a in port.analyzers:
        r = by_type[a.type()]
        need = a.required(path, len(content), mode)
        assert need == r.required(path, len(content), mode), a.type()
        if not need:
            continue
        claimed += 1
        got = a.analyze(core.AnalysisInput("", path, len(content), mode, content))
        want = r.analyze(ref_core.AnalysisInput("", path, len(content), mode, content))
        assert _doc(got) == _doc(want), a.type()
    for p, rp in zip(port.post_analyzers, ref.post_analyzers):
        claimed += p.required(path, len(content), mode)
        assert p.required(path, len(content), mode) == rp.required(path, len(content), mode)
    assert claimed or path.endswith(("copyright", "script.sh", "package.json"))


@pytest.mark.parametrize("tree", ["eco", *os_roots()])
def test_group_over_the_tree_equals_the_reference(tmp_path, tree):
    write_tree(tmp_path, ecosystem_tree() if tree == "eco" else os_roots()[tree])
    port, ref = _groups()
    got = port.analyze_entries(str(tmp_path), walker.FSWalker().walk(str(tmp_path)))
    got.merge(port.post_analyze())
    run_post_handlers(got)
    got.sort()
    want = ref.analyze_entries(str(tmp_path), ref_walker.FSWalker().walk(str(tmp_path)))
    want.merge(ref.post_analyze())
    ref_post_handlers(want)
    want.sort()
    doc = _doc(got)
    assert doc == _doc(want)
    if tree == "eco":
        types = [a["app_type"] for a in doc["applications"]]
        assert {"npm", "jar", "gobinary", "rustbinary", "python-pkg", "pom", "gradle", "cargo",
                "gomod", "poetry", "pip"} <= set(types)
        [npm] = [a for a in doc["applications"] if a["app_type"] == "npm"]
        lodash = [p for p in npm["packages"] if p["name"] == "lodash"]
        assert lodash[0]["licenses"] == ["MIT"] and not lodash[0]["indirect"]
        assert doc["build_info"]["Nvr"] == "ubi8-container-8.9-1023"
    elif tree not in ("amazon", "mariner"):
        assert doc["os"] and doc["package_infos"]
