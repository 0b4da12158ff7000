"""The port's vulnerability plane below the analyzers, on the CPU, against
the reference modules it was copied from:

* the version comparators of `detector/version_cmp.py` (deb, apk, rpm,
  maven, semver, pep440, generic) and `version_in_range`, on seeded
  version strings of each ecosystem and on hypothesis-generated ones: the
  same sign, or the same exception;
* the DB readers: the bbolt reader (`db/bolt.py`) over `build_bolt`
  fixtures, `BoltVulnDB` with its OS bucket aliases and language bucket
  prefixes, the JSON-bucket `VulnDB`, `build_db` and the torn-DB fallback
  of `load_db`, the rpmdb readers (sqlite, bdb, ndb) over the reference
  tests' writers, and the Java index (JSON shards and `trivy-java.db`);
* the update gate of `db/client.py` (`--skip-db-update`) on fresh, stale,
  throttled, missing and other-schema DBs;
* the detectors (`detector/ospkg.py`, `library.py`, `severity.py`,
  `eol.py`) and `scanner/vuln.py` on one DB and package set.

Tolerance: exact.
"""

import dataclasses
import datetime as dt
import json
import logging
import os
import sqlite3

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import bolt_fixture
import test_java_rpm as jr
from trivy_tpu import javadb as ref_javadb
from trivy_tpu.analyzer import pkg_rpm as ref_rpm
from trivy_tpu.atypes import OS as RefOS
from trivy_tpu.atypes import Application as RefApplication
from trivy_tpu.atypes import ArtifactDetail as RefDetail
from trivy_tpu.atypes import Package as RefPackage
from trivy_tpu.db import bolt as ref_bolt
from trivy_tpu.db import client as ref_client
from trivy_tpu.db import vulndb as ref_vulndb
from trivy_tpu.detector import eol as ref_eol
from trivy_tpu.detector import severity as ref_severity
from trivy_tpu.detector import version_cmp as ref_cmp
from trivy_tpu.scanner import vuln as ref_vuln
from trivy_tpu.scanner.service import ScanOptions as RefScanOptions
from trivy_tpu_torch import javadb
from trivy_tpu_torch.analyzer import pkg_rpm
from trivy_tpu_torch.atypes import OS, Application, ArtifactDetail, Package
from trivy_tpu_torch.db import bolt, client, vulndb
from trivy_tpu_torch.detector import eol, severity, version_cmp
from trivy_tpu_torch.scanner import vuln
from trivy_tpu_torch.scanner.service import ScanOptions

FLAVORS = sorted(version_cmp.COMPARATORS)


def _outcome(fn, *args):
    """A call's value, or the name of the exception it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return type(e).__name__


def _sign(v):
    return v if isinstance(v, str) else (v > 0) - (v < 0)


def _versions(flavor: str, rng: np.random.Generator, n: int) -> list[str]:
    """Seeded version strings in `flavor`'s syntax, with near neighbours."""
    out = []
    for _ in range(n):
        nums = [str(int(x)) for x in rng.integers(0, 12, size=int(rng.integers(1, 4)))]
        core = ".".join(nums)
        pick = int(rng.integers(0, 6))
        if flavor == "deb":
            core = (f"{int(rng.integers(1, 3))}:" if pick == 0 else "") + core
            core += ["", "~rc1", "+deb12u1", "a", "-1", "-0+deb11u2"][pick]
        elif flavor == "apk":
            core += ["", "_rc1", "_p2", "a", "-r0", "-r12"][pick]
        elif flavor == "rpm":
            core = (f"{int(rng.integers(1, 3))}:" if pick == 0 else "") + core
            core += ["", "-1.el9", "-35.el7_9", "~beta", "^git1", "-2.fc39"][pick]
        elif flavor == "maven":
            core += ["", "-SNAPSHOT", "-alpha-1", ".RELEASE", "-rc2", "-sp1"][pick]
        elif flavor == "semver":
            core = ("v" if pick == 0 else "") + core
            core += ["", "-alpha.1", "-beta", "+build.5", "-rc.2", ""][pick]
        elif flavor == "pep440":
            core += ["", "rc1", ".post1", ".dev3", "a2", "b1"][pick]
        else:
            core += ["", "-p1", "a", "b2", "-1", ""][pick]
        out.append(core)
    return out


@pytest.mark.parametrize("flavor", FLAVORS)
def test_comparators_equal_the_reference(flavor):
    rng = np.random.default_rng(FLAVORS.index(flavor) + 1)
    vs = _versions(flavor, rng, 120) + ["", "0", "1.0", "1.0.0", "10", "1.0a", "1..2", "x"]
    mine, ref = version_cmp.COMPARATORS[flavor], ref_cmp.COMPARATORS[flavor]
    n_cmp = 0
    for a in vs:
        for b in vs[:40]:
            got = _sign(_outcome(mine, a, b))
            assert got == _sign(_outcome(ref, a, b)), (a, b)
            n_cmp += isinstance(got, int)
    assert n_cmp > len(vs) * 20


_VERSION_TEXT = st.text(alphabet="0123456789.-~+:_abcprvRCSNAPHOT^", max_size=14)


@pytest.mark.parametrize("flavor", FLAVORS)
@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(a=_VERSION_TEXT, b=_VERSION_TEXT)
def test_comparators_equal_the_reference_generated(flavor, a, b):
    mine, ref = version_cmp.COMPARATORS[flavor], ref_cmp.COMPARATORS[flavor]
    assert _sign(_outcome(mine, a, b)) == _sign(_outcome(ref, a, b))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_version_in_range_equals_the_reference(flavor):
    rng = np.random.default_rng(100 + FLAVORS.index(flavor))
    vs = _versions(flavor, rng, 40)
    exprs = []
    for i in range(0, 36, 3):
        a, b, c = vs[i : i + 3]
        exprs += [f">={a}, <{b}", f">= {a}, < {b}", f"<{a} || >={b}", f"={c}", f"<={c}",
                  f">{a},<={b} || ={c}", c, f"!={a}", "", "||"]
    for installed in vs:
        for expr in exprs:
            assert _outcome(version_cmp.version_in_range, installed, expr, flavor) == _outcome(
                ref_cmp.version_in_range, installed, expr, flavor), (installed, expr)


# -- the DB readers ------------------------------------------------------------------


def _tree(b) -> dict:
    """A bbolt bucket as a nested dict (values bytes, child buckets dicts)."""
    kids = {name: _tree(child) for name, child in b.buckets()}
    return {**{k: bytes(v) for k, v in b.items() if k not in kids}, **kids}


BOLT_ROOT = {
    b"alpine 3.17": {
        b"musl": {b"CVE-2023-0001": b'{"FixedVersion": "1.2.3-r5"}'},
        b"zlib": {b"CVE-2022-37434": b'{"FixedVersion": "1.2.12-r2", "Severity": 3}'},
    },
    b"Red Hat Enterprise Linux 9": {
        b"openssl": {b"CVE-2023-0286": b'{"FixedVersion": "1:3.0.7-6.el9"}'},
    },
    b"pip::GitHub Security Advisory Pip": {
        b"flask": {b"GHSA-m2qf": b'{"PatchedVersions": ["2.2.5"], '
                                b'"VulnerableVersions": ["<2.2.5"]}'},
    },
    b"pip::OSV": {b"flask": {b"PYSEC-9": b'{"PatchedVersions": ["2.2.4"]}'}},
    b"pipx::other": {b"flask": {b"NOPE-1": b'{"PatchedVersions": ["9"]}'}},
    b"SUSE Linux Enterprise 15.4": {b"curl": {b"SUSE-1": b'{"FixedVersion": "8.0.1-1.1"}'}},
    b"CBL-Mariner 2.0": {b"bash": {b"CVE-M": b'{"FixedVersion": "5.1.8-4.cm2"}'}},
    b"vulnerability": {
        b"CVE-2023-0001": json.dumps({
            "Title": "musl: oob", "Severity": 4, "References": ["https://x"],
            "VendorSeverity": {"nvd": 3, "redhat": 2},
            "CVSS": {"nvd": {"V3Score": 7.5}}}).encode(),
        b"CVE-2023-0286": b'{"Title": "openssl", "Description": "x509", "Severity": 3}',
        b"GHSA-m2qf": b'{"Title": "flask cookie", "VendorSeverity": {"ghsa": 3}}',
    },
}
BOLT_QUERIES = [("alpine 3.17", "musl"), ("alpine 3.17", "zlib"), ("alpine 3.17", "absent"),
                ("redhat 9", "openssl"), ("pip", "flask"), ("pipx", "flask"),
                ("suse 15.4", "curl"), ("cbl-mariner 2", "bash"), ("debian 12", "bash")]


@pytest.mark.parametrize("split", [0, 2])
def test_bolt_reader_equals_the_reference(tmp_path, split):
    path = tmp_path / "trivy.db"
    path.write_bytes(bolt_fixture.build_bolt(BOLT_ROOT, split_root=split))
    got, want = bolt.Bolt.open(str(path)), ref_bolt.Bolt.open(str(path))
    assert {k: _tree(b) for k, b in got.buckets()} == {k: _tree(b) for k, b in want.buckets()}
    assert got.bucket(b"alpine 3.17", b"musl").get(b"CVE-2023-0001") == want.bucket(
        b"alpine 3.17", b"musl").get(b"CVE-2023-0001")
    assert got.bucket(b"nope") is None and want.bucket(b"nope") is None
    for bad in (b"", b"\x00" * 8192, path.read_bytes()[:5000]):
        with pytest.raises(bolt.BoltError):
            bolt.Bolt(bad)
        with pytest.raises(ref_bolt.BoltError):
            ref_bolt.Bolt(bad)


def _advs(db, queries) -> list:
    return [[dataclasses.asdict(a) for a in db.advisories(s, p)] for s, p in queries]


def test_bolt_vulndb_equals_the_reference(tmp_path):
    (tmp_path / "trivy.db").write_bytes(bolt_fixture.build_bolt(BOLT_ROOT))
    (tmp_path / "metadata.json").write_text('{"Version": 2}')
    got, want = vulndb.load_db(str(tmp_path)), ref_vulndb.load_db(str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == "BoltVulnDB"
    doc = _advs(got, BOLT_QUERIES)
    assert doc == _advs(want, BOLT_QUERIES)
    assert sum(map(len, doc)) == 8 and got.metadata() == want.metadata()


def _db_data():
    return {
        "alpine 3.15": {"musl": [vulndb.Advisory("CVE-2099-0001", fixed_version="1.2.3-r0",
                                                 severity="HIGH", title="musl overflow")],
                        "busybox": [{"VulnerabilityID": "CVE-2099-0002",
                                     "FixedVersion": "1.34.0-r0", "Severity": "LOW"}]},
        "npm": {"lodash": [{"VulnerabilityID": "CVE-2099-1000", "VulnerableVersions": "<4.17.21",
                            "FixedVersion": "4.17.21", "Severity": "CRITICAL",
                            "References": ["https://r"], "CVSSScore": 9.1,
                            "VendorSeverity": {"ghsa": "HIGH"}}]},
        "pip/extra": {"flask": []},
    }


def test_json_vulndb_equals_the_reference(tmp_path):
    data = _db_data()
    vulndb.build_db(str(tmp_path / "port"), data)
    ref_data = {s: {p: [ref_vulndb.Advisory(**dataclasses.asdict(a))
                        if isinstance(a, vulndb.Advisory) else a for a in advs]
                    for p, advs in pkgs.items()} for s, pkgs in data.items()}
    ref_vulndb.build_db(str(tmp_path / "ref"), ref_data)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()
    queries = [("alpine 3.15", "musl"), ("alpine 3.15", "busybox"), ("npm", "lodash"),
               ("pip/extra", "flask"), ("debian 12", "bash")]
    got, want = vulndb.load_db(str(tmp_path / "port")), ref_vulndb.load_db(str(tmp_path / "ref"))
    assert _advs(got, queries) == _advs(want, queries)
    assert vulndb.load_db(str(tmp_path / "absent")) is None
    assert ref_vulndb.load_db(str(tmp_path / "absent")) is None


def test_torn_trivy_db_falls_back_to_json_buckets(tmp_path, caplog):
    vulndb.build_db(str(tmp_path), _db_data())
    (tmp_path / "trivy.db").write_bytes(b"\x00" * 100)
    with caplog.at_level(logging.WARNING):
        got = vulndb.load_db(str(tmp_path))
        want = ref_vulndb.load_db(str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == "VulnDB"
    assert sum("falling back to JSON buckets" in r.getMessage() for r in caplog.records) == 2
    assert _advs(got, [("npm", "lodash")]) == _advs(want, [("npm", "lodash")])


def _pkgs(pkgs) -> list:
    return [dataclasses.asdict(p) for p in pkgs]


def _rpm_cases():
    bash, openssl = jr.encode_header_blob(jr.BASH_HDR), jr.encode_header_blob(jr.OPENSSL_HDR)
    big = dict(jr.OPENSSL_HDR)
    big[5000] = "x" * 9000
    bdb = jr.build_bdb_packages([bash, jr.encode_header_blob(big)])
    torn = bytearray(jr.build_bdb_packages([bash]))
    torn[4096 + 28 : 4096 + 30] = b"\xff\xff"
    ndb = jr.build_ndb_packages([bash, openssl])
    return {
        "sqlite": ("parse_rpmdb_sqlite", jr._rpm_sqlite([jr.OPENSSL_HDR, jr.BASH_HDR])),
        "bdb": ("parse_rpmdb_bdb", bdb),
        "bdb-big-endian-inline": ("parse_rpmdb_bdb", jr.build_bdb_packages(
            [bash], endian=">", inline_small=True)),
        "bdb-torn": ("parse_rpmdb_bdb", bytes(torn)),
        "bdb-zeros": ("parse_rpmdb_bdb", b"\x00" * 600),
        "ndb": ("parse_rpmdb_ndb", ndb),
        "ndb-torn": ("parse_rpmdb_ndb", ndb[:40]),
    }


@pytest.mark.parametrize("case", list(_rpm_cases()))
def test_rpmdb_readers_equal_the_reference(case):
    fn, data = _rpm_cases()[case]
    got = _outcome(getattr(pkg_rpm, fn), data)
    want = _outcome(getattr(ref_rpm, fn), data)
    assert (_pkgs(got) if isinstance(got, list) else got) == (
        _pkgs(want) if isinstance(want, list) else want)
    if not case.endswith(("torn", "zeros")):
        assert got


def _sqlite_javadb(d) -> None:
    conn = sqlite3.connect(str(d / "trivy-java.db"))
    conn.execute("CREATE TABLE indices(group_id TEXT, artifact_id TEXT, version TEXT, "
                 "sha1 BLOB, archive_type TEXT)")
    rows = [("org.apache.logging.log4j", "log4j-core", "2.14.1", bytes.fromhex("aa" * 20), "jar"),
            ("com.acme", "widget", "1.4", "cc" * 20, "jar")]
    rows += [(g, "jstl", "1.2", b"\x01" * 20, "jar") for g in ("javax.servlet", "jstl", "jstl")]
    conn.executemany("INSERT INTO indices VALUES (?, ?, ?, ?, ?)", rows)
    conn.commit()
    conn.close()


@pytest.mark.parametrize("layout", ["json", "sqlite"])
def test_javadb_equals_the_reference(tmp_path, layout, monkeypatch):
    if layout == "json":
        entries = {"aa" * 20: "org.apache.logging.log4j:log4j-core:2.14.1",
                   "ab" * 20: "g:a:1", "cc" * 20: "bad-gav"}
        javadb.build_javadb(str(tmp_path / "port"), entries)
        ref_javadb.build_javadb(str(tmp_path / "ref"), entries)
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
        port_dir = ref_dir = tmp_path / "port"
    else:
        port_dir = ref_dir = tmp_path
        _sqlite_javadb(tmp_path)
    monkeypatch.setenv("TRIVY_TPU_JAVA_DB_DIR", str(port_dir))
    got, want = javadb.open_default_javadb(), ref_javadb.open_default_javadb()
    assert type(got).__name__ == type(want).__name__
    for sha in ("aa" * 20, "ab" * 20, "cc" * 20, "bb" * 20, "nothex!"):
        assert got.lookup(sha) == want.lookup(sha)
    if layout == "sqlite":
        for art in (("jstl", "1.2"), ("absent", "1"), ("widget", "1.4")):
            assert got.search_by_artifact_id(*art) == want.search_by_artifact_id(*art)
    monkeypatch.setenv("TRIVY_TPU_JAVA_DB_DIR", str(ref_dir / "absent"))
    assert javadb.open_default_javadb() is ref_javadb.open_default_javadb() is None


NOW = dt.datetime(2026, 3, 1, 12, tzinfo=dt.timezone.utc)
GATE_CASES = {
    "missing": None,
    "fresh": {"Version": 2, "NextUpdate": "2026-03-02T00:00:00Z"},
    "stale": {"Version": 2, "NextUpdate": "2026-02-01T00:00:00Z",
              "DownloadedAt": "2026-02-01T00:00:00Z"},
    "throttled": {"Version": 2, "NextUpdate": "2026-02-01T00:00:00Z",
                  "DownloadedAt": "2026-03-01T11:30:00Z"},
    "old-schema": {"Version": 1},
    "new-schema": {"Version": 3},
    "torn": "{",
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_db_update_gate_equals_the_reference(tmp_path, case):
    meta = GATE_CASES[case]
    if meta is not None:
        (tmp_path / "metadata.json").write_text(meta if isinstance(meta, str) else json.dumps(meta))
    for skip in (False, True):
        got = _outcome(client.DBClient(str(tmp_path), clock=lambda: NOW).needs_update, skip)
        want = _outcome(ref_client.DBClient(str(tmp_path), clock=lambda: NOW).needs_update, skip)
        assert got == want
        if got == "DBError":
            with pytest.raises(client.DBError) as e:
                client.DBClient(str(tmp_path), clock=lambda: NOW).ensure(skip=skip)
            with pytest.raises(ref_client.DBError) as r:
                ref_client.DBClient(str(tmp_path), clock=lambda: NOW).ensure(skip=skip)
            assert str(e.value) == str(r.value)
    # a DB that needs one is downloaded, as the reference's is (the pull
    # itself, over OCI, is held to the reference in test_torch_oci_db.py;
    # here `download` is recorded, so nothing is fetched)
    pulls = []
    for mod in (client, ref_client):
        c = mod.DBClient(str(tmp_path), clock=lambda: NOW)
        c.download = lambda mod=mod: pulls.append(mod.__name__)
        if _outcome(c.needs_update, False) is True:
            assert c.ensure() is True
    assert pulls in ([], ["trivy_tpu_torch.db.client", "trivy_tpu.db.client"])
    assert bool(pulls) == (_outcome(client.DBClient(str(tmp_path), clock=lambda: NOW)
                                    .needs_update, False) is True)


# -- the detectors -------------------------------------------------------------------


DETECT_DB = {
    "alpine 3.15": {"musl": [{"VulnerabilityID": "CVE-A1", "FixedVersion": "1.2.3-r0",
                              "Severity": "HIGH"}],
                    "busybox": [{"VulnerabilityID": "CVE-A2", "FixedVersion": "1.34.0-r0"}]},
    "debian 11": {"openssl": [{"VulnerabilityID": "CVE-D1", "FixedVersion": "1.1.1n-0+deb11u4",
                               "VendorSeverity": {"debian": "LOW", "nvd": "HIGH"}},
                              {"VulnerabilityID": "CVE-D2"}]},
    "ubuntu 22.04": {"zlib": [{"VulnerabilityID": "CVE-U1", "FixedVersion": "1:1.2.11.dfsg-2ubuntu9.2",
                               "Severity": "MEDIUM"}]},
    "redhat 9": {"openssl": [{"VulnerabilityID": "CVE-R1", "FixedVersion": "1:3.0.7-18.el9",
                              "Severity": "HIGH"}]},
    "npm": {"lodash": [{"VulnerabilityID": "CVE-N1", "VulnerableVersions": "<4.17.21",
                        "FixedVersion": "4.17.21", "Severity": "CRITICAL"}],
            "left-pad": [{"VulnerabilityID": "GHSA-x", "VulnerableVersions": ">=1.0.0, <1.3.1",
                          "VendorSeverity": {"ghsa": "MEDIUM"}}]},
    "pip": {"requests": [{"VulnerabilityID": "PYSEC-1", "FixedVersion": "2.31.0"}]},
    "go": {"golang.org/x/text": [{"VulnerabilityID": "GO-1", "FixedVersion": "v0.3.8"}]},
    "maven": {"org.apache.logging.log4j:log4j-core": [
        {"VulnerabilityID": "CVE-2021-44228", "VulnerableVersions": ">=2.0-beta9, <2.15.0",
         "FixedVersion": "2.15.0", "Severity": "CRITICAL"}]},
}
OSES = [("alpine", "3.15.4"), ("debian", "11.6"), ("ubuntu", "22.04"), ("redhat", "9.2"),
        ("debian", "8"), ("arch", "1")]
OS_PKGS = [("musl", "1.2.2-r7", "musl", 0, ""), ("busybox", "1.34.1-r5", "busybox", 0, ""),
           ("libssl1.1", "1.1.1n-0+deb11u3", "openssl", 0, ""),
           ("zlib1g", "1.2.11.dfsg-2ubuntu9", "zlib", 1, ""),
           ("openssl-libs", "3.0.7", "openssl", 1, "16.el9")]
APPS = [("npm", "app/package-lock.json", [("lodash", "4.17.20"), ("left-pad", "1.3.0"),
                                          ("left-pad", "1.3.1")]),
        ("pip", "requirements.txt", [("requests", "2.28.0"), ("requests", "")]),
        ("gobinary", "bin/tool", [("golang.org/x/text", "v0.3.7")]),
        ("jar", "app/x.jar", [("org.apache.logging.log4j:log4j-core", "2.14.1")]),
        ("conda-pkg", "c", [("lodash", "1")])]


def _detail(mod_os, mod_pkg, mod_app, mod_detail, family, name):
    pkgs = [mod_pkg(id=f"{n}@{v}", name=n, version=v, src_name=s, src_version=v, epoch=e,
                    release=r, src_release=r, src_epoch=e) for n, v, s, e, r in OS_PKGS]
    apps = [mod_app(app_type=t, file_path=f, packages=[
        mod_pkg(id=f"{n}@{v}", name=n, version=v) for n, v in ps]) for t, f, ps in APPS]
    return mod_detail(os=mod_os(family=family, name=name), packages=pkgs, applications=apps)


@pytest.mark.parametrize("family, name", OSES, ids=[f"{f}-{n}" for f, n in OSES])
@pytest.mark.parametrize("list_all", [False, True])
def test_vulnerability_scanner_equals_the_reference(tmp_path, family, name, list_all):
    vulndb.build_db(str(tmp_path), DETECT_DB)
    got = vuln.init_vuln_scanner(str(tmp_path)).detect(
        "rootfs", _detail(OS, Package, Application, ArtifactDetail, family, name),
        ScanOptions(list_all_packages=list_all))
    want = ref_vuln.init_vuln_scanner(str(tmp_path)).detect(
        "rootfs", _detail(RefOS, RefPackage, RefApplication, RefDetail, family, name),
        RefScanOptions(list_all_packages=list_all))
    doc = [r.to_json() for r in got]
    assert doc == [r.to_json() for r in want]
    ids = {v["VulnerabilityID"] for r in doc for v in r.get("Vulnerabilities", [])}
    assert {"CVE-N1", "GHSA-x", "PYSEC-1", "GO-1", "CVE-2021-44228"} <= ids
    os_found = list_all or (family in ("alpine", "debian", "ubuntu", "redhat") and name != "8")
    assert [r["Class"] for r in doc] == ["os-pkgs"] * os_found + ["lang-pkgs"] * (4 + list_all)


def test_no_db_means_no_scanner_as_in_the_reference(tmp_path):
    assert vuln.init_vuln_scanner() is ref_vuln.init_vuln_scanner() is None
    assert vuln.init_vuln_scanner("", str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        vuln.init_vuln_scanner(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        ref_vuln.init_vuln_scanner(str(tmp_path / "absent"))


@pytest.mark.parametrize("source", ["alpine", "debian", "ubuntu", "redhat", "ghsa", "nvd", "npm",
                                    "unknown"])
def test_severity_and_eol_equal_the_reference(source):
    for vid, sev, sources in (("CVE-1", "", {}), ("CVE-2", "HIGH", {"nvd": "MEDIUM"}),
                              ("GHSA-3", "", {"ghsa": "moderate", "nvd": "LOW"}),
                              ("CVE-4", "important", {source: "critical"}),
                              ("CVE-5", "", {"redhat": "Low", "debian": "unimportant"})):
        adv = vulndb.Advisory(vid, severity=sev, severity_sources=dict(sources))
        ref_adv = ref_vulndb.Advisory(vid, severity=sev, severity_sources=dict(sources))
        assert severity.resolve_severity(adv, source) == ref_severity.resolve_severity(
            ref_adv, source)
    for fam, ver in (("alpine", "3.15"), ("debian", "8"), ("debian", "12"), ("ubuntu", "14.04"),
                     ("redhat", "7"), ("centos", "8"), ("none", "1")):
        for when in (dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc), NOW):
            assert _outcome(eol.is_supported_version, fam, ver, when) == _outcome(
                ref_eol.is_supported_version, fam, ver, when)
