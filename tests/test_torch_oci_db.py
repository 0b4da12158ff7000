"""The port's DB pulls over OCI (`trivy_tpu_torch/oci.py`, `db/client.py`
`DBClient.download`, `javadb.py` `download_javadb`/`ensure_javadb`, and
`--db-repository`/`--java-db-repository` on the CLI) against the
reference's, from an in-process registry that serves a vulnerability DB
artifact (`build_db_archive`) and a Java index artifact, on the CPU, the
twins of `tests/test_vulndb_client.py:167`, `:192`:

* the fixture archive equal to the reference builder's; the extracted
  files of both pulls byte-equal to the reference's;
* `needs_update`'s cases (first run, fresh, stale, the one-hour throttle,
  old and newer schema, `--skip-db-update` on a first run) with a download
  behind them: the same decision, the same error, the same files;
* `rootfs` and `image --input` with `--db-repository` and no `--db-dir`:
  whole JSON reports equal to the reference CLI's and to the `--db-dir`
  run's; a jar named only by the Java index through
  `--java-db-repository`, equal to the reference CLI's and to the run over
  the local index; a repository no registry serves exits 2 like the
  reference.

Tolerance: exact.
"""

import contextlib
import datetime as dt
import gzip
import hashlib
import io
import json
import os
import tarfile

import pytest

import test_torch_image as tim
import test_torch_pkg_analyzers as pa
from trivy_tpu import cli as ref_cli
from trivy_tpu import javadb as ref_javadb
from trivy_tpu.db import client as ref_client
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import javadb
from trivy_tpu_torch.db import client
from trivy_tpu_torch.db.vulndb import build_db
from trivy_tpu_torch.image.fixtures import (
    artifact_manifest,
    serve_registry,
    sha256_digest,
    write_docker_archive,
)

UTC = dt.timezone.utc
BUCKETS = {
    "debian 12": tim.DB["debian 12"],
    "npm": tim.DB["npm"],
    "alpine 3.19": {"busybox": [{"VulnerabilityID": "CVE-2023-42363",
                                 "FixedVersion": "1.36.1-r1", "Severity": "MEDIUM",
                                 "VendorSeverity": {"alpine": "MEDIUM", "nvd": "HIGH"}}]},
    "maven": {"com.acme:widget": [{"VulnerabilityID": "CVE-W", "FixedVersion": "1.5",
                                   "Severity": "HIGH"}]},
}


# the bare jar, made once: a zip carries its time of writing
JAR = pa.bare_jar()
JAVA_ENTRIES = {hashlib.sha1(JAR).hexdigest(): "com.acme:widget:1.4"}


def javadb_archive() -> bytes:
    """A Java index artifact layer: the shards `build_javadb` writes for
    the bare jar, as tar.gz."""
    entries = JAVA_ENTRIES
    shards: dict = {}
    for sha1, gav in entries.items():
        shards.setdefault(sha1[:2], {})[sha1] = gav
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for shard, data in shards.items():
            raw = json.dumps(data).encode()
            info = tarfile.TarInfo(f"java-{shard}.json")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    return gzip.compress(buf.getvalue(), mtime=0)


@pytest.fixture(scope="module")
def repos():
    artifacts = {
        "aquasecurity/trivy-db": ("2", client.MEDIA_TYPE, client.build_db_archive(
            BUCKETS, next_update="2099-01-01T00:00:00Z", updated_at="2026-01-01T00:00:00Z")),
        "aquasecurity/trivy-java-db": ("1", javadb.JAVA_DB_MEDIA_TYPE, javadb_archive()),
    }
    srv = serve_registry({
        repo: {"manifests": {tag: artifact_manifest(media, layer)},
               "blobs": {sha256_digest(layer): layer}}
        for repo, (tag, media, layer) in artifacts.items()})
    addr = f"127.0.0.1:{srv.server_address[1]}"
    yield {"db": f"{addr}/aquasecurity/trivy-db:2",
           "java": f"{addr}/aquasecurity/trivy-java-db:1",
           "missing": f"{addr}/aquasecurity/none:1"}
    srv.shutdown()
    srv.server_close()


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Temporary rules caches, no Java index from the environment, and the
    process-wide Java index directory both packages set on a pull reset
    after each test."""
    monkeypatch.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(tmp_path / "rules"))
    for var in ("TRIVY_TPU_JAVA_DB_DIR", "TRIVY_TPU_DB_DIR", "TRIVY_TPU_SCANNERS",
                "TRIVY_TPU_SECRET_BACKEND", "TRIVY_TPU_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    yield
    javadb.set_default_javadb_dir("")
    ref_javadb.set_default_javadb_dir("")


def _files(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_db_archive_equals_the_reference_builder():
    kw = dict(next_update="2099-01-01T00:00:00Z", updated_at="2026-01-01T00:00:00Z")
    got = gzip.decompress(client.build_db_archive(BUCKETS, **kw))
    assert got == gzip.decompress(ref_client.build_db_archive(BUCKETS, **kw))
    with tarfile.open(fileobj=io.BytesIO(got)) as tf:
        assert "metadata.json" in tf.getnames() and len(tf.getnames()) == len(BUCKETS) + 1


def test_db_pull_files_equal_the_reference(repos, tmp_path):
    now = dt.datetime(2026, 1, 1, tzinfo=UTC)
    dirs = {}
    for name, mod in (("port", client), ("ref", ref_client)):
        dirs[name] = str(tmp_path / name)
        c = mod.DBClient(db_dir=dirs[name], repository=repos["db"], insecure=True,
                         clock=lambda: now)
        assert c.ensure() is True and c.ensure() is False
    got = _files(dirs["port"])
    assert got == _files(dirs["ref"])
    meta = json.loads(got["metadata.json"])
    assert meta["DownloadedAt"].startswith("2026-01-01") and meta["NextUpdate"].startswith("2099")
    # the pulled DB and a local build of the same buckets read alike
    from trivy_tpu_torch.db.vulndb import VulnDB

    build_db(str(tmp_path / "local"), BUCKETS)
    pulled, local = VulnDB(dirs["port"]), VulnDB(str(tmp_path / "local"))
    for source, pkgs in BUCKETS.items():
        for pkg in pkgs:
            assert [a.to_json() for a in pulled.advisories(source, pkg)] == [
                a.to_json() for a in local.advisories(source, pkg)]


def test_javadb_pull_files_equal_the_reference(repos, tmp_path):
    for name, mod in (("port", javadb), ("ref", ref_javadb)):
        d = str(tmp_path / name)
        (tmp_path / name).mkdir()
        (tmp_path / name / "trivy-java.db").write_bytes(b"stale")
        assert mod.ensure_javadb(d, repository=repos["java"], insecure=True) is True
        assert mod.ensure_javadb(d, repository=repos["java"], insecure=True) is False
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(got) == sorted(want) and "trivy-java.db" not in got
    assert {k: v for k, v in got.items() if k != "metadata.json"} == {
        k: v for k, v in want.items() if k != "metadata.json"}
    assert set(json.loads(got["metadata.json"])) == {"DownloadedAt"}
    db = javadb.JavaDB(str(tmp_path / "port"))
    assert db.lookup(hashlib.sha1(JAR).hexdigest()) == ("com.acme", "widget", "1.4")


# needs_update's cases (tests/test_vulndb_client.py:108-164), each with the
# registry behind it: (metadata or None, skip, expected ensure() or error)
CASES = {
    "first-run": (None, False, True),
    "skip-on-first-run": (None, True, "DBError"),
    "fresh": (dict(next_update="2026-06-01T00:00:00Z"), False, False),
    "stale": (dict(next_update="2025-01-01T00:00:00Z",
                   downloaded_at="2025-01-01T00:00:00Z"), False, True),
    "one-hour-throttle": (dict(next_update="2025-01-01T00:00:00Z",
                               downloaded_at="2026-01-01T09:30:00Z"), False, False),
    "newer-schema": (dict(version=client.SCHEMA_VERSION + 1), False, "DBError"),
    "old-schema": (dict(version=client.SCHEMA_VERSION - 1), False, True),
    "old-schema-skip": (dict(version=client.SCHEMA_VERSION - 1), True, "DBError"),
}


@pytest.mark.parametrize("case", CASES)
def test_needs_update_with_a_download_behind_it(repos, tmp_path, case):
    meta, skip, want = CASES[case]
    now = dt.datetime(2026, 1, 1, 10, 0, tzinfo=UTC)
    outcomes = []
    for name, mod in (("port", client), ("ref", ref_client)):
        d = tmp_path / name
        d.mkdir()
        if meta is not None:
            m = mod.Metadata(**{"version": mod.SCHEMA_VERSION, **meta})
            (d / "metadata.json").write_text(json.dumps(m.to_json()))
        c = mod.DBClient(db_dir=str(d), repository=repos["db"], insecure=True,
                         clock=lambda: now)
        try:
            outcomes.append((c.ensure(skip=skip), _files(d)))
        except mod.DBError as e:
            outcomes.append(("DBError", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == want
    if want is True:
        assert len(outcomes[0][1]) == len(BUCKETS) + 1


def _rootfs(tmp_path):
    root = tmp_path / "rootfs"
    (root / "etc").mkdir(parents=True)
    (root / "lib" / "apk" / "db").mkdir(parents=True)
    (root / "etc" / "os-release").write_text('ID=alpine\nVERSION_ID=3.19.1\n'
                                             'PRETTY_NAME="Alpine Linux v3.19"\n')
    (root / "lib" / "apk" / "db" / "installed").write_text(
        "C:Q1abcdef\nP:busybox\nV:1.36.1-r0\nA:x86_64\n\n")
    return str(root)


@pytest.mark.parametrize("kind", ["rootfs", "image"])
def test_db_repository_report_equals_the_reference_and_the_db_dir_run(repos, tmp_path, kind):
    if kind == "rootfs":
        target = port_target = [_rootfs(tmp_path)]
    else:
        archive = str(tmp_path / "app.tar")
        write_docker_archive(archive, *tim.seeded_image())
        target, port_target = ["--input", archive, archive], ["--input", archive]
    argv = [kind, "-f", "json", "--db-repository", repos["db"], "--insecure"]
    prc, pout, perr = _run(cli.main, [*argv, "--device", "cpu", "--cache-dir",
                                      str(tmp_path / "pc"), *port_target])
    rrc, rout, rerr = _run(ref_cli.main, [*argv, "--cache-dir", str(tmp_path / "rc"), *target])
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    doc = json.loads(pout)
    assert doc == json.loads(rout)
    got, want = _files(tmp_path / "pc" / "db"), _files(tmp_path / "rc" / "db")
    assert got.pop("metadata.json")[:-40] == want.pop("metadata.json")[:-40]
    assert got == want
    build_db(str(tmp_path / "local"), BUCKETS)
    rc, out, _ = _run(cli.main, [kind, "-f", "json", "--device", "cpu", "--db-dir",
                                 str(tmp_path / "local"), *port_target])
    assert rc == 0 and json.loads(out) == doc
    ids = {v["VulnerabilityID"] for r in doc["Results"] for v in r.get("Vulnerabilities", [])}
    assert ids == ({"CVE-2023-42363"} if kind == "rootfs" else
                   {"CVE-2099-0001", "CVE-2099-0003", "CVE-2021-23337"})


def test_java_db_repository_report_equals_the_reference_and_the_local_index(
        repos, tmp_path, monkeypatch):
    tree = tmp_path / "tree"
    (tree / "libs").mkdir(parents=True)
    (tree / "libs" / "widget.jar").write_bytes(JAR)
    build_db(str(tmp_path / "db"), BUCKETS)
    argv = ["fs", "-f", "json", "--scanners", "vuln", "--db-dir", str(tmp_path / "db")]
    pull = ["--java-db-repository", repos["java"], "--insecure"]
    prc, pout, perr = _run(cli.main, [*argv, *pull, "--device", "cpu", str(tree)])
    javadb.set_default_javadb_dir("")
    rrc, rout, rerr = _run(ref_cli.main, [*argv, *pull, str(tree)])
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    doc = json.loads(pout)
    assert doc == json.loads(rout)
    assert [(v["PkgName"], v["VulnerabilityID"]) for r in doc["Results"]
            for v in r.get("Vulnerabilities", [])] == [("com.acme:widget", "CVE-W")]
    pulled = str(tmp_path / "db" / "java-db")
    assert sorted(os.listdir(pulled)) != []
    javadb.set_default_javadb_dir("")
    local = tmp_path / "javadb"
    javadb.build_javadb(str(local), JAVA_ENTRIES)
    monkeypatch.setenv("TRIVY_TPU_JAVA_DB_DIR", str(local))
    rc, out, _ = _run(cli.main, [*argv, "--device", "cpu", str(tree)])
    assert rc == 0 and json.loads(out) == doc


def test_unserved_db_repository_exits_2_like_the_reference(repos, tmp_path):
    argv = ["rootfs", "--db-repository", repos["missing"], "--insecure", "--cache-dir",
            str(tmp_path / "c"), _rootfs(tmp_path)]
    prc, pout, perr = _run(cli.main, [argv[0], "--device", "cpu", *argv[1:]])
    rrc, rout, rerr = _run(ref_cli.main, argv)
    assert prc == rrc == 2 and pout == rout == ""
    assert perr == rerr and "HTTP 404" in perr
