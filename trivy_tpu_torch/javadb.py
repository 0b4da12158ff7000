"""Java index DB: jar sha1 digest -> (groupId, artifactId, version).

pkg/javadb/client.go analogue: a separate OCI-distributed database the jar
analyzer consults when an archive carries no pom.properties.  Wire format
here is a JSON shard map (sha1 prefix -> {sha1: "g:a:v"}) inside the OCI
layer (media type below); `ensure_javadb` gates re-downloads on the
metadata.json DownloadedAt stamp (the reference's javadb client updates
once per day, client.go).

Copied from `trivy_tpu/javadb.py`; the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.  The index is
read from `set_default_javadb_dir`, else `TRIVY_TPU_JAVA_DB_DIR`;
`--java-db-repository` pulls it over OCI (`download_javadb`,
`ensure_javadb`).
"""

from __future__ import annotations

import json
import os

JAVA_DB_MEDIA_TYPE = "application/vnd.trivy-tpu.javadb.layer.v1.tar+gzip"
DEFAULT_JAVA_DB_REPOSITORY = "ghcr.io/aquasecurity/trivy-java-db:1"

_default_dir: str = ""


def set_default_javadb_dir(path: str) -> None:
    global _default_dir
    _default_dir = path


def open_default_javadb() -> "JavaDB | SqliteJavaDB | None":
    d = _default_dir or os.environ.get("TRIVY_TPU_JAVA_DB_DIR", "")
    if d and os.path.isdir(d):
        if os.path.exists(os.path.join(d, "trivy-java.db")):
            return SqliteJavaDB(d)
        return JavaDB(d)
    return None


class SqliteJavaDB:
    """Get side over a REAL trivy-java-db file (`trivy-java.db`, SQLite —
    the artifact pkg/javadb/client.go downloads; schema: table
    indices(group_id, artifact_id, version, sha1 BLOB, archive_type)).
    Read with the stdlib sqlite3 module in read-only mode."""

    def __init__(self, db_dir: str):
        import sqlite3

        self.db_dir = db_dir
        path = os.path.join(db_dir, "trivy-java.db")
        self._conn = sqlite3.connect(
            f"file:{path}?mode=ro&immutable=1", uri=True
        )

    def lookup(self, sha1: str) -> tuple[str, str, str] | None:
        """SearchBySHA1 (client.go:135): digest -> (g, a, v).  sha1 is
        stored as a BLOB of raw bytes."""
        try:
            blob = bytes.fromhex(sha1)
        except ValueError:
            return None
        cur = self._conn.execute(
            "SELECT group_id, artifact_id, version FROM indices "
            "WHERE sha1 = ?",
            (blob,),
        )
        row = cur.fetchone()
        if row is None:
            # Some builds store the hex string instead of raw bytes.
            row = self._conn.execute(
                "SELECT group_id, artifact_id, version FROM indices "
                "WHERE sha1 = ?",
                (sha1,),
            ).fetchone()
        if row is None:
            return None
        return str(row[0]), str(row[1]), str(row[2])

    def search_by_artifact_id(
        self, artifact_id: str, version: str
    ) -> str | None:
        """SearchByArtifactID (client.go:149): the most frequent group_id
        among jar-type indices for this artifactId (ties: smallest)."""
        rows = self._conn.execute(
            "SELECT group_id FROM indices "
            "WHERE artifact_id = ? AND version = ? AND archive_type = 'jar' "
            "ORDER BY group_id",
            (artifact_id, version),
        ).fetchall()
        if not rows:
            return None
        counts: dict[str, int] = {}
        for (gid,) in rows:
            counts[gid] = counts.get(gid, 0) + 1
        # Most frequent group wins; the reference leaves ties to Go map
        # order — resolve deterministically to the smallest group id.
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0][0]


class JavaDB:
    """Get side: digest lookup over the shard files."""

    def __init__(self, db_dir: str):
        self.db_dir = db_dir
        self._shards: dict[str, dict] = {}

    def lookup(self, sha1: str) -> tuple[str, str, str] | None:
        shard = sha1[:2]
        if shard not in self._shards:
            path = os.path.join(self.db_dir, f"java-{shard}.json")
            try:
                with open(path, encoding="utf-8") as f:
                    self._shards[shard] = json.load(f)
            except (OSError, ValueError):
                self._shards[shard] = {}
        gav = self._shards[shard].get(sha1)
        if not gav:
            return None
        parts = gav.split(":")
        if len(parts) != 3:
            return None
        return parts[0], parts[1], parts[2]


def build_javadb(db_dir: str, entries: dict[str, str]) -> None:
    """Fixture builder: {sha1: "g:a:v"} -> shard files (the dbtest
    pattern)."""
    os.makedirs(db_dir, exist_ok=True)
    shards: dict[str, dict[str, str]] = {}
    for sha1, gav in entries.items():
        shards.setdefault(sha1[:2], {})[sha1] = gav
    for shard, data in shards.items():
        with open(
            os.path.join(db_dir, f"java-{shard}.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(data, f)


def download_javadb(
    db_dir: str,
    repository: str = DEFAULT_JAVA_DB_REPOSITORY,
    insecure: bool = False,
) -> None:
    """javadb client.go Download: pull the OCI layer and extract shards."""
    import datetime
    import tarfile

    from trivy_tpu_torch.oci import OciArtifact

    os.makedirs(db_dir, exist_ok=True)
    art = OciArtifact(repository, insecure=insecure)
    extracted: set[str] = set()
    with art.download_layer(JAVA_DB_MEDIA_TYPE) as blob:
        with tarfile.open(fileobj=blob, mode="r:*") as tf:
            for member in tf.getmembers():
                if not member.isfile() or ".." in member.name:
                    continue
                name = os.path.basename(member.name)
                extracted.add(name)
                with open(os.path.join(db_dir, name), "wb") as out:
                    out.write(tf.extractfile(member).read())
    # open_default_javadb prefers trivy-java.db; a shard-only refresh must
    # not leave a stale SQLite index shadowing it (db/client.py contract).
    if "trivy-java.db" not in extracted:
        try:
            os.unlink(os.path.join(db_dir, "trivy-java.db"))
        except OSError:
            pass
    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat()
    with open(os.path.join(db_dir, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump({"DownloadedAt": stamp}, f)


def ensure_javadb(
    db_dir: str,
    repository: str = DEFAULT_JAVA_DB_REPOSITORY,
    insecure: bool = False,
    max_age_hours: float = 24.0,
) -> bool:
    """Download unless the local copy is younger than `max_age_hours` (the
    reference's javadb updates once a day).  Returns True on download."""
    import datetime

    from trivy_tpu_torch.db.client import _parse_time

    meta_path = os.path.join(db_dir, "metadata.json")
    try:
        with open(meta_path, encoding="utf-8") as f:
            stamp = json.load(f).get("DownloadedAt", "")
        age = datetime.datetime.now(datetime.timezone.utc) - _parse_time(stamp)
        if stamp and age < datetime.timedelta(hours=max_age_hours):
            return False
    except (OSError, ValueError):
        pass
    download_javadb(db_dir, repository, insecure)
    return True
