"""Vulnerability DB distribution client (pkg/db/db.go analogue).

The reference pulls trivy-db — a BoltDB inside a tar.gz layer of an OCI
artifact — and gates downloads on metadata.json (schema version,
NextUpdate, DownloadedAt).  This client keeps the exact update semantics
(NeedsUpdate, db.go:96; the one-hour throttle, db.go:139 isNewDB; the
skip-update validation) over this framework's DB wire format: a tar.gz of
the JSON source buckets (db/vulndb.py layout) as the OCI layer

    application/vnd.trivy-tpu.db.layer.v1.tar+gzip

The BoltDB wire format itself is a deliberate divergence: the logical
schema (source buckets -> package -> advisories) is preserved, the byte
format is not; fixture DBs build with `build_db_archive` (the pkg/dbtest
pattern).

Copied from `trivy_tpu/db/client.py`; the port imports nothing from the
JAX package, so it keeps its own copy of this jax-free module: the update
gate, the download over OCI (`oci.py`, through the image path's registry
client) and `build_db_archive`.
"""

from __future__ import annotations

import datetime as _dt
import io
import json
import logging
import os
import tarfile
from dataclasses import dataclass, field

SCHEMA_VERSION = 2
MEDIA_TYPE = "application/vnd.trivy-tpu.db.layer.v1.tar+gzip"
DEFAULT_REPOSITORY = "ghcr.io/aquasecurity/trivy-db:2"

logger = logging.getLogger(__name__)


def _parse_time(s: str) -> _dt.datetime:
    if not s:
        return _dt.datetime.fromtimestamp(0, _dt.timezone.utc)
    t = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    if t.tzinfo is None:  # tolerate suffix-less timestamps as UTC
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t


@dataclass
class Metadata:
    """metadata.json (trivy-db metadata.Metadata)."""

    version: int = SCHEMA_VERSION
    next_update: str = ""
    updated_at: str = ""
    downloaded_at: str = ""

    def to_json(self) -> dict:
        return {
            "Version": self.version,
            "NextUpdate": self.next_update,
            "UpdatedAt": self.updated_at,
            "DownloadedAt": self.downloaded_at,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Metadata":
        return cls(
            version=int(d.get("Version", 0)),
            next_update=d.get("NextUpdate", ""),
            updated_at=d.get("UpdatedAt", ""),
            downloaded_at=d.get("DownloadedAt", ""),
        )


class DBError(RuntimeError):
    pass


@dataclass
class DBClient:
    """Update gating + download for the vuln DB directory."""

    db_dir: str
    repository: str = DEFAULT_REPOSITORY
    insecure: bool = False
    clock: object = field(default=None)  # injectable for tests (clock fake)

    def _now(self) -> _dt.datetime:
        if self.clock is not None:
            return self.clock()  # type: ignore[operator]
        return _dt.datetime.now(_dt.timezone.utc)

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.db_dir, "metadata.json")

    def metadata(self) -> Metadata | None:
        try:
            with open(self._meta_path, encoding="utf-8") as f:
                return Metadata.from_json(json.load(f))
        except (OSError, ValueError):
            return None

    def needs_update(self, skip: bool = False) -> bool:
        """db.go:96 NeedsUpdate."""
        meta = self.metadata()
        if meta is None:
            if skip:
                raise DBError(
                    "--skip-db-update cannot be specified on the first run"
                )
            meta = Metadata(version=SCHEMA_VERSION)
        if SCHEMA_VERSION < meta.version:
            raise DBError(
                f"the version of DB schema doesn't match. Local DB: "
                f"{meta.version}, Expected: {SCHEMA_VERSION}"
            )
        if skip:
            if meta.version != SCHEMA_VERSION:
                raise DBError(
                    "--skip-db-update cannot be specified with the old DB "
                    f"schema. Local DB: {meta.version}, Expected: {SCHEMA_VERSION}"
                )
            return False
        if meta.version != SCHEMA_VERSION:
            return True
        return not self._is_new_db(meta)

    def _is_new_db(self, meta: Metadata) -> bool:
        """db.go:139 isNewDB: fresh enough to skip a download."""
        now = self._now()
        if meta.next_update and now < _parse_time(meta.next_update):
            logger.debug("DB update skipped: local DB is the latest")
            return True
        if meta.downloaded_at and now < _parse_time(
            meta.downloaded_at
        ) + _dt.timedelta(hours=1):
            logger.debug("DB update skipped: downloaded within the last hour")
            return True
        return False

    def download(self) -> None:
        """db.go:153 Download: drop stale metadata, pull the OCI layer,
        extract, stamp DownloadedAt."""
        from trivy_tpu_torch.oci import OciArtifact

        try:
            os.unlink(self._meta_path)
        except OSError:
            pass
        os.makedirs(self.db_dir, exist_ok=True)
        art = OciArtifact(self.repository, insecure=self.insecure)
        extracted: set[str] = set()
        with art.download_layer(MEDIA_TYPE) as blob:
            with tarfile.open(fileobj=blob, mode="r:*") as tf:
                for member in tf.getmembers():
                    if not member.isfile() or ".." in member.name:
                        continue
                    name = os.path.basename(member.name)
                    extracted.add(name)
                    with open(os.path.join(self.db_dir, name), "wb") as out:
                        out.write(tf.extractfile(member).read())
        # A pre-existing trivy.db takes priority in load_db; if this
        # artifact did not ship one, drop the stale copy so the fresh
        # bucket files are what scans actually read.
        if "trivy.db" not in extracted:
            try:
                os.unlink(os.path.join(self.db_dir, "trivy.db"))
            except OSError:
                pass
        meta = self.metadata() or Metadata(version=SCHEMA_VERSION)
        meta.downloaded_at = (
            self._now().isoformat().replace("+00:00", "Z")
        )
        with open(self._meta_path, "w", encoding="utf-8") as f:
            json.dump(meta.to_json(), f)

    def ensure(self, skip: bool = False) -> bool:
        """Download when needed; returns True when a download happened."""
        if self.needs_update(skip=skip):
            logger.info("Downloading vulnerability DB from %s", self.repository)
            self.download()
            return True
        return False


def build_db_archive(
    buckets: dict[str, dict], next_update: str = "", updated_at: str = ""
) -> bytes:
    """Build a DB artifact layer from source buckets (the pkg/dbtest
    fixture-DB pattern): {source: {pkg_name: [advisory dicts]}} ->
    tar.gz bytes containing <source>.json files + metadata.json."""
    import gzip

    from trivy_tpu_torch.db.vulndb import _bucket_file

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:

        def add(name: str, data: bytes) -> None:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))

        for source, packages in buckets.items():
            add(_bucket_file(source), json.dumps(packages).encode())
        add(
            "metadata.json",
            json.dumps(
                Metadata(
                    version=SCHEMA_VERSION,
                    next_update=next_update,
                    updated_at=updated_at,
                ).to_json()
            ).encode(),
        )
    return gzip.compress(buf.getvalue())
