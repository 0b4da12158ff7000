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
JAX package.  It keeps the update gate (`Metadata`, `needs_update`, the
one-hour throttle, `ensure(skip=True)`), which `--skip-db-update` needs.
The download over OCI and `build_db_archive` wait for ROADMAP A13c:
`download` raises `DBError` naming it.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
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
        """db.go:153 Download: the pull over OCI waits for ROADMAP A13c."""
        raise DBError(
            "the vulnerability DB download is not ported yet (ROADMAP A13c); "
            "pass --db-dir with a local DB"
        )

    def ensure(self, skip: bool = False) -> bool:
        """Download when needed; returns True when a download happened."""
        if self.needs_update(skip=skip):
            logger.info("Downloading vulnerability DB from %s", self.repository)
            self.download()
            return True
        return False

