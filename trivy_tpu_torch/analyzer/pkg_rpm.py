"""RPM database analyzer (pkg/fanal/analyzer/pkg/rpm/rpm.go).

Reads the rpmdb of RHEL-family images.  Modern databases (RHEL9+, Fedora,
recent Amazon Linux) are sqlite — parsed with the stdlib sqlite3 module;
legacy BerkeleyDB hash databases (`Packages` on RHEL/CentOS <= 8, Amazon
Linux 2) read through the from-scratch BDB reader (trivy_tpu_torch/db/bdb.py).
ndb databases (`Packages.db`, SLE 15 / openSUSE Tumbleweed) read through
trivy_tpu_torch/db/ndb.py.  All three feed the same rpm header-blob decoder
(the store format: two big-endian counts, an index of 16-byte (tag,
type, offset, count) entries, then the data region), matching the
reference's go-rpmdb coverage.

Copied from `trivy_tpu/analyzer/pkg_rpm.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import struct
import tempfile

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    register_analyzer,
)
from trivy_tpu_torch.atypes import Package, PackageInfo

logger = logging.getLogger(__name__)

RPM = "rpm"

_SQLITE_PATHS = (
    "var/lib/rpm/rpmdb.sqlite",
    "usr/lib/sysimage/rpm/rpmdb.sqlite",
)
_BDB_PATHS = (
    "var/lib/rpm/Packages",
    "usr/lib/sysimage/rpm/Packages",
)
_NDB_PATHS = (
    "var/lib/rpm/Packages.db",
    "usr/lib/sysimage/rpm/Packages.db",
)

# rpm header tags (rpmtag.h)
_TAG_NAME = 1000
_TAG_VERSION = 1001
_TAG_RELEASE = 1002
_TAG_EPOCH = 1003
_TAG_ARCH = 1022
_TAG_SOURCERPM = 1044
_TAG_LICENSE = 1014
_TAG_MODULARITYLABEL = 5096


def parse_header_blob(blob: bytes) -> dict[int, object]:
    """Decode an rpm header store: il, dl (4-byte BE counts), il 16-byte
    index entries, then the data region.  Returns tag -> decoded value for
    the string/int types the analyzer needs."""
    if len(blob) < 8:
        return {}
    il, dl = struct.unpack(">II", blob[:8])
    index_end = 8 + il * 16
    if il > 65536 or len(blob) < index_end + dl:
        return {}
    data = blob[index_end : index_end + dl]
    out: dict[int, object] = {}
    for i in range(il):
        tag, typ, off, count = struct.unpack(
            ">IIII", blob[8 + i * 16 : 8 + (i + 1) * 16]
        )
        if off > len(data):
            continue
        if typ == 6 or typ == 9:  # STRING / I18NSTRING (first value)
            end = data.find(b"\x00", off)
            if end != -1:
                out[tag] = data[off:end].decode("utf-8", "replace")
        elif typ == 4 and count >= 1 and off + 4 <= len(data):  # INT32
            out[tag] = struct.unpack(">I", data[off : off + 4])[0]
        elif typ == 3 and count >= 1 and off + 2 <= len(data):  # INT16
            out[tag] = struct.unpack(">H", data[off : off + 2])[0]
        elif typ == 8:  # STRING_ARRAY (first value suffices here)
            end = data.find(b"\x00", off)
            if end != -1:
                out[tag] = data[off:end].decode("utf-8", "replace")
    return out


def _src_name(sourcerpm: str) -> str:
    """name-version-release.src.rpm -> name (rpm.go splitFileName)."""
    s = sourcerpm
    for suffix in (".src.rpm", ".nosrc.rpm", ".rpm"):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            break
    # strip release then version
    s, _, _ = s.rpartition("-")
    s, _, _ = s.rpartition("-")
    return s


def _packages_from_blobs(blobs) -> list[Package]:
    out: list[Package] = []
    for blob in blobs:
        hdr = parse_header_blob(blob)
        name = hdr.get(_TAG_NAME, "")
        version = hdr.get(_TAG_VERSION, "")
        if not name or not version:
            continue
        release = hdr.get(_TAG_RELEASE, "")
        epoch = int(hdr.get(_TAG_EPOCH, 0) or 0)
        srpm = hdr.get(_TAG_SOURCERPM, "")
        out.append(
            Package(
                id=f"{name}@{version}-{release}",
                name=str(name),
                version=str(version),
                release=str(release),
                epoch=epoch,
                arch=str(hdr.get(_TAG_ARCH, "")),
                src_name=_src_name(str(srpm)) if srpm else str(name),
                src_version=str(version),
                src_release=str(release),
                licenses=[str(hdr[_TAG_LICENSE])] if _TAG_LICENSE in hdr else [],
            )
        )
    return out


def parse_rpmdb_sqlite(content: bytes) -> list[Package]:
    """The sqlite rpmdb: table Packages(hnum, blob) of header stores."""
    with tempfile.NamedTemporaryFile(suffix=".sqlite", delete=False) as tmp:
        tmp.write(content)
        path = tmp.name
    try:
        conn = sqlite3.connect(path)
        try:
            rows = conn.execute("SELECT blob FROM Packages").fetchall()
        finally:
            conn.close()
    except sqlite3.DatabaseError:
        return []
    finally:
        os.unlink(path)
    return _packages_from_blobs(blob for (blob,) in rows)


def parse_rpmdb_bdb(content: bytes) -> list[Package]:
    """The BDB hash rpmdb (CentOS <= 8 `Packages`): one header blob per
    stored value."""
    from trivy_tpu_torch.db.bdb import BdbError, BdbHashReader

    try:
        return _packages_from_blobs(BdbHashReader(content).values())
    except BdbError as e:
        logger.warning("unreadable BerkeleyDB rpm database: %s", e)
        return []


def parse_rpmdb_ndb(content: bytes) -> list[Package]:
    """The ndb rpmdb (SLE 15 / Tumbleweed `Packages.db`)."""
    from trivy_tpu_torch.db.ndb import NdbError, NdbReader

    try:
        return _packages_from_blobs(NdbReader(content).values())
    except NdbError as e:
        logger.warning("unreadable ndb rpm database: %s", e)
        return []


class RpmDbAnalyzer(Analyzer):
    def type(self) -> str:
        return RPM

    def version(self) -> int:
        return 3  # v2: BDB hash parsed; v3: ndb Packages.db parsed

    def required(self, file_path: str, size: int, mode: int) -> bool:
        p = file_path.lstrip("/")
        return p in _SQLITE_PATHS or p in _BDB_PATHS or p in _NDB_PATHS

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        from trivy_tpu_torch.db.bdb import is_bdb_hash
        from trivy_tpu_torch.db.ndb import is_ndb

        if is_bdb_hash(inp.content):
            pkgs = parse_rpmdb_bdb(inp.content)
        elif is_ndb(inp.content):
            pkgs = parse_rpmdb_ndb(inp.content)
        else:
            pkgs = parse_rpmdb_sqlite(inp.content)
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[
                PackageInfo(file_path=inp.file_path, packages=pkgs)
            ]
        )


register_analyzer(RpmDbAnalyzer)
