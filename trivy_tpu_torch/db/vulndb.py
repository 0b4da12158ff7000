"""Vulnerability database.

The trivy-db analogue (pkg/db): advisories keyed by (data source, package
name).  The reference ships a BoltDB pulled from an OCI registry; this
framework uses a JSON tree on disk with the same logical schema, built either
from fixture YAML (the pkg/dbtest pattern, §4) or downloaded via the OCI
client (the reference's `trivy_tpu/oci.py`) in connected deployments.

Layout: <db_dir>/metadata.json + <db_dir>/<source-bucket>.json where a source
bucket is e.g. "alpine 3.15", "debian 11", "npm", "pip".

Copied from `trivy_tpu/db/vulndb.py`; the port imports nothing from the
JAX package, so it keeps its own copy of this jax-free module.  The DB's
OCI pull is `db/client.py`'s; this module reads the local copy.  A JSON
bucket's load runs under the host span `db.load`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Advisory:
    """db.Advisory (trivy-db types)."""

    vulnerability_id: str
    fixed_version: str = ""
    vulnerable_versions: str = ""  # range expr for language ecosystems
    severity: str = ""
    title: str = ""
    description: str = ""
    references: list[str] = field(default_factory=list)
    cvss_score: float = 0.0
    # source id -> severity string (trivy-db VendorSeverity); consumed by
    # the severity-source precedence resolution (detector/severity.py)
    severity_sources: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"VulnerabilityID": self.vulnerability_id}
        if self.fixed_version:
            out["FixedVersion"] = self.fixed_version
        if self.vulnerable_versions:
            out["VulnerableVersions"] = self.vulnerable_versions
        if self.severity:
            out["Severity"] = self.severity
        if self.title:
            out["Title"] = self.title
        if self.description:
            out["Description"] = self.description
        if self.references:
            out["References"] = self.references
        if self.cvss_score:
            out["CVSSScore"] = self.cvss_score
        if self.severity_sources:
            out["VendorSeverity"] = dict(self.severity_sources)
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Advisory":
        return cls(
            vulnerability_id=d.get("VulnerabilityID", ""),
            fixed_version=d.get("FixedVersion", ""),
            vulnerable_versions=d.get("VulnerableVersions", ""),
            severity=d.get("Severity", ""),
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            severity_sources=dict(d.get("VendorSeverity") or {}),
            references=list(d.get("References") or []),
            cvss_score=d.get("CVSSScore", 0.0),
        )


def _bucket_file(source: str) -> str:
    return source.replace("/", "_").replace(" ", "_") + ".json"


class VulnDB:
    """Get-side interface (trivy-db db.Operation)."""

    def __init__(self, db_dir: str):
        self.db_dir = db_dir
        self._cache: dict[str, dict[str, list[Advisory]]] = {}

    def advisories(self, source: str, pkg_name: str) -> list[Advisory]:
        bucket = self._load(source)
        return bucket.get(pkg_name, [])

    def _load(self, source: str) -> dict[str, list[Advisory]]:
        if source in self._cache:
            return self._cache[source]
        from trivy_tpu_torch.obs import trace as obs_trace

        path = os.path.join(self.db_dir, _bucket_file(source))
        bucket: dict[str, list[Advisory]] = {}
        with obs_trace.span("db.load", source=source):
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
                for pkg, advs in raw.items():
                    bucket[pkg] = [Advisory.from_json(a) for a in advs]
        self._cache[source] = bucket
        return bucket

    def metadata(self) -> dict[str, Any]:
        return _read_metadata(self.db_dir)


def _read_metadata(db_dir: str) -> dict[str, Any]:
    path = os.path.join(db_dir, "metadata.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    return {}


def build_db(
    db_dir: str, data: dict[str, dict[str, list[Advisory | dict]]]
) -> None:
    """Fixture DB builder (the pkg/dbtest InitDB pattern):
    data = {source: {pkg_name: [Advisory|dict, ...]}}."""
    os.makedirs(db_dir, exist_ok=True)
    for source, packages in data.items():
        out = {
            pkg: [
                a.to_json() if isinstance(a, Advisory) else a for a in advs
            ]
            for pkg, advs in packages.items()
        }
        with open(os.path.join(db_dir, _bucket_file(source)), "w") as f:
            json.dump(out, f, indent=1)
    meta = {"Version": 2, "UpdatedAt": "fixture"}
    with open(os.path.join(db_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)


def _sev_str(v: Any) -> str:
    """trivy-db serializes severities as int enums; tolerate strings."""
    from trivy_tpu_torch.result.filter import SEVERITIES

    if isinstance(v, int) and 0 <= v < len(SEVERITIES):
        return SEVERITIES[v]
    if isinstance(v, str):
        return v
    return ""


# Internal detector source prefix -> real trivy-db OS bucket template.
# The detectors build "redhat 8"-style sources (detector/ospkg.py); real
# trivy-db names several OS buckets differently.  Candidates are matched
# case-insensitively, with a ".0"-tolerant prefix (mariner "2" vs
# "CBL-Mariner 2.0").
_OS_BUCKET_ALIASES = {
    "redhat": "Red Hat Enterprise Linux {v}",
    "centos": "CentOS {v}",
    "amazon": "amazon linux {v}",
    "oracle": "Oracle Linux {v}",
    "photon": "Photon OS {v}",
    "cbl-mariner": "CBL-Mariner {v}",
    "suse": "SUSE Linux Enterprise {v}",
    "opensuse-leap": "openSUSE Leap {v}",
}


class BoltVulnDB:
    """Get-side interface over a REAL trivy-db file (`trivy.db`, bbolt).

    Bucket schema (trivy-db v2): <source bucket> -> <package> ->
    {vulnID: advisory JSON}; root "vulnerability" -> {vulnID: detail JSON}
    enriches severity/title/references.  Read through trivy_tpu_torch.db.bolt —
    the artifact the reference downloads drops in unchanged."""

    def __init__(self, db_dir: str):
        from trivy_tpu_torch.db.bolt import Bolt

        self.db_dir = db_dir
        self._bolt = Bolt.open(os.path.join(db_dir, "trivy.db"))
        self._details: dict[str, dict] = {}
        self._vuln_bucket = self._bolt.bucket(b"vulnerability")
        # Language buckets are "<ecosystem>::<data source name>"
        # (trivy-db bucket.go); the detectors query by plain ecosystem, so
        # resolve each source to every matching bucket once.
        self._source_buckets: dict[str, list[bytes]] = {}
        self._top_names: list[bytes] | None = None

    def _buckets_for(self, source: str) -> list[bytes]:
        hit = self._source_buckets.get(source)
        if hit is not None:
            return hit
        if self._top_names is None:
            self._top_names = [name for name, _b in self._bolt.buckets()]
        want = source.encode()
        prefix = want + b"::"
        names = [
            n for n in self._top_names if n == want or n.startswith(prefix)
        ]
        if not names:
            # OS bucket alias pass (exact internal name matched nothing).
            cands = {source.lower()}
            word, _, ver = source.partition(" ")
            tmpl = _OS_BUCKET_ALIASES.get(word)
            if tmpl and ver:
                cands.add(tmpl.format(v=ver).lower())
            names = [
                n
                for n in self._top_names
                if n.decode("utf-8", "replace").lower() in cands
                or any(
                    n.decode("utf-8", "replace").lower() == f"{c}.0"
                    or n.decode("utf-8", "replace").lower().startswith(
                        f"{c}."
                    )
                    for c in cands
                )
            ]
        self._source_buckets[source] = names
        return names

    def _detail(self, vuln_id: str) -> dict:
        if vuln_id in self._details:
            return self._details[vuln_id]
        out: dict = {}
        if self._vuln_bucket is not None:
            raw = self._vuln_bucket.get(vuln_id.encode())
            if raw:
                try:
                    out = json.loads(raw)
                except ValueError:
                    out = {}
        self._details[vuln_id] = out
        return out

    def advisories(self, source: str, pkg_name: str) -> list[Advisory]:
        out: list[Advisory] = []
        for bname in self._buckets_for(source):
            bucket = self._bolt.bucket(bname, pkg_name.encode())
            if bucket is not None:
                self._collect(bucket, out)
        return out

    def _collect(self, bucket, out: list[Advisory]) -> None:
        for vid_b, raw in bucket.items():
            vid = vid_b.decode("utf-8", "replace")
            try:
                d = json.loads(raw)
            except ValueError:
                continue
            det = self._detail(vid)
            fixed = d.get("FixedVersion", "")
            patched = d.get("PatchedVersions") or []
            if not fixed and patched:
                fixed = ", ".join(patched)
            vulnerable = " || ".join(d.get("VulnerableVersions") or [])
            cvss = 0.0
            for src in ("nvd", "redhat", "ghsa"):
                sc = (det.get("CVSS") or {}).get(src) or {}
                if sc.get("V3Score"):
                    cvss = float(sc["V3Score"])
                    break
            out.append(
                Advisory(
                    vulnerability_id=vid,
                    fixed_version=fixed,
                    vulnerable_versions=vulnerable,
                    severity=_sev_str(
                        d.get("Severity", det.get("Severity", 0))
                    ),
                    title=det.get("Title", ""),
                    description=det.get("Description", ""),
                    references=list(det.get("References") or []),
                    cvss_score=cvss,
                    severity_sources={
                        k: _sev_str(v)
                        for k, v in (det.get("VendorSeverity") or {}).items()
                    },
                )
            )

    def metadata(self) -> dict[str, Any]:
        return _read_metadata(self.db_dir)


def load_db(db_dir: str) -> "VulnDB | BoltVulnDB | None":
    if not db_dir or not os.path.isdir(db_dir):
        return None
    if os.path.exists(os.path.join(db_dir, "trivy.db")):
        from trivy_tpu_torch.db.bolt import BoltError

        try:
            return BoltVulnDB(db_dir)
        except (BoltError, OSError) as e:
            # A torn download must degrade with a pointer, not kill every
            # scan with a traceback.
            import logging

            logging.getLogger(__name__).warning(
                "trivy.db unreadable (%s); falling back to JSON buckets — "
                "re-download with --db-repository to repair",
                e,
            )
    return VulnDB(db_dir)
