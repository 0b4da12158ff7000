"""Per-blob scan-result cache: the fleet's scan-once-per-layer plane.

At registry scale most image layers are shared, so millions of scans
collapse to a small set of novel blobs (mirroring the economics of Trivy's ArtifactCache split in
`pkg/fanal/cache/`).  This module stores the *device scan verdict* for a
single content blob, keyed by everything that could change it:

    result key = sha256(blob_digest \\x00 ruleset_digest \\x00 schema
                        \\x00 program_id)

- `blob_digest` is sha256 over the exact bytes the engine scanned, so
  identical content hits regardless of path or image;
- `ruleset_digest` comes from the ruleset registry (registry/digest.py) —
  a `rules push` changes the digest and naturally invalidates exactly
  the entries scanned under the old rules, nothing else;
- `engine_schema_version` (RESULT_SCHEMA_VERSION here) versions the
  finding encoding itself, so a wire-format change never rehydrates
  garbage;
- `program_id` names which scan program's verdict this is
  (programs/base.py): one device pass now yields several per-blob
  verdicts, and a license verdict must never answer a secret lookup.
  For license entries pass the program's `verdict_digest()` as
  `ruleset_digest` — the classifier corpus is part of the verdict
  identity there, not just the anchor ruleset.

Values ride the existing BlobInfo JSON document (atypes.py secret
round-trip) through any ArtifactCache backend — memory, FS, Redis, S3,
or the TieredCache chain — with the cached Secret's path stripped at
put time and the *requester's* path restored at hit time, so a hit is
byte-identical to a cold scan of the same bytes under any name.

Copied from `trivy_tpu/cache/results.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import hashlib
import threading

from trivy_tpu_torch.atypes import BlobInfo
from trivy_tpu_torch.cache import stats as cache_stats
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.cache.tiered import TieredCache
from trivy_tpu_torch.ftypes import Secret

# Version of the cached-finding encoding (the third key component).
# Bump on any change to SecretFinding/Code/Layer JSON shape — and on any
# change to the key derivation itself (v2 added the program_id
# component; v1 keys must never alias v2 entries).
RESULT_SCHEMA_VERSION = 2


def content_digest(data: bytes) -> str:
    """Canonical digest of the exact bytes handed to the engine."""
    return "sha256:" + hashlib.sha256(data).hexdigest()


def result_key(
    blob_digest: str,
    ruleset_digest: str,
    schema_version: int = RESULT_SCHEMA_VERSION,
    program_id: str = "secret",
) -> str:
    """The composite content-addressed key (itself `sha256:<hex>` so the
    FS backend files it under the plain hex digest)."""
    h = hashlib.sha256()
    h.update(blob_digest.encode("utf-8"))
    h.update(b"\x00")
    h.update(ruleset_digest.encode("utf-8"))
    h.update(b"\x00")
    h.update(str(schema_version).encode("ascii"))
    h.update(b"\x00")
    h.update(program_id.encode("utf-8"))
    return "sha256:" + h.hexdigest()


# Marker distinguishing an index document from a verdict document; also
# the CustomResources entry kind the index rides under.
INDEX_KIND = "trivy-tpu/result-index"


def index_key(
    ruleset_digest: str,
    program_id: str = "secret",
    schema_version: int = RESULT_SCHEMA_VERSION,
) -> str:
    """Key of the per-(ruleset digest, program id) reverse index — the
    set of blob digests holding cached verdicts under that digest.  The
    leading INDEX_KIND component keeps it disjoint from every
    result_key (those start with a blob digest, never the marker)."""
    h = hashlib.sha256()
    h.update(INDEX_KIND.encode("utf-8"))
    h.update(b"\x00")
    h.update(ruleset_digest.encode("utf-8"))
    h.update(b"\x00")
    h.update(str(schema_version).encode("ascii"))
    h.update(b"\x00")
    h.update(program_id.encode("utf-8"))
    return "sha256:" + h.hexdigest()


class ScanResultCache:
    """Get/put of per-blob Secret verdicts over an ArtifactCache backend.

    The backend is typically a TieredCache; any ArtifactCache works
    (tests use MemoryCache).  A *hit with zero findings* is a first-class
    verdict — clean blobs are the common case and exactly what the warm
    path must not re-scan.
    """

    def __init__(self, backend: ArtifactCache):
        self.backend = backend
        # Reverse-index write path: _indexed mirrors (index key, blob
        # digest) pairs already persisted so the steady state (same blob
        # re-verdicted under the same digest) skips the read-merge-write.
        self._index_lock = threading.Lock()
        self._indexed: set[tuple[str, str]] = set()

    def get(
        self,
        blob_digest: str,
        ruleset_digest: str,
        path: str = "",
        program_id: str = "secret",
    ) -> Secret | None:
        """The cached verdict rehydrated under `path`, or None on miss.
        A non-None return with empty findings means "scanned clean"."""
        if not ruleset_digest:
            # No digest, no key: an engine that can't identify its rules
            # must not serve stale verdicts.
            cache_stats.record_request("results", "miss")
            return None
        key = result_key(blob_digest, ruleset_digest, program_id=program_id)
        blob = self.backend.get_blob(key)
        if blob is None:
            cache_stats.record_request("results", "miss")
            return None
        cache_stats.record_request("results", "hit")
        findings = list(blob.secrets[0].findings) if blob.secrets else []
        return Secret(file_path=path, findings=findings)

    def put(
        self,
        blob_digest: str,
        ruleset_digest: str,
        secret: Secret,
        program_id: str = "secret",
    ) -> None:
        """Store the verdict for one blob (path stripped: the key is the
        content, not the name it was scanned under)."""
        if not ruleset_digest:
            return
        key = result_key(blob_digest, ruleset_digest, program_id=program_id)
        secrets = (
            [Secret(file_path="", findings=list(secret.findings))]
            if secret.findings
            else []
        )
        self.backend.put_blob(key, BlobInfo(secrets=secrets))
        self._index_add(blob_digest, ruleset_digest, program_id)

    def exists(
        self,
        blob_digest: str,
        ruleset_digest: str,
        program_id: str = "secret",
    ) -> bool:
        """Pure existence probe (no rehydration): does a cached verdict
        for this (blob, ruleset, program) exist in any tier?  The watch
        planner's novelty test — cheap by design (FS backends stat, the
        tiered chain short-circuits on its first hit)."""
        if not ruleset_digest:
            return False
        key = result_key(blob_digest, ruleset_digest, program_id=program_id)
        return self.backend.exists(key)

    def indexed_blobs(
        self,
        ruleset_digest: str,
        program_id: str = "secret",
    ) -> list[str]:
        """Blob digests holding cached verdicts under (ruleset digest,
        program id), from the persisted reverse index.  This is what lets
        the re-verification sweeper enumerate exactly the entries an old
        ruleset digest invalidated without a full tier walk."""
        if not ruleset_digest:
            return []
        blob = self.backend.get_blob(index_key(ruleset_digest, program_id))
        return sorted(self._index_entries(blob))

    def remove(
        self,
        blob_digest: str,
        ruleset_digest: str,
        program_id: str = "secret",
    ) -> None:
        """Drop one verdict and its reverse-index entry (sweeper cleanup
        after re-verdicting a blob under a new digest)."""
        if not ruleset_digest:
            return
        key = result_key(blob_digest, ruleset_digest, program_id=program_id)
        self.backend.delete_blobs([key])
        ikey = index_key(ruleset_digest, program_id)
        with self._index_lock:
            self._indexed.discard((ikey, blob_digest))
            entries = self._index_entries(self.backend.get_blob(ikey))
            if blob_digest not in entries:
                return
            entries.discard(blob_digest)
            if entries:
                self.backend.put_blob(ikey, self._index_doc(entries))
            else:
                self.backend.delete_blobs([ikey])

    def _index_add(
        self, blob_digest: str, ruleset_digest: str, program_id: str
    ) -> None:
        """Read-merge-write the reverse index under the instance lock.
        Persisting through put_blob means a TieredCache backend pops any
        negative entry for the index key on write, so a fresh verdict is
        always enumerable by the next sweep — a remembered miss never
        masks a re-scan."""
        ikey = index_key(ruleset_digest, program_id)
        pair = (ikey, blob_digest)
        with self._index_lock:
            if pair in self._indexed:
                return
            entries = self._index_entries(self.backend.get_blob(ikey))
            if blob_digest not in entries:
                entries.add(blob_digest)
                self.backend.put_blob(ikey, self._index_doc(entries))
            self._indexed.add(pair)

    @staticmethod
    def _index_doc(entries: set[str]) -> BlobInfo:
        return BlobInfo(
            custom_resources=[
                {"Kind": INDEX_KIND, "Blobs": sorted(entries)}
            ]
        )

    @staticmethod
    def _index_entries(blob: BlobInfo | None) -> set[str]:
        if blob is None:
            return set()
        for res in blob.custom_resources:
            if isinstance(res, dict) and res.get("Kind") == INDEX_KIND:
                return {str(b) for b in res.get("Blobs") or []}
        return set()

    def get_or_scan(
        self,
        blob_digest: str,
        ruleset_digest: str,
        path: str,
        scan_fn,
        program_id: str = "secret",
    ) -> Secret:
        """Hit path, or run `scan_fn()` exactly once per key across
        concurrent callers (single-flight when the backend is tiered)
        and remember its verdict."""
        hit = self.get(blob_digest, ruleset_digest, path, program_id)
        if hit is not None:
            return hit

        def _miss() -> Secret:
            verdict = scan_fn()
            self.put(blob_digest, ruleset_digest, verdict, program_id)
            return verdict

        if isinstance(self.backend, TieredCache):
            key = result_key(blob_digest, ruleset_digest, program_id=program_id)
            result = self.backend.single_flight(key, _miss)
            # The leader's verdict carries the leader's path; re-serve
            # under ours if they differ (shared findings are immutable).
            if isinstance(result, Secret) and result.file_path != path:
                return Secret(file_path=path, findings=list(result.findings))
            return result  # type: ignore[return-value]
        return _miss()

    def snapshot(self) -> dict:
        inner = getattr(self.backend, "snapshot", None)
        return {
            "schema_version": RESULT_SCHEMA_VERSION,
            "backend": type(self.backend).__name__,
            "tiers": inner() if callable(inner) else None,
        }

    def close(self) -> None:
        self.backend.close()
