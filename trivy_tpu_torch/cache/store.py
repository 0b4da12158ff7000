"""Content-addressed scan cache.

Mirrors pkg/fanal/cache/cache.go — the ArtifactCache (Put side) /
LocalArtifactCache (Get side) interface pair and the checkpoint/resume role the
cache plays in the reference (SURVEY §5): analysis results keyed by
sha256(content + analyzer versions), so unchanged blobs are never re-analyzed
(`MissingBlobs` diffing, pkg/fanal/artifact/image/image.go:113).

Backends: in-memory dict and a JSON-files-on-disk store (the BoltDB FS cache
analogue, pkg/fanal/cache/fs.go:17).  Both sides of the interface are one
class here — the split only matters at the RPC seam, where RemoteCache
implements the Put side over HTTP (trivy_tpu/rpc/).

Copied from `trivy_tpu/cache/store.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import base64
import json
import os
import string
from typing import Iterable

from trivy_tpu_torch.atypes import BLOB_JSON_SCHEMA_VERSION, ArtifactInfo, BlobInfo
from trivy_tpu_torch.cache import stats as cache_stats

SCHEMA_VERSION = 2  # cache.go schemaVersion


class BlobNotFoundError(KeyError):
    """Requested blob IDs are not in the cache (deterministic client error)."""


class ArtifactCache:
    """Interface: cache.ArtifactCache + cache.LocalArtifactCache."""

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        raise NotImplementedError

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        raise NotImplementedError

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        raise NotImplementedError

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        raise NotImplementedError

    def exists(self, blob_id: str) -> bool:
        """Presence probe without decoding the entry.  The base form is
        a full get (always correct); backends override with a cheap
        existence check (`os.path.exists`, pipelined Redis `EXISTS`) —
        the MissingBlobs diff is O(layers) probes per image, and on warm
        fleets nearly every probe is a hit."""
        return self.get_blob(blob_id) is not None

    def missing_blobs(
        self, artifact_id: str, blob_ids: Iterable[str]
    ) -> tuple[bool, list[str]]:
        """cache.MissingBlobs: (artifact missing?, missing blob ids)."""
        missing = [b for b in blob_ids if not self.exists(b)]
        return self.get_artifact(artifact_id) is None, missing

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryCache(ArtifactCache):
    """cache.NewMemoryCache analogue; also the NopCache replacement for tests."""

    def __init__(self) -> None:
        self._artifacts: dict[str, ArtifactInfo] = {}
        self._blobs: dict[str, BlobInfo] = {}

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self._artifacts[artifact_id] = info

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self._blobs[blob_id] = info

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        return self._artifacts.get(artifact_id)

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        return self._blobs.get(blob_id)

    def exists(self, blob_id: str) -> bool:
        return blob_id in self._blobs

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        for b in blob_ids:
            self._blobs.pop(b, None)

    def clear(self) -> None:
        self._artifacts.clear()
        self._blobs.clear()


_HEX = set(string.hexdigits.lower())


def _safe_key(key: str) -> str:
    """Injective filename for a cache key.

    The dominant key shape is `sha256:<64 hex>` — keep the bare hex
    digest as the filename (readable, fixed-length).  Anything else gets
    unpadded urlsafe-base64 of the full key.  Both mappings are
    injective, so distinct keys can no longer collide on one file (the
    old replace('/','_').replace(':','_') folded `a/b` and `a:b` into
    the same entry, silently cross-contaminating results).
    """
    algo, sep, digest = key.partition(":")
    if sep and algo == "sha256" and len(digest) == 64 and set(digest) <= _HEX:
        return digest
    return base64.urlsafe_b64encode(key.encode("utf-8")).decode("ascii").rstrip("=")


def _legacy_safe_key(key: str) -> str:
    """Pre-collision-fix filename; kept for migration-free fallback reads
    of entries written by older processes."""
    return key.replace("/", "_").replace(":", "_")


class FSCache(ArtifactCache):
    """JSON-on-disk content-addressed cache (the BoltDB fscache analogue)."""

    def __init__(self, cache_dir: str):
        self.root = os.path.join(cache_dir, "fanal")
        os.makedirs(os.path.join(self.root, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "blob"), exist_ok=True)

    def _path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, bucket, _safe_key(key) + ".json")

    def _legacy_path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, bucket, _legacy_safe_key(key) + ".json")

    def _write(self, bucket: str, key: str, value: dict) -> None:
        path = self._path(bucket, key)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(value, f)
        os.replace(tmp, path)

    def _evict(self, path: str, reason: str) -> None:
        """Self-heal: a corrupt/stale entry left on disk is a permanent
        re-miss (and, for stale schemas, a poisoned exists() probe) —
        delete on detection and account for it."""
        try:
            os.remove(path)
        except OSError:
            return
        cache_stats.record_eviction(reason)

    def _read(self, bucket: str, key: str) -> dict | None:
        path = self._path(bucket, key)
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except json.JSONDecodeError:
            self._evict(path, "corrupt")
            return None
        except OSError:
            pass
        # Migration-free fallback: entries written before the injective
        # _safe_key fix live under the old flattened name.
        legacy = self._legacy_path(bucket, key)
        if legacy == path:
            return None
        try:
            with open(legacy, encoding="utf-8") as f:
                return json.load(f)
        except json.JSONDecodeError:
            self._evict(legacy, "corrupt")
            return None
        except OSError:
            return None

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self._write("artifact", artifact_id, info.to_json())

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self._write("blob", blob_id, info.to_json())

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        d = self._read("artifact", artifact_id)
        return ArtifactInfo.from_json(d) if d is not None else None

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        d = self._read("blob", blob_id)
        if d is None:
            return None
        info = BlobInfo.from_json(d)
        # Schema-version gating like cache.go: stale schema = cache miss,
        # and the dead file is reaped so exists() stops vouching for it.
        if info.schema_version != BLOB_JSON_SCHEMA_VERSION:
            for path in (self._path("blob", blob_id),
                         self._legacy_path("blob", blob_id)):
                if os.path.exists(path):
                    self._evict(path, "stale-schema")
                    break
            return None
        return info

    def exists(self, blob_id: str) -> bool:
        """O(1) presence probe: stat instead of a full JSON read.  A
        corrupt or stale-schema file can answer True until its first
        get_blob self-heals it off disk — the same window the reference
        BoltDB cache has."""
        return os.path.exists(self._path("blob", blob_id)) or os.path.exists(
            self._legacy_path("blob", blob_id)
        )

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        for b in blob_ids:
            for path in (self._path("blob", b), self._legacy_path("blob", b)):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def clear(self) -> None:
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(os.path.join(self.root, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "blob"), exist_ok=True)
