"""Local filesystem artifact.

Mirrors pkg/fanal/artifact/local/fs.go: walk the target directory, run the
analyzer group (batched here — the device engine sees the whole walk as one
batch), store the single resulting blob in the cache keyed by
sha256(blob JSON + analyzer versions) (fs.go:174-188), and return an
ArtifactReference whose blob ID the applier later resolves.  The port adds
host spans (`artifact.post`, `cache.put`) for the runner's stage split.

Copied from `trivy_tpu/artifact/local.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import hashlib
import json
import os

from trivy_tpu_torch.analyzer.core import AnalyzerGroup, AnalyzerOptions
from trivy_tpu_torch.atypes import ArtifactInfo, ArtifactReference, BlobInfo, OS
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import ArtifactType
from trivy_tpu_torch.walker.fs import FSWalker, WalkOption


class LocalArtifact:
    """artifact/local/fs.go Artifact."""

    def __init__(
        self,
        root: str,
        cache: ArtifactCache,
        analyzer_options: AnalyzerOptions | None = None,
        walk_option: WalkOption | None = None,
        artifact_type: ArtifactType = ArtifactType.FILESYSTEM,
    ):
        self.root = root
        self.cache = cache
        self.group = AnalyzerGroup(analyzer_options)
        self.walker = FSWalker(walk_option)
        self.artifact_type = artifact_type

    def inspect(self) -> ArtifactReference:
        """fs.go:71 Inspect."""
        from trivy_tpu_torch.handler import run_post_handlers
        from trivy_tpu_torch.obs import trace as obs_trace

        result = self.group.analyze_entries(self.root, self.walker.walk(self.root))
        with obs_trace.span("artifact.post"):
            # Post-analyzers see their composite FS after the walk (fs.go:120
            # PostAnalyze): cross-file context like lockfile + manifest pairs.
            result.merge(self.group.post_analyze())
            run_post_handlers(result)
            result.sort()

        blob = BlobInfo(
            os=result.os if isinstance(result.os, OS) else None,
            package_infos=list(result.package_infos),
            applications=list(result.applications),
            secrets=list(result.secrets),
            licenses=list(result.licenses),
            misconfigurations=list(result.misconfigs),
            custom_resources=list(result.configs),
            build_info=result.build_info,
        )
        with obs_trace.span("cache.put"):
            blob_id = self._calc_cache_key(blob)
            self.cache.put_blob(blob_id, blob)

        name = self.root
        if self.artifact_type == ArtifactType.FILESYSTEM:
            name = os.path.abspath(self.root) if self.root == "." else self.root

        return ArtifactReference(
            name=name,
            artifact_type=self.artifact_type.value,
            id=blob_id,
            blob_ids=[blob_id],
        )

    def _calc_cache_key(self, blob: BlobInfo) -> str:
        """fs.go:174-188 calcCacheKey: hash of blob JSON + analyzer versions."""
        h = hashlib.sha256()
        h.update(json.dumps(blob.to_json(), sort_keys=True).encode())
        h.update(
            json.dumps(self.group.analyzer_versions(), sort_keys=True).encode()
        )
        return "sha256:" + h.hexdigest()

    def clean(self, ref: ArtifactReference) -> None:
        self.cache.delete_blobs(ref.blob_ids)
