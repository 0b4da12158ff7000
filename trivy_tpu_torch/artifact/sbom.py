"""SBOM artifact: decode CycloneDX/SPDX and re-scan the listed packages.

Mirrors pkg/fanal/artifact/sbom/sbom.go + pkg/sbom/sbom.go Decode: format
sniffing, decode to an ArtifactDetail-shaped blob, straight to detectors (no
file walk).

Copied from `trivy_tpu/artifact/sbom.py`; the port imports nothing from
the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import hashlib
import json

from trivy_tpu_torch.atypes import ArtifactReference, BlobInfo, PackageInfo
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import ArtifactType


def build_sbom_reference(
    detail, raw: bytes, cache, name: str, artifact_type: "ArtifactType"
) -> "ArtifactReference":
    """Decoded SBOM detail -> cached blob + artifact reference; the single
    decode-to-reference tail shared by the sbom artifact and the image
    remote-SBOM short-circuit."""
    blob = BlobInfo(
        os=detail.os,
        package_infos=(
            [PackageInfo(file_path="", packages=detail.packages)]
            if detail.packages
            else []
        ),
        applications=list(detail.applications),
    )
    blob_id = "sha256:" + hashlib.sha256(raw).hexdigest()
    cache.put_blob(blob_id, blob)
    return ArtifactReference(
        name=name,
        artifact_type=artifact_type.value,
        id=blob_id,
        blob_ids=[blob_id],
    )


class SbomArtifact:
    """artifact/sbom/sbom.go Artifact."""

    def __init__(self, target: str, cache: ArtifactCache, **_ignored):
        self.target = target
        self.cache = cache

    def inspect(self) -> ArtifactReference:
        from trivy_tpu_torch.sbom import decode_sbom

        with open(self.target, encoding="utf-8") as f:
            raw = f.read()
        detail, fmt = decode_sbom(raw)
        artifact_type = (
            ArtifactType.CYCLONEDX if fmt == "cyclonedx" else ArtifactType.SPDX
        )
        return build_sbom_reference(
            detail, raw.encode(), self.cache, self.target, artifact_type
        )

    def clean(self, ref: ArtifactReference) -> None:
        self.cache.delete_blobs(ref.blob_ids)
