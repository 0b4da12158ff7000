"""Generic OCI-artifact downloader (pkg/oci/artifact.go:60,103 analogue).

Databases, check bundles, and the Java index are distributed as OCI
artifacts: an image manifest whose layers carry artifact-specific media
types.  This module pulls such an artifact's matching layer blob through
the same Distribution client the image sources use (trivy_tpu_torch/image/
registry.py) — one auth/transport stack for images and artifacts alike.

Copied from `trivy_tpu/oci.py`; the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from trivy_tpu_torch.image.registry import RegistryClient, RegistryError, parse_reference

__all__ = ["OciArtifact", "RegistryError"]


class OciArtifact:
    """One remote OCI artifact (e.g. ghcr.io/aquasecurity/trivy-db:2)."""

    def __init__(self, ref: str, insecure: bool = False):
        self.ref = ref
        self.client = RegistryClient(insecure=insecure)

    def download_layer(self, media_type: str):
        """Fetch the first layer whose mediaType matches; returns an open
        spooled temp file (caller closes).  pkg/oci/artifact.go:103 Download
        with its media-type filter."""
        ref = parse_reference(self.ref)
        manifest, _ = self.client.get_manifest(ref)
        for layer in manifest.get("layers", []):
            if layer.get("mediaType") == media_type:
                return self.client.get_blob(ref, layer["digest"])
        raise RegistryError(
            f"oci: no layer with media type {media_type!r} in {self.ref}"
        )
