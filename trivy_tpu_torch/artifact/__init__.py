"""Artifacts (a copy of `trivy_tpu/artifact/`: local filesystem and git
repository; image, sbom and vm wait for ROADMAP A13d)."""

from trivy_tpu_torch.artifact.local import LocalArtifact

__all__ = ["LocalArtifact"]
