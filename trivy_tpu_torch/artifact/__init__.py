"""Artifacts (a copy of `trivy_tpu/artifact/`): the local filesystem here,
the git repository, the container image and the SBOM in their modules;
vm waits for ROADMAP A13d.2."""

from trivy_tpu_torch.artifact.local import LocalArtifact

__all__ = ["LocalArtifact"]
