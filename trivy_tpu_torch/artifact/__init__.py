"""Artifacts (a copy of `trivy_tpu/artifact/`): the local filesystem here,
the git repository, the container image, the SBOM and the VM disk in their
modules."""

from trivy_tpu_torch.artifact.local import LocalArtifact

__all__ = ["LocalArtifact"]
