"""Git repository artifact.

Mirrors pkg/fanal/artifact/repo/git.go: resolve the target (local working
tree, or clone a remote URL to a temp dir with --branch/--tag/--commit), then
delegate to the local filesystem artifact.

Copied from `trivy_tpu/artifact/repo.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from trivy_tpu_torch.analyzer.core import AnalyzerOptions
from trivy_tpu_torch.artifact.local import LocalArtifact
from trivy_tpu_torch.atypes import ArtifactReference
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import ArtifactType
from trivy_tpu_torch.walker.fs import WalkOption


class RepositoryArtifact:
    """artifact/repo/git.go Artifact."""

    def __init__(
        self,
        target: str,
        cache: ArtifactCache,
        analyzer_options: AnalyzerOptions | None = None,
        walk_option: WalkOption | None = None,
        branch: str = "",
        tag: str = "",
        commit: str = "",
    ):
        self.target = target
        self.branch = branch
        self.tag = tag
        self.commit = commit
        self._tmpdir: str | None = None

        root = self._resolve()
        self._local = LocalArtifact(
            root,
            cache,
            analyzer_options=analyzer_options,
            walk_option=walk_option,
            artifact_type=ArtifactType.REPOSITORY,
        )

    def _resolve(self) -> str:
        if os.path.isdir(self.target):
            return self.target
        # Remote URL: shallow clone like git.go newURL/cloneOptions.
        self._tmpdir = tempfile.mkdtemp(prefix="trivy-tpu-repo-")
        cmd = ["git", "clone", "--depth", "1"]
        if self.branch:
            cmd += ["--branch", self.branch]
        elif self.tag:
            cmd += ["--branch", self.tag]
        cmd += [self.target, self._tmpdir]
        subprocess.run(cmd, check=True, capture_output=True)
        if self.commit:
            subprocess.run(
                ["git", "-C", self._tmpdir, "fetch", "--depth", "1", "origin", self.commit],
                check=True,
                capture_output=True,
            )
            subprocess.run(
                ["git", "-C", self._tmpdir, "checkout", self.commit],
                check=True,
                capture_output=True,
            )
        return self._tmpdir

    def inspect(self) -> ArtifactReference:
        ref = self._local.inspect()
        ref.name = self.target
        ref.artifact_type = ArtifactType.REPOSITORY.value
        return ref

    def clean(self, ref: ArtifactReference) -> None:
        self._local.clean(ref)
        if self._tmpdir:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
