"""Filesystem walker (a copy of `trivy_tpu/walker/`; the layer-tar walker
waits for the image path, ROADMAP A13d)."""

from trivy_tpu_torch.walker.fs import FSWalker, WalkOption, skip_path

__all__ = ["FSWalker", "WalkOption", "skip_path"]
