"""Walkers (a copy of `trivy_tpu/walker/`): the filesystem walker here,
the image layers' tar walker in `walker/layer_tar.py`."""

from trivy_tpu_torch.walker.fs import FSWalker, WalkOption, skip_path

__all__ = ["FSWalker", "WalkOption", "skip_path"]
