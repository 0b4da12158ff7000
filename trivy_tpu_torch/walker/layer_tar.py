"""Container layer tar walker.

Mirrors pkg/fanal/walker/tar.go: stream tar entries, collect overlayfs
whiteout markers — `.wh.<name>` deletes a path, `.wh..wh..opq` marks its
directory opaque — and yield regular files for analysis.

Copied from `trivy_tpu/walker/layer_tar.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import os
import tarfile
from dataclasses import dataclass, field
from typing import IO

from trivy_tpu_torch.walker.fs import FileEntry

WHITEOUT_PREFIX = ".wh."
OPAQUE_MARKER = ".wh..wh..opq"


@dataclass
class LayerResult:
    entries: list[FileEntry] = field(default_factory=list)
    opaque_dirs: list[str] = field(default_factory=list)
    whiteout_files: list[str] = field(default_factory=list)


def walk_layer_tar(fileobj: IO[bytes]) -> LayerResult:
    """tar.go:35-103 Walk.

    Openers read lazily through the (seekable) tar, so only files an analyzer
    claims are ever materialized; the caller must keep `fileobj` open until
    analysis of the returned entries finishes.
    """
    result = LayerResult()
    tf = tarfile.open(fileobj=fileobj, mode="r:*")
    for member in tf:
        name = member.name
        if name.startswith("./"):
            name = name[2:]
        dirname, base = os.path.split(name)

        if base == OPAQUE_MARKER:
            result.opaque_dirs.append(dirname)
            continue
        if base.startswith(WHITEOUT_PREFIX):
            result.whiteout_files.append(
                os.path.join(dirname, base[len(WHITEOUT_PREFIX) :])
            )
            continue
        if not member.isreg():
            continue

        def read(m=member) -> bytes:
            f = tf.extractfile(m)
            if f is None:
                raise OSError(f"cannot extract {m.name}")
            with f:
                return f.read()

        result.entries.append(
            FileEntry(
                path=name,
                size=member.size,
                mode=member.mode | 0o100000,
                opener=read,
            )
        )
    return result
