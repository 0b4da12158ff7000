"""In-memory virtual filesystem for post-analyzers (pkg/mapfs/fs.go).

During the artifact walk, files a post-analyzer claims are copied in here;
after the walk the post-analyzer sees them as one coherent tree and can
resolve cross-file context (a lockfile next to its manifest, node_modules
metadata, pom parent chains) that per-file analysis cannot.

Copied from `trivy_tpu/mapfs.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import fnmatch
import posixpath


class MapFS:
    def __init__(self) -> None:
        self._files: dict[str, bytes] = {}

    def write_file(self, path: str, content: bytes) -> None:
        self._files[path.lstrip("/")] = content

    def exists(self, path: str) -> bool:
        return path.lstrip("/") in self._files

    def read(self, path: str) -> bytes:
        return self._files[path.lstrip("/")]

    def paths(self) -> list[str]:
        return sorted(self._files)

    def glob(self, pattern: str) -> list[str]:
        return sorted(p for p in self._files if fnmatch.fnmatch(p, pattern))

    def dir_of(self, path: str) -> str:
        return posixpath.dirname(path.lstrip("/"))

    def siblings(self, path: str, name: str) -> str | None:
        """Path of `name` in the same directory as `path`, if present."""
        cand = posixpath.join(self.dir_of(path), name)
        return cand if cand in self._files else None

    def __len__(self) -> int:
        return len(self._files)
