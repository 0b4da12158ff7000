"""Filesystem walker with the reference's skip semantics.

Mirrors pkg/fanal/walker/{walk.go,fs.go}: doublestar-style skip patterns
(``**`` crossing separators), default skip dirs, regular-files-only, tolerated
per-file permission errors, and a file-size threshold.  Unlike the reference's
callback-per-file shape, the walker *yields* entries so the analyzer group can
assemble device-sized batches — the TPU-native replacement for the reference's
goroutine-per-file fan-out (pkg/fanal/analyzer/analyzer.go:396-448).

Copied from `trivy_tpu/walker/fs.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import fnmatch
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterator

DEFAULT_SIZE_THRESHOLD = 100 << 20  # walker/walk.go:15 defaultSizeThreshold

# walker/walk.go:17-22 defaultSkipDirs
DEFAULT_SKIP_DIRS = ["**/.git", "proc", "sys", "dev"]


@dataclass
class WalkOption:
    """walker.Option (walk.go:24-27)."""

    skip_files: list[str] = field(default_factory=list)
    skip_dirs: list[str] = field(default_factory=list)


@dataclass
class FileEntry:
    """One walked file: relative slash path + stat info + lazy opener."""

    path: str  # relative, slash-separated
    size: int
    mode: int
    opener: Callable[[], bytes]


def _doublestar_to_re(pattern: str) -> re.Pattern[str]:
    """Compile a doublestar glob (bmatcuk/doublestar semantics subset) to a regex.

    ``**`` matches any number of path segments (including zero); ``*``/``?``
    never cross ``/``; character classes pass through.
    """
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "*":
            if pattern[i : i + 2] == "**":
                # `**/` -> zero or more segments; trailing `**` -> anything
                if pattern[i : i + 3] == "**/":
                    out.append(r"(?:[^/]+/)*")
                    i += 3
                else:
                    out.append(r".*")
                    i += 2
            else:
                out.append(r"[^/]*")
                i += 1
        elif c == "?":
            out.append(r"[^/]")
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and pattern[j] in "!^":
                j += 1
            if j < n and pattern[j] == "]":
                j += 1
            while j < n and pattern[j] != "]":
                j += 1
            if j < n:
                cls = pattern[i + 1 : j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append("[" + cls + "]")
                i = j + 1
            else:
                out.append(re.escape(c))
                i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("^" + "".join(out) + "$")


def clean_skip_paths(paths: list[str]) -> list[str]:
    """walker.CleanSkipPaths (walk.go:32-37)."""
    return [os.path.normpath(p).replace(os.sep, "/").lstrip("/") for p in paths]


def compile_skip_patterns(patterns: list[str]) -> list[re.Pattern[str]]:
    out = []
    for pattern in patterns:
        try:
            out.append(_doublestar_to_re(pattern))
        except re.error:
            pass  # bad pattern never matches (walk.go:44-46)
    return out


def skip_path(path: str, skip_patterns: list) -> bool:
    """walker.SkipPath (walk.go:39-53); accepts raw globs or precompiled."""
    path = path.lstrip("/")
    if skip_patterns and isinstance(skip_patterns[0], str):
        skip_patterns = compile_skip_patterns(skip_patterns)
    return any(rx.match(path) for rx in skip_patterns)


class FSWalker:
    """walker.FS (fs.go:17)."""

    def __init__(self, option: WalkOption | None = None):
        self.option = option or WalkOption()

    def walk(self, root: str) -> Iterator[FileEntry]:
        skip_files = compile_skip_patterns(clean_skip_paths(self.option.skip_files))
        skip_dirs = compile_skip_patterns(
            clean_skip_paths(self.option.skip_dirs) + DEFAULT_SKIP_DIRS
        )

        root = os.path.abspath(root)
        if os.path.isfile(root):
            # Single-file target behaves like a one-entry walk.
            st = os.stat(root)
            yield FileEntry(
                path=os.path.basename(root),
                size=st.st_size,
                mode=st.st_mode,
                opener=_opener(root),
            )
            return

        for dirpath, dirnames, filenames in os.walk(root, onerror=None):
            rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
            if rel_dir == ".":
                rel_dir = ""

            kept = []
            for d in dirnames:
                rel = f"{rel_dir}/{d}" if rel_dir else d
                if not skip_path(rel, skip_dirs):
                    kept.append(d)
            dirnames[:] = sorted(kept)

            for fname in sorted(filenames):
                rel = f"{rel_dir}/{fname}" if rel_dir else fname
                if skip_path(rel, skip_files):
                    continue
                full = os.path.join(dirpath, fname)
                try:
                    st = os.lstat(full)
                except OSError:
                    continue  # tolerated like fs.go:104-106 permission skips
                import stat as statmod

                if not statmod.S_ISREG(st.st_mode):
                    continue
                if st.st_size > DEFAULT_SIZE_THRESHOLD:
                    continue  # walk.go:15 defaultSizeThreshold
                yield FileEntry(
                    path=rel, size=st.st_size, mode=st.st_mode, opener=_opener(full)
                )


def _opener(full_path: str) -> Callable[[], bytes]:
    def read() -> bytes:
        with open(full_path, "rb") as f:
            return f.read()

    return read
