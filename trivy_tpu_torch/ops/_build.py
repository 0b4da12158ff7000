"""Build and load the port's CUDA sources (`trivy_tpu_torch/csrc/*.cu`).

Each source compiles with `nvcc` into a shared library with a plain C
interface under `trivy_tpu_torch/_build/` (listed in `.gitignore`), at first
use, and loads through `ctypes`.  The library's file name carries a digest of
the source, every header in `csrc/` (`*.cuh`, which sources share) and the
flags, so an edited source or header never loads a stale build.
Nothing here runs at import time; a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin); the "
            "CUDA kernels need the CUDA toolkit"
        )
    return found


def _library_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def _start_build(name: str) -> tuple[Path, Path, subprocess.Popen | None]:
    """(library, temporary output, running nvcc or None when built)."""
    lib = _library_path(name)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if lib.exists():
        return lib, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return lib, tmp, proc


def _finish_build(
    name: str, lib: Path, tmp: Path, proc: subprocess.Popen | None
) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all of `csrc/`), one `nvcc`
    process per source, all started together; returns name -> library."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    started = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
