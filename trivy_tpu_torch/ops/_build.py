"""Build and load the port's CUDA sources (`trivy_tpu_torch/csrc/*.cu`).

Each source compiles with `nvcc` into a shared library with a plain C
interface under `trivy_tpu_torch/_build/` (listed in `.gitignore`), at first
use, and loads through `ctypes`.  The library's file name carries a digest of
the source, every header in `csrc/` (`*.cuh`, which sources share) and the
flags, so an edited source or header never loads a stale build.  What
`ptxas -v` says of each kernel (registers, shared memory, spills) is kept
beside the library and read back by `resources`.
Nothing here runs at import time; a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[tuple[str, str], object] = {}
_ARG_KINDS = {"p": ctypes.c_void_p, "i": ctypes.c_int}


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
    _log_path(lib).write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def resources(name: str) -> list[dict]:
    """Per kernel of the built `csrc/<name>.cu`, what `ptxas -v` reported:
    {"kernel" (mangled name), "registers", "smem_bytes" (static; the
    kernels' tables are dynamic shared memory, sized at launch),
    "spill_bytes" (stores + loads)}.  Builds the source when needed."""
    text = _log_path(build_all([name])[name]).read_text()
    out: list[dict] = []
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            out.append({"kernel": m.group(1), "registers": 0, "smem_bytes": 0,
                        "spill_bytes": 0})
        elif out and (m := _SPILLS.search(line)):
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif out and (m := _USED.search(line)):
            out[-1]["registers"] = int(m.group(1))
            if sm := _SMEM.search(line):
                out[-1]["smem_bytes"] = int(sm.group(1))
    return out


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


def function(name: str, symbol: str, signature: str):
    """The C function `symbol` of `csrc/<name>.cu`, returning int, its
    arguments typed once from `signature` (one letter each: p = pointer,
    i = int)."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [_ARG_KINDS[c] for c in signature]
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn
