"""Build and load the port's CUDA sources (`trivy_tpu_torch/csrc/*.cu`).

Each source compiles with `nvcc` into a shared library with a plain C
interface, at first use, and loads through `ctypes`.  Every build and load
goes through the executable cache (`registry/aotcache.py`): the library
lives in the cache directory (`TRIVY_TPU_AOT_CACHE`, else
`trivy_tpu_torch/_build/`, listed in `.gitignore`) beside a manifest of its
key (platform, `nvcc --version`, the target `sm_90a`, the digest below),
its sha256 and what `ptxas -v` said of each kernel (registers, shared
memory, spills; read back by `resources`), and it loads only when all of
that matches.  The library's file name carries a digest of the source,
every header in `csrc/` (`*.cuh`, which sources share) and the flags, so an
edited source or header never loads a stale build.
Nothing here runs at import time; a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from trivy_tpu_torch.registry import aotcache

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = aotcache.DEFAULT_DIR
TARGET = "sm_90a"
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


def _source_digest(name: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _library_path(name: str, cache_dir: str | os.PathLike | None = None) -> Path:
    return aotcache.cache_dir(cache_dir) / f"lib{name}-{_source_digest(name)}.so"


@functools.cache
def nvcc_version() -> str:
    """`nvcc --version`, the compiler field of every library's key."""
    proc = subprocess.run([nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc --version failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout.strip()


def _key(name: str) -> dict:
    return aotcache.make_key(kind="nvcc", compiler=nvcc_version(), target=TARGET,
                             digest=_source_digest(name))


def _nvcc_build(name: str):
    """An `aotcache.Build` for `csrc/<name>.cu`: starts nvcc on the output
    path, and its wait returns the compiler's output (the ptxas report)."""
    def start(out: Path):
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def wait() -> str:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
            return text

        return wait

    return start


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def resources(name: str) -> list[dict]:
    """Per kernel of the built `csrc/<name>.cu`, what `ptxas -v` reported:
    {"kernel" (mangled name), "registers", "smem_bytes" (static; the
    kernels' tables are dynamic shared memory, sized at launch),
    "spill_bytes" (stores + loads)}.  Builds the source when needed."""
    text = aotcache.build_log(build_all([name])[name])
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


def build_all(names: list[str] | None = None,
              cache_dir: str | os.PathLike | None = None) -> dict[str, Path]:
    """Every named source (default: all of `csrc/`) from the executable
    cache, built where missing or rejected, one `nvcc` process per source,
    all started together; returns name -> library."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    return aotcache.get_or_compile_many(
        {n: (_library_path(n, cache_dir), _key(n), _nvcc_build(n)) for n in names})


def load_all(names: list[str],
             cache_dir: str | os.PathLike | None = None) -> dict[str, ctypes.CDLL]:
    """The loaded libraries for `csrc/<name>.cu` of each name, from the
    executable cache (`cache_dir`, else the default one), the missing ones
    built together.  One library a source a process: a name already loaded
    keeps the library loaded first."""
    missing = [n for n in names if n not in _LOADED]
    if missing:
        for n, path in build_all(missing, cache_dir).items():
            _LOADED[n] = ctypes.CDLL(str(path))
    return {n: _LOADED[n] for n in names}


def load(name: str, cache_dir: str | os.PathLike | None = None) -> ctypes.CDLL:
    """`load_all` of one source."""
    return load_all([name], cache_dir)[name]


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
