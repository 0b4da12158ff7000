"""Native library build + ctypes bindings: the DFA claim-killer, the
hybrid engine's host pre-sieve, the device verify's span assembly and the
license classifier's fingerprints.

A port of `trivy_tpu/native/loader.py` reduced to what the engines run:
`dfa_verify.cpp`, `gram_scan.cpp`, `lane_index.cpp`, `span_assemble.cpp`
and `license_fingerprint.cpp` (this directory) build with `g++` into
one shared library through the executable cache (`registry/aotcache.py`:
`TRIVY_TPU_AOT_CACHE`, else `trivy_tpu_torch/_build/`, listed in
`.gitignore`).  Its file name carries a digest of the sources and the
flags, so an edited source never loads a stale build; its manifest pins
`g++ --version` and a digest of the host CPU's feature flags
(`-march=native` code must not load on another CPU that shares the
directory) beside the library's sha256, and it loads through ctypes only
when all of that matches.  Bound:
`dfa_verify_pairs`, `dfa_verify_pairs_files`, `gram_sieve_scan_files`, the
row sieve `gram_sieve` (`gram_sieve_native`), the fused K5's lane index
`lane_index` (`ops/nfa_verify.LaneIndex.build`), the device verify's span
assembly `span_place`/`span_copy` (`engine/nfa_device.assemble_spans`) and
the license fingerprints `license_fingerprint`, with `license_crc32`, its
hash (`license/classifier.fingerprints`).

Unlike the reference, a failed build raises with the compiler's output
instead of returning None: the reference's None makes its engine skip the
claim-killer without a word (and its `gram_sieve_native` fall back to numpy),
and the port would rather fail than hide a missing step.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.registry import aotcache

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = ("dfa_verify.cpp", "gram_scan.cpp", "lane_index.cpp", "span_assemble.cpp",
           "license_fingerprint.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = lockcheck.make_lock("native.loader")
_lib: ctypes.CDLL | None = None  # owner: _lock

# Both entry points share the rule-table argument tail of
# DfaVerifier._table_args (17 pointers) and end with the verdict buffer.
_TABLE_ARGS = [ctypes.c_void_p] * 17
_PAIR_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # pair_file, pair_rule
    ctypes.c_void_p, ctypes.c_void_p,  # hints first/last
    ctypes.c_int64,                    # npairs
]


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def _cpu_key() -> bytes:
    """The host CPU's feature flags (Linux), else its machine name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


@functools.cache
def gxx_version() -> str:
    """The first line of `g++ --version`, the compiler field of the key."""
    try:
        proc = _run(["g++", "--version"])
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"g++ --version failed: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ --version failed:\n{proc.stderr}")
    return proc.stdout.splitlines()[0].strip()


def _key() -> tuple[str, dict]:
    """(digest of the sources, the flags and the host CPU's feature flags,
    which names the library; the executable cache's key of it)."""
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((NATIVE_DIR / s).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    digest = h.hexdigest()[:16]
    target = "cpu-" + hashlib.sha256(_cpu_key()).hexdigest()[:16]
    return digest, aotcache.make_key(kind="g++", compiler=gxx_version(), target=target,
                                     digest=digest)


def _gxx_build(out: Path):
    """An `aotcache.Build`: compiles the sources to `out` with
    `-march=native`, else without it, and raises with g++'s output when
    neither succeeds."""
    cmd = ["g++", *CXX_FLAGS, "-o", str(out), *(str(NATIVE_DIR / s) for s in SOURCES)]
    errors = []
    for attempt in (cmd, [c for c in cmd if c != "-march=native"]):
        try:
            proc = _run(attempt)
        except (OSError, subprocess.SubprocessError) as exc:
            errors.append(f"$ {' '.join(attempt)}\n{exc}")
            continue
        if proc.returncode == 0:
            return lambda: proc.stderr
        errors.append(f"$ {' '.join(attempt)}\n{proc.stderr}")
    out.unlink(missing_ok=True)
    raise RuntimeError(
        f"the native library (trivy_tpu_torch/native/: {', '.join(SOURCES)}) "
        "did not build:\n" + "\n".join(errors)
    )


def build(cache_dir: str | os.PathLike | None = None) -> Path:
    """The library's path in the executable cache (`cache_dir`, else the
    default one), built when missing or rejected; raises RuntimeError with
    g++'s output when neither the native nor the portable (no
    `-march=native`) build succeeds."""
    digest, key = _key()
    lib = aotcache.cache_dir(cache_dir) / f"libtrivytorch-native-{digest}.so"
    return aotcache.get_or_compile(lib, key, _gxx_build)


def load_native(cache_dir: str | os.PathLike | None = None) -> ctypes.CDLL:
    """The loaded native library, from the executable cache (`cache_dir`,
    else the default one), built on first use (raises when it does not
    build).  One library a process: a later call returns the first."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build(cache_dir)))
        lib.dfa_verify_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # stream, starts, lens
            *_PAIR_ARGS, *_TABLE_ARGS,
            ctypes.c_void_p,                                    # out_verified
        ]
        lib.dfa_verify_pairs.restype = None
        lib.dfa_verify_pairs_files.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,                   # file_ptrs, lens
            *_PAIR_ARGS, *_TABLE_ARGS,
            ctypes.c_void_p,                                    # out_verified
        ]
        lib.dfa_verify_pairs_files.restype = None
        lib.gram_sieve_scan_files.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # ptrs, lens, F
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # grams
            ctypes.c_void_p, ctypes.c_int32,                   # gram_window, W
            ctypes.c_void_p,                                   # window_probe
            ctypes.c_void_p, ctypes.c_int32,                   # probe_n_windows, P
            ctypes.c_void_p, ctypes.c_void_p,                  # gate CSR
            ctypes.c_void_p, ctypes.c_void_p,                  # conj CSR ptrs
            ctypes.c_void_p, ctypes.c_int32,                   # conj_probes, R
            ctypes.c_void_p, ctypes.c_void_p,                  # cls_blob, cls_start
            ctypes.c_void_p, ctypes.c_void_p,                  # cls_len, cls_align
            ctypes.c_void_p,                                   # out_starts
            ctypes.c_void_p, ctypes.c_int64,                   # out_pairs, cap
        ]
        lib.gram_sieve_scan_files.restype = ctypes.c_int64
        lib.gram_sieve.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # rows, T, L
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # masks, vals, G
            ctypes.c_void_p,                                   # out
        ]
        lib.gram_sieve.restype = None
        lib.lane_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,                   # table [4, N], N
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,    # n_rows, n_blocks, width
            ctypes.c_void_p,                                   # out
        ]
        lib.lane_index.restype = ctypes.c_int64
        lib.span_place.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,                  # file ptrs, lens
            ctypes.c_void_p, ctypes.c_void_p,                  # lane file, slot
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # lane start, stop, n
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,   # tiers, n_tiers, block
            ctypes.c_void_p, ctypes.c_void_p,                  # out tier, row
            ctypes.c_void_p, ctypes.c_void_p,                  # out b0, b1
            ctypes.c_void_p,                                   # out overflow
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out span file, src, len
            ctypes.c_void_p, ctypes.c_void_p,                  # out span tier, dst
            ctypes.c_void_p, ctypes.c_void_p,                  # out rows, counts
        ]
        lib.span_place.restype = None
        lib.span_copy.argtypes = [
            ctypes.c_void_p,                                   # file ptrs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # span file, src, len
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # span tier, dst, n
            ctypes.c_void_p,                                   # tier row arrays
        ]
        lib.span_copy.restype = None
        lib.license_fingerprint.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,  # texts, offsets, F
            ctypes.c_void_p,                                   # out [F, DIM]
        ]
        lib.license_fingerprint.restype = None
        lib.license_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.license_crc32.restype = ctypes.c_uint32
        _lib = lib
    return _lib


def gram_sieve_native(rows: np.ndarray, masks: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """[T, L] uint8 rows -> [T, G] bool hits (the twin of the reference
    loader's; masks sorted so equal masks are contiguous, as the gram set
    sorts them).  Raises when the library does not build, where the
    reference returns None and falls back to numpy."""
    lib = load_native()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    masks = np.ascontiguousarray(masks, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    t, length = rows.shape
    g = len(masks)
    out = np.zeros((t, g), dtype=np.uint8)
    lib.gram_sieve(
        rows.ctypes.data, t, length,
        masks.ctypes.data, vals.ctypes.data, g,
        out.ctypes.data,
    )
    return out.astype(bool)
