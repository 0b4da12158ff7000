"""Native library build + ctypes bindings: the DFA claim-killer and the
hybrid engine's host pre-sieve.

A port of `trivy_tpu/native/loader.py` reduced to what the engines run:
`dfa_verify.cpp`, `gram_scan.cpp` and `lane_index.cpp` (this directory)
build with `g++` into
one shared library under `trivy_tpu_torch/_build/` (listed in
`.gitignore`), keyed by a digest of the sources, the flags and the host
CPU's feature flags (`-march=native` code must not load on another CPU that
shares the directory), so an edited source never loads a stale build, and
loads through ctypes.  Bound:
`dfa_verify_pairs`, `dfa_verify_pairs_files`, `gram_sieve_scan_files`, the
row sieve `gram_sieve` (`gram_sieve_native`) and the fused K5's lane index
`lane_index` (`ops/nfa_verify.LaneIndex.build`).

Unlike the reference, a failed build raises with the compiler's output
instead of returning None: the reference's None makes its engine skip the
claim-killer without a word (and its `gram_sieve_native` fall back to numpy),
and the port would rather fail than hide a missing step.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from trivy_tpu_torch import lockcheck

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCES = ("dfa_verify.cpp", "gram_scan.cpp", "lane_index.cpp")
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


def build() -> Path:
    """Compile the sources (once per source digest) and return the library
    path; raises RuntimeError with g++'s output when neither the native nor
    the portable (no `-march=native`) build succeeds."""
    srcs = [NATIVE_DIR / s for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    out = BUILD_DIR / f"libtrivytorch-native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, srcs)]
    errors = []
    for attempt in (cmd, [c for c in cmd if c != "-march=native"]):
        try:
            proc = _run(attempt)
        except (OSError, subprocess.SubprocessError) as exc:
            errors.append(f"$ {' '.join(attempt)}\n{exc}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
            return out
        errors.append(f"$ {' '.join(attempt)}\n{proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError(
        f"the native library (trivy_tpu_torch/native/: {', '.join(SOURCES)}) "
        "did not build:\n" + "\n".join(errors)
    )


def load_native() -> ctypes.CDLL:
    """The loaded native library, built on first use (raises when it does
    not build)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
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
