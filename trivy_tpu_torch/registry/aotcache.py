"""Executable cache for the libraries the port builds: build once, verify
every load.

The twin of `trivy_tpu/registry/aotcache.py` for what the port compiles:
the CUDA kernels (`csrc/*.cu`, nvcc, `ops/_build.py`) and the native host
library (`native/*.cpp`, g++, `native/loader.py`), each a shared library
loaded through `ctypes`.  A library is keyed by everything that changes
its binary:

    (platform, kind, compiler version, target, digest of the source, every
     header it can include and the flags)

with the target `sm_90a` for nvcc and a digest of the host CPU's feature
flags for g++ (`-march=native`).  The key leaves out the ruleset digest and
the shapes, where the reference's holds them: the port's kernels take their
rule tables and shapes as launch arguments, so one library serves every
ruleset.

Validation is never-trust: the manifest beside each library (`lib*.json`)
records the key fields, the library's `sha256` and `nbytes`, and the
compiler's output; a library is handed to `ctypes` only after the manifest
matches the request exactly and the bytes match the manifest.  Any
mismatch, missing file or unreadable manifest counts a reject and rebuilds
from the repo's source.  The payload lands before the manifest that makes
it visible, both through `os.replace`.

Deliberate difference: the reference's `get_or_compile` returns None when
the compile fails and its caller keeps a jitted path.  The port has no such
path, so a failed build raises.  A cache directory that cannot be written
costs a rebuild at the next start (the build goes to a temporary
directory), never a scan.

The cache directory is the caller's `cache_dir`, else `TRIVY_TPU_AOT_CACHE`,
else `trivy_tpu_torch/_build/`.  `stats()` counts compiles, hits, misses and
rejects for the process; a warm start shows `compiles == 0`.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import tempfile
import threading
from collections.abc import Callable
from pathlib import Path

_SCHEMA = 1
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"
KEY_FIELDS = ("schema", "platform", "kind", "compiler", "target", "digest")

_lock = threading.Lock()
_STATS = {"compiles": 0, "hits": 0, "misses": 0, "rejects": 0}  # owner: _lock


def stats() -> dict:
    with _lock:
        return dict(_STATS)


def reset_stats() -> None:
    with _lock:
        for k in _STATS:
            _STATS[k] = 0


def _count(what: str) -> None:
    with _lock:
        _STATS[what] += 1


def cache_dir(path: str | os.PathLike | None = None) -> Path:
    """`path`, else `TRIVY_TPU_AOT_CACHE`, else `trivy_tpu_torch/_build/`."""
    return Path(path or os.environ.get("TRIVY_TPU_AOT_CACHE") or DEFAULT_DIR)


def make_key(*, kind: str, compiler: str, target: str, digest: str) -> dict:
    """The full key of one library: what `load_executable` holds the
    manifest to."""
    return {
        "schema": _SCHEMA,
        "platform": f"{platform.system()}-{platform.machine()}",
        "kind": kind,
        "compiler": compiler,
        "target": target,
        "digest": digest,
    }


def manifest_path(lib: Path) -> Path:
    return lib.with_suffix(".json")


def _sha256(path: Path) -> tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def load_executable(lib: Path, key: dict) -> Path | None:
    """`lib` when its manifest matches `key` field by field and its bytes
    match the manifest (a hit); None when either file is missing (a miss)
    or anything disagrees (a reject)."""
    man = manifest_path(lib)
    if not (lib.exists() and man.exists()):
        _count("misses")
        return None
    try:
        manifest = json.loads(man.read_text())
        ok = all(manifest.get(k) == key[k] for k in KEY_FIELDS)
        ok = ok and _sha256(lib) == (manifest.get("sha256"), manifest.get("nbytes"))
    except (OSError, ValueError, AttributeError):
        ok = False
    _count("hits" if ok else "rejects")
    return lib if ok else None


def build_log(lib: Path) -> str:
    """The compiler's output recorded with `lib` (empty when none)."""
    return json.loads(manifest_path(lib).read_text()).get("log", "")


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def save_executable(lib: Path, key: dict, built: Path, log: str = "") -> Path:
    """Move the library `built` to `lib`, then write its manifest (the
    payload first, so a reader never sees a manifest without its bytes)."""
    sha, nbytes = _sha256(built)
    os.replace(built, lib)
    manifest = dict(key, sha256=sha, nbytes=nbytes, log=log)
    _write_atomic(manifest_path(lib), json.dumps(manifest, indent=1, sort_keys=True).encode())
    return lib


def _writable(directory: Path) -> bool:
    try:
        directory.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    return os.access(directory, os.W_OK)


# A build: called with the output path, it starts the compiler and returns
# a function that waits for it and returns its output (raising on failure).
Build = Callable[[Path], Callable[[], str]]


def get_or_compile_many(requests: dict[str, tuple[Path, dict, Build]]) -> dict[str, Path]:
    """name -> (library path, key, build) for each library; returns name ->
    a verified or freshly built library path.  Every missing or rejected
    library's build starts before any is waited for, so the compilers run
    in parallel; a failed build raises after all have ended."""
    out: dict[str, Path] = {}
    started: dict[str, tuple[Path, dict, Path, bool, Callable[[], str]]] = {}
    for name, (lib, key, build) in requests.items():
        found = load_executable(lib, key)
        if found is not None:
            out[name] = found
            continue
        _count("compiles")
        cacheable = _writable(lib.parent)
        where = lib.parent if cacheable else Path(tempfile.mkdtemp(prefix="trivy-tpu-torch-"))
        tmp = where / f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        started[name] = (lib, key, tmp, cacheable, build(tmp))
    errors = []
    for name, (lib, key, tmp, cacheable, wait) in started.items():
        try:
            log = wait()
        except RuntimeError as exc:  # every compiler is waited for before raising
            tmp.unlink(missing_ok=True)
            errors.append(exc)
            continue
        if not cacheable:
            out[name] = tmp
            continue
        try:
            out[name] = save_executable(lib, key, tmp, log)
        except OSError:  # the cache lost its write access: keep this build
            out[name] = tmp if tmp.exists() else lib
    if errors:
        raise errors[0]
    return out


def get_or_compile(lib: Path, key: dict, build: Build) -> Path:
    """One library: verified from the cache, else built (`build`) and
    stored for the next start."""
    return get_or_compile_many({lib.name: (lib, key, build)})[lib.name]
