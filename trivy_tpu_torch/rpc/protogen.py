"""protoc-backed generation of the Twirp wire bindings.

The .proto sources in rpc/proto/ are the wire contract (see their header
notes); this module compiles them once per source-hash into the user cache
dir with the system protoc and imports the generated modules.  Absent
protoc or the google.protobuf runtime, load() returns None and the RPC
layer stays JSON-only (the Twirp spec's other wire format).

Copied from `trivy_tpu/rpc/protogen.py`; the port imports nothing from the
JAX package.  The port's `.proto` files are byte-identical to the
reference's (a test holds them so), and the generated modules keep the
top-level names `common_pb2`, `scanner_pb2` and `cache_pb2`: in a process
that loads both packages, whichever loader runs first registers the one
`common.proto` in protobuf's default pool, and the other imports the same
modules from `sys.modules`.  The port compiles into its own cache
directory (`trivy_tpu_torch/protogen/<hash>` under the user cache dir).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

from trivy_tpu_torch import lockcheck

_PROTO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "proto")
_SOURCES = ["common.proto", "scanner.proto", "cache.proto"]

_lock = lockcheck.make_lock("rpc.protogen")
_mods: dict | None = None  # owner: _lock
_failed = False  # owner: _lock


def _cache_dir(h: str) -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "trivy_tpu_torch",
        "protogen",
        h,
    )


def load() -> dict | None:
    """{"common": common_pb2, "scanner": scanner_pb2, "cache": cache_pb2}
    or None when bindings cannot be built in this environment."""
    global _mods, _failed
    if _mods is not None or _failed:
        return _mods
    with _lock:
        if _mods is not None or _failed:
            return _mods
        try:
            import google.protobuf  # noqa: F401
        except ImportError:
            _failed = True
            return None
        h = hashlib.sha256()
        for s in _SOURCES:
            with open(os.path.join(_PROTO_DIR, s), "rb") as f:
                h.update(f.read())
        out = _cache_dir(h.hexdigest()[:16])
        marker = os.path.join(out, "common_pb2.py")
        if not os.path.exists(marker):
            os.makedirs(out, exist_ok=True)
            try:
                subprocess.run(
                    ["protoc", f"-I{_PROTO_DIR}", f"--python_out={out}"]
                    + _SOURCES,
                    check=True,
                    capture_output=True,
                    timeout=60,
                )
            except (OSError, subprocess.SubprocessError):
                _failed = True
                return None
        if out not in sys.path:
            sys.path.insert(0, out)
        try:
            import cache_pb2
            import common_pb2
            import scanner_pb2
        except Exception:
            _failed = True
            return None
        _mods = {
            "common": common_pb2,
            "scanner": scanner_pb2,
            "cache": cache_pb2,
        }
        return _mods
