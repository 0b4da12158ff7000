"""Stdlib back-compat shims for the oldest supported interpreter.

``tomllib`` landed in Python 3.11; on 3.10 the API-compatible ``tomli``
wheel (already in the image for other tooling) stands in.  Import the
module object from here so every TOML-reading site degrades identically
instead of each carrying its own try/except.

Copied from `trivy_tpu/compat.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:  # Python 3.10
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ImportError:  # pragma: no cover - neither parser present
        tomllib = None  # type: ignore[assignment]

__all__ = ["tomllib"]
