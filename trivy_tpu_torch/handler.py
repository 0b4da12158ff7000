"""Post-handlers over per-blob analysis results (pkg/fanal/handler).

Handlers run after the per-blob analysis (and post-analyzers) and may
rewrite the result before it is cached.  The registry mirrors
handler.go:19-41; the builtin handler is the system-file filter
(handler/sysfile/filter.go): language packages whose metadata files were
installed by the OS package manager are dropped, because the OS package
(with its own advisories and version) already covers them — keeping both
produces wrong-version false positives.

Copied from `trivy_tpu/handler.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import logging
from typing import Callable

logger = logging.getLogger(__name__)

# App types subject to the system-file filter (filter.go affectedTypes):
# installed-package discovery analyzers, never lockfiles.
AFFECTED_APP_TYPES = {
    "gemspec",
    "python-pkg",
    "conda-pkg",
    "node-pkg",
    "gobinary",
}

# filter.go defaultSystemFiles: distroless strips dpkg .list files, so these
# dpkg-owned python metadata files are hardcoded.
DEFAULT_SYSTEM_FILES = [
    "usr/lib/python2.7/argparse.egg-info",
    "usr/lib/python2.7/lib-dynload/Python-2.7.egg-info",
    "usr/lib/python2.7/wsgiref.egg-info",
]

_HANDLERS: list[Callable] = []


def register_post_handler(handler: Callable) -> None:
    _HANDLERS.append(handler)


def unregister_post_handler(handler: Callable) -> None:
    try:
        _HANDLERS.remove(handler)
    except ValueError:
        pass


def run_post_handlers(result) -> None:
    for handler in list(_HANDLERS):
        try:
            handler(result)
        except Exception:
            logger.warning("post handler %r failed", handler, exc_info=True)


def system_file_filter(result) -> None:
    """sysfile filter: drop affected-type applications whose file sits in
    the OS package manager's installed-file list."""
    system = {
        f.lstrip("/")
        for f in list(result.system_installed_files) + DEFAULT_SYSTEM_FILES
        if f.lstrip("/")
    }
    if not system:
        return
    kept = []
    for app in result.applications:
        if (
            app.app_type in AFFECTED_APP_TYPES
            and app.file_path.lstrip("/") in system
        ):
            continue
        kept.append(app)
    result.applications = kept


register_post_handler(system_file_filter)
