"""Post-scan hook registry (pkg/scanner/post/post_scan.go:19-41).

Hooks run after the driver assembles results and may insert, update, or
delete findings — the seam WASM modules and other extensions mutate scan
output through.  Hooks are plain callables `(results) -> results`; a hook
raising is logged and skipped so one broken extension cannot sink a scan.

Copied from `trivy_tpu/scanner/post.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import logging
from typing import Callable

logger = logging.getLogger(__name__)

_HOOKS: list[Callable] = []


def register_post_scan_hook(hook: Callable) -> None:
    """post.RegisterPostScanner."""
    _HOOKS.append(hook)


def unregister_post_scan_hook(hook: Callable) -> None:
    try:
        _HOOKS.remove(hook)
    except ValueError:
        pass


def run_post_scan_hooks(results: list, custom_resources: list | None = None) -> list:
    """post.Scan: thread results through every registered hook.

    Hooks accepting a second parameter also receive the scan's custom
    resources (extension-module analyze outputs, module.go CustomResources).
    """
    import inspect

    for hook in list(_HOOKS):
        try:
            try:
                accepts_two = (
                    len(inspect.signature(hook).parameters) >= 2
                )
            except (TypeError, ValueError):
                accepts_two = False
            if accepts_two:
                out = hook(results, custom_resources or [])
            else:
                out = hook(results)
        except Exception:
            logger.warning("post-scan hook %r failed", hook, exc_info=True)
            continue
        if out is not None:
            results = out
    return results
