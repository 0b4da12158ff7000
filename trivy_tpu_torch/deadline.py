"""Scan deadline (the --timeout context, run.go:395-402).

Copied from `trivy_tpu/deadline.py` (the port imports nothing from the JAX
package).

The runner's worker thread arms a monotonic deadline; work boundaries call
check() — per walked file and per analyzer in the dispatch loop, per chunk
in the hybrid engine, and before the report writes — so a timed-out scan
stops shortly after the deadline and never emits a report.  Phases between
checkpoints (a single device sieve call, one oracle confirm) still run to
their own completion first.
Thread-local so a server process can run concurrent scans with independent
deadlines.
"""

from __future__ import annotations

import threading
import time


class ScanTimeoutError(RuntimeError):
    pass


_local = threading.local()


def set_deadline(seconds: float | None) -> None:
    _local.at = (time.monotonic() + seconds) if seconds and seconds > 0 else None


def set_deadline_at(at: float | None) -> None:
    """Arm an absolute time.monotonic() deadline.  The serve scheduler uses
    this to re-arm the engine-owner thread from ticket deadlines computed on
    request threads."""
    _local.at = at


def remaining() -> float | None:
    """Seconds until the armed deadline (negative if past), None if unarmed."""
    at = getattr(_local, "at", None)
    return None if at is None else at - time.monotonic()


def clear() -> None:
    _local.at = None


def check() -> None:
    at = getattr(_local, "at", None)
    if at is not None and time.monotonic() > at:
        raise ScanTimeoutError("scan deadline exceeded (--timeout)")
