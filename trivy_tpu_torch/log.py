"""Logging setup: the reference's colored console handler discipline
(pkg/log): level-colored prefixes on a tty, plain text otherwise,
--debug/--quiet verbosity control, per-module loggers unchanged.

`--log-format json` swaps the console formatter for one JSON object per
line (ts/level/logger/msg), stamped with the ambient span's trace_id when
one is open — the key that joins a log line to its request's span tree.

Copied from `trivy_tpu/log.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_COLORS = {
    logging.DEBUG: "\x1b[35m",  # magenta
    logging.INFO: "\x1b[34m",  # blue
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class ConsoleFormatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__(datefmt="%Y-%m-%dT%H:%M:%S")
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        level = record.levelname
        if self.color:
            c = _COLORS.get(record.levelno, "")
            level = f"{c}{level}{_RESET}"
        prefix = f"{self.formatTime(record, self.datefmt)}\t{level}\t"
        name = record.name.removeprefix("trivy_tpu_torch.")
        msg = record.getMessage()
        out = f"{prefix}[{name}] {msg}"
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


class JsonFormatter(logging.Formatter):
    """One JSON object per line.  trace_id appears only when a span is
    open on the emitting thread (obs/trace.py contextvar) — server logs
    correlate to /debug/traces without any per-call plumbing."""

    def format(self, record: logging.LogRecord) -> str:
        from trivy_tpu_torch.obs import trace as obs_trace

        out = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(record.created)
            ),
            "level": record.levelname,
            "logger": record.name.removeprefix("trivy_tpu_torch."),
            "msg": record.getMessage(),
        }
        trace_id = obs_trace.current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup(
    debug: bool = False, quiet: bool = False, no_color: bool = False,
    log_format: str = "console",
) -> None:
    """Install the console handler on the package root logger.

    Idempotent: replaces a previously-installed handler, so tests and
    repeated main() calls do not stack duplicates."""
    logger = logging.getLogger("trivy_tpu_torch")
    for h in list(logger.handlers):
        if getattr(h, "_trivy_console", False):
            logger.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler._trivy_console = True  # type: ignore[attr-defined]
    if log_format == "json":
        handler.setFormatter(JsonFormatter())
    else:
        color = not no_color and sys.stderr.isatty()
        handler.setFormatter(ConsoleFormatter(color))
    logger.addHandler(handler)
    # Propagation stays on: the root logger has no handlers in CLI use
    # (no double printing) and log-capture tooling relies on it.
    if quiet:
        logger.setLevel(logging.ERROR)
    elif debug:
        logger.setLevel(logging.DEBUG)
    else:
        logger.setLevel(logging.INFO)
