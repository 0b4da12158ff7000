"""Ring-buffer span collector with Chrome-trace export.

Copied from `trivy_tpu/obs/trace.py`: the port imports nothing from the
JAX package, so it keeps its own copy of this jax-free module.

Spans are wall-clock intervals named after pipeline stages ("rpc.scan_secrets",
"queue.wait", "batch", "chunk.h2d", "confirm", ...), linked into trees by a
contextvar carrying (trace_id, span_id): a span opened inside another on the
same thread becomes its child, and a trace_id minted on a scanning client
(rpc/client.py RemoteSecretEngine) rides the `X-Trivy-Trace-Id` header so
server-side spans join the same tree.

Granularity discipline: spans mark per-request / per-batch / per-chunk work,
never per-file or per-row — the collector is a deque append under a lock, but
nothing is free at row rates.  When tracing is disabled (the default),
`span()` returns a shared no-op context manager after one predicate, so
instrumented hot paths pay one call per span site.

Export is the Chrome trace-event format (`"X"` complete events, microsecond
timestamps), which chrome://tracing and ui.perfetto.dev load directly.  Spans
record `time.perf_counter()`.  `to_chrome` anchors them to the wall clock
through a process-start epoch (a file of host spans alone).  Under a
`torch.profiler` window, `clock_mark()` at the window's start and end opens
`record_function` marks at recorded perf_counter readings, and
`merge_into_profile` writes the spans into the profiler's exported trace on
that trace's own clock, fitted through the marks, so one file shows host
stages against the device's operations.
"""

from __future__ import annotations

import contextvars
import json
import os
import statistics
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field

from trivy_tpu_torch import lockcheck

# perf_counter -> wall-clock anchor, fixed at import so every span in the
# process (and its chrome export) shares one timebase.
_EPOCH_S = time.time() - time.perf_counter()

DEFAULT_RING = 8192

# The profiler annotation that pins the perf_counter clock to a trace's.
CLOCK_MARK = "trivy_tpu.clock"
CLOCK_MARKS = 5  # record_function marks a clock_mark() opens

_lock = lockcheck.make_lock("obs.trace.ring")
_ring: deque = deque(maxlen=DEFAULT_RING)  # owner: _lock
_enabled = os.environ.get("TRIVY_TPU_TRACE", "") not in ("", "0", "false", "off")
_next_id = 0  # owner: _lock

# (trace_id, span_id) of the innermost open span on this thread/context.
_ctx: contextvars.ContextVar[tuple[str, int] | None] = contextvars.ContextVar(
    "trivy_tpu_trace", default=None
)


@dataclass
class SpanRecord:
    """One closed span: [start, start+dur) in perf_counter seconds."""

    name: str
    trace_id: str
    span_id: int
    parent_id: int
    start: float
    dur: float
    tid: int
    attrs: dict = field(default_factory=dict)


def enabled() -> bool:
    return _enabled


def enable(ring: int | None = None) -> None:
    """Turn span collection on (idempotent); `ring` bounds retained spans."""
    global _enabled, _ring
    with _lock:
        if ring is not None and ring != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, ring))
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    with _lock:
        _ring.clear()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> str:
    """trace_id of the innermost open span on this thread ("" when none) —
    the correlation key JSON logging and the RPC client header read."""
    cur = _ctx.get()
    return cur[0] if cur else ""


def _alloc_id() -> int:  # graftlint: holds(_lock)
    global _next_id
    _next_id += 1
    return _next_id


class _NoopSpan:
    """Shared do-nothing span: the disabled path's entire cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "trace_id", "attrs", "span_id", "parent_id", "_tok", "_t0")

    def __init__(self, name: str, trace_id: str | None, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def __enter__(self):
        parent = _ctx.get()
        if not self.trace_id:
            self.trace_id = parent[0] if parent else new_trace_id()
        self.parent_id = parent[1] if parent else 0
        with _lock:
            self.span_id = _alloc_id()
        self._tok = _ctx.set((self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        _ctx.reset(self._tok)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        with _lock:
            _ring.append(
                SpanRecord(
                    self.name, self.trace_id, self.span_id, self.parent_id,
                    self._t0, dur, threading.get_ident(), self.attrs,
                )
            )
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, trace_id: str | None = None, **attrs):
    """Context manager timing one pipeline stage.  `trace_id` pins the
    span to a specific trace (the RPC boundary); otherwise it inherits the
    enclosing span's, minting a fresh one at tree roots."""
    if not _enabled:
        return _NOOP
    return _Span(name, trace_id, attrs)


def add_span(
    name: str,
    start: float,
    dur: float,
    trace_id: str | None = None,
    parent_id: int = 0,
    **attrs,
) -> None:
    """Record an interval measured after the fact (queue wait: the
    scheduler only learns a ticket's wait at dispatch).  `start` is in
    perf_counter seconds (derive past instants as perf_counter() - age).
    Without a `trace_id` the span is a child of the innermost open span on
    this thread (a stretch timed inside it), else of `parent_id` in that
    trace ("" mints a fresh one)."""
    if not _enabled:
        return
    if trace_id is None:
        cur = _ctx.get()
        trace_id, parent_id = cur if cur else ("", 0)
    with _lock:
        _ring.append(
            SpanRecord(
                name, trace_id or new_trace_id(), _alloc_id(), parent_id,
                start, max(0.0, dur), threading.get_ident(), attrs,
            )
        )


def adopt(trace_id: str):
    """Context manager adopting `trace_id` as the ambient trace without
    opening a timed span (the scheduler's owner thread stamps a batch's
    lead trace onto engine spans this way)."""
    return _Adopt(trace_id)


class _Adopt:
    __slots__ = ("trace_id", "_tok")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id

    def __enter__(self):
        cur = _ctx.get()
        self._tok = _ctx.set((self.trace_id, cur[1] if cur else 0))
        return self

    def __exit__(self, *exc):
        _ctx.reset(self._tok)
        return False


def snapshot() -> list[SpanRecord]:
    with _lock:
        return list(_ring)


def to_chrome(spans: list[SpanRecord] | None = None) -> dict:
    """Chrome trace-event JSON (the format chrome://tracing and Perfetto
    load): one "X" complete event per span, µs timestamps on the wall
    clock, thread id preserved, span linkage in args."""
    if spans is None:
        spans = snapshot()
    pid = os.getpid()
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": "trivy-tpu host"},
        }
    ]
    events.extend(_span_events(spans, pid, 1e6, _EPOCH_S * 1e6))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _span_events(spans: list[SpanRecord], pid: int, scale: float,
                 offset: float) -> list[dict]:
    """One "X" event a span, at `start * scale + offset` microseconds."""
    events = []
    for s in spans:
        args = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
        }
        args.update(s.attrs)
        events.append(
            {
                "name": s.name,
                "cat": "host_span",
                "ph": "X",
                "ts": s.start * scale + offset,
                "dur": s.dur * scale,
                "pid": pid,
                "tid": s.tid,
                "args": args,
            }
        )
    return events


def dump(path: str, spans: list[SpanRecord] | None = None) -> str:
    """Write the chrome-trace JSON to `path` (creating parent dirs);
    returns the path written."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome(spans), f)
    return path


def clock_mark() -> list[tuple[float, float, float, float]]:
    """Open CLOCK_MARKS `record_function(CLOCK_MARK)` annotations back to
    back inside a running `torch.profiler` window, each between perf_counter
    readings: (before open, after open, before close, after close).  Call it
    at a window's start and at its end; `merge_into_profile` fits the clock
    through both."""
    from torch.profiler import record_function

    out = []
    for _ in range(CLOCK_MARKS):
        mark = record_function(CLOCK_MARK)
        a = time.perf_counter()
        mark.__enter__()
        b = time.perf_counter()
        c = time.perf_counter()
        mark.__exit__(None, None, None)
        out.append((a, b, c, time.perf_counter()))
    return out


def profile_clock(events: list[dict], marks) -> tuple[float, float]:
    """(scale, offset) with trace µs = perf_counter s * scale + offset,
    fitted through the trace's CLOCK_MARK events and `marks`, the results
    of the `clock_mark()` calls that opened them, in order.  Each mark's
    open and close pin the two clocks at the middle of their readings; each
    call's pins give a median, and the line through the first and last
    call's medians follows any difference in rate.  Marks under a second
    apart keep the rate at 1e6 (their scatter would outweigh a drift)."""
    found = sorted((e for e in events if e.get("name") == CLOCK_MARK
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    if not marks or len(found) != sum(len(m) for m in marks):
        raise ValueError(f"the trace holds {len(found)} clock marks for "
                         f"{sum(len(m) for m in marks)} taken")
    it = iter(found)
    centres = []  # (perf_counter s, trace us - perf_counter us), a call
    for call in marks:
        pins = []
        for (a, b, c, d), e in zip(call, it):
            pins.append(((a + b) / 2, e["ts"]))
            pins.append(((c + d) / 2, e["ts"] + e.get("dur", 0.0)))
        centres.append((statistics.median(p for p, _ in pins),
                        statistics.median(t - p * 1e6 for p, t in pins)))
    (p0, o0), (p1, o1) = centres[0], centres[-1]
    if p1 - p0 < 1.0:
        return 1e6, statistics.median(o for _, o in centres)
    scale = 1e6 + (o1 - o0) / (p1 - p0)
    return scale, o0 + p0 * 1e6 - p0 * scale


def merge_into_profile(trace_path: str, marks,
                       spans: list[SpanRecord] | None = None) -> str | None:
    """Write the host spans into the Chrome trace `torch.profiler` exported
    at `trace_path`, on that trace's clock (`profile_clock` through
    `marks`, the results of `clock_mark()` at the window's start and end).
    Returns the path, or None (the file untouched) when tracing is off or
    there is no span."""
    if not _enabled:
        return None
    if spans is None:
        spans = snapshot()
    if not spans:
        return None
    with open(trace_path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    scale, offset = profile_clock(events, marks)
    events.extend(_span_events(spans, os.getpid(), scale, offset))
    with open(trace_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return trace_path
