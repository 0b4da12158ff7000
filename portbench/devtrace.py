"""Reduction of a `torch.profiler` trace to the device's busy time, its
kernels and its idle gaps.

One profiled stretch of whole scans: the harness wraps each batch in a
`portbench.batch` annotation and records a CUDA event pair around the whole
stretch.  From the exported Chrome trace this module takes

- the device's operations (kernels, copies, fills) inside the stretch, whose
  union is the busy time, and the kernels alone, summed and by name;
- the idle gaps between them, cut where a host span
  (`trivy_tpu_torch/obs/trace.py`) opens or closes and each piece put down
  to the innermost span open through it, the spans mapped onto the trace's
  clock through the annotations' host start times;
- two checks that fail the run loudly rather than report a short reading:
  the profiler saw at least as many of the port's kernels as its wrappers
  counted launches, and its busy time fits inside the CUDA events' span.
"""

from __future__ import annotations

import json
import re
import statistics
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "portbench.batch"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def program_kernel_names(csrc: Path) -> set[str]:
    """The `__global__` functions of the program's CUDA sources."""
    names: set[str] = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(trace_file: Path, batch_starts: list[float], spans, launches: int,
                 kernel_names: set[str], event_s: float, main_tid: int | None = None) -> dict:
    """`batch_starts`: host perf_counter seconds at which each annotated batch
    began; `spans`: `SpanRecord`s of the stretch; `launches`: launches the
    program's wrappers counted in it; `event_s`: the CUDA events' span.  A
    gap goes to the innermost span open on `main_tid` (the thread that called
    the engine), else to the innermost open on any thread."""
    events = json.loads(Path(trace_file).read_text()).get("traceEvents", [])
    marks = sorted((e for e in events if e.get("name") == ANNOTATION and e.get("ph") == "X"
                    and e.get("cat") in ("user_annotation", "cpu_op")),
                   key=lambda e: e["ts"])
    if len(marks) != len(batch_starts):
        raise RuntimeError(f"the trace holds {len(marks)} batch annotations for "
                           f"{len(batch_starts)} batches")
    lo, hi = marks[0]["ts"], max(m["ts"] + m["dur"] for m in marks)
    # trace microseconds = host perf_counter seconds * 1e6 + offset
    offset = statistics.median(m["ts"] - t * 1e6 for m, t in zip(marks, batch_starts))
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo]
    spans_busy = _union([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in ops])
    busy_us = sum(b - a for a, b in spans_busy)
    kernels = [e for e in ops if e["cat"] == "kernel"]
    by_name: dict[str, float] = {}
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ours = sum(1 for e in kernels
               if any(re.search(rf"(^|[\s:]){n}\b", e["name"]) for n in kernel_names))
    if ours < launches:
        raise RuntimeError(f"the profiler recorded {ours} of the program's kernels for "
                           f"{launches} counted launches: records were lost")
    if busy_us / 1e6 > event_s * 1.01 + 1e-5:
        raise RuntimeError(f"the profiler's busy time {busy_us / 1e6} s exceeds the CUDA "
                           f"events' span {event_s} s")
    span_s: dict[str, float] = {}
    for sp in spans:
        span_s[sp.name] = span_s.get(sp.name, 0.0) + sp.dur
    gaps: dict[str, float] = {}
    edges = [lo] + [x for ab in spans_busy for x in ab] + [hi]
    host = [(s.start * 1e6 + offset, (s.start + s.dur) * 1e6 + offset, s.name, s.tid == main_tid)
            for s in spans]
    for a, b in zip(edges[::2], edges[1::2]):
        # cut the gap where a host span opens or closes; each piece goes to
        # the span open through it
        cuts = sorted({a, b} | {t for start, end, _n, _m in host for t in (start, end) if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            open_ = [(main, start, name) for start, end, name, main in host if start <= mid < end]
            label = max(open_)[2] if open_ else "outside spans"
            gaps[label] = gaps.get(label, 0.0) + (y - x) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": sum(e["dur"] for e in kernels) / 1e6,
        "kernels": len(kernels),
        "program_kernels": ours,
        "launches": launches,
        "event_s": event_s,
        "spans": len(spans),
        "span_s": span_s,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }
