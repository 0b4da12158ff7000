"""Flight recorder: cheap always-on tracing, breach-promoted incidents.

The trace ring (obs/trace.py) already records every span at deque-append
cost, but it is a *global* ring: by the time an operator asks "why was
that scan slow", the interesting spans have been pushed out by ten
thousand boring ones.  The flight recorder closes that gap the Dapper
way — keep tracing cheap and unconditional, and at the moment a request
*breaches* (latency over its SLO threshold, 408/5xx, a QoS 429, or a
deadline expiry inside the scheduler) promote everything we know about it
into a small bounded incident ring:

  * the request's full span tree, filtered out of the trace ring by
    trace id (queue wait, batch execution, engine phases — whatever the
    request touched);
  * a scheduler snapshot taken at breach time: lane depths, resident
    pool contents, QoS bucket levels — the context that explains *why*
    the request waited;
  * a device-memory snapshot (obs/memwatch.py) so an `hbm-pressure`
    incident names who held the bytes when the watermark tripped.

Incidents are served newest-first by `GET /debug/flight?limit=N` and,
when `--flight-out` is set, appended to a JSONL file as they are captured
so they survive the process.  The file is size-capped
(`--flight-out-max-mb`, default 64): when the active file would exceed
the cap it rotates to `<path>.1` (one backup generation), and records
lost with the overwritten backup count into
`trivy_tpu_flight_dropped_total` — a long-running server cannot fill the
disk with incidents.

Capture runs on request/handler threads and must never raise: an
observability feature that can turn a breach into an outage is worse
than no feature.  The snapshot callback, the gate callback, the memory
callback, and the file append are each individually guarded.

Copied from `trivy_tpu/obs/flight.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.obs import trace as obs_trace

DEFAULT_CAPACITY = 64
DEFAULT_OUT_MAX_MB = 64.0


class FlightRecorder:
    """Bounded incident ring.  `snapshot_fn` is injected (the server
    passes BatchScheduler.snapshot) so this module needs no dependency on
    trivy_tpu_torch.serve; `gate_fn` likewise (the server passes a
    gatelog.records thunk) so a capture embeds the hybrid-gate decisions
    that routed the breached request."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        snapshot_fn: Callable[[], dict] | None = None,
        out_path: str = "",
        out_max_mb: float = DEFAULT_OUT_MAX_MB,
        gate_fn: Callable[[], list] | None = None,
        registry=None,
        memory_fn: Callable[[], dict] | None = None,
        cache_fn: Callable[[], dict] | None = None,
        fleet_fn: Callable[[], dict] | None = None,
    ):
        self._lock = lockcheck.make_lock("obs.flight")
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))  # owner: _lock
        self._seq = 0  # owner: _lock
        self._snapshot_fn = snapshot_fn
        self._gate_fn = gate_fn
        self._memory_fn = memory_fn
        self._cache_fn = cache_fn
        self._fleet_fn = fleet_fn
        self.out_path = out_path
        # 0 disables the cap; the bookkeeping below is all owner: _lock.
        self.out_max_bytes = int(max(0.0, out_max_mb) * (1 << 20))
        self._out_bytes = 0
        self._out_records = 0  # records this process wrote to the active file
        self._backup_records = 0  # records this process rotated into .1
        self.dropped = 0  # records lost to rotation (this process's writes)
        if out_path:
            try:
                self._out_bytes = os.path.getsize(out_path)
            except OSError:
                self._out_bytes = 0
        self._m_captured = None
        self._m_dropped = None
        if registry is not None:
            self._m_captured = registry.counter(
                "trivy_tpu_flight_records_total",
                "breach incidents captured into the flight ring",
                ("reason",),
            )
            self._m_dropped = registry.counter(
                "trivy_tpu_flight_dropped_total",
                "flight-out JSONL records lost to size-capped rotation",
            )

    @property
    def captured(self) -> int:
        with self._lock:
            return self._seq

    # -- capture (request / owner threads) ---------------------------------

    def _span_tree(self, trace_id: str) -> list[dict]:
        if not trace_id:
            return []
        spans = [s for s in obs_trace.snapshot() if s.trace_id == trace_id]
        spans.sort(key=lambda s: (s.start, s.span_id))
        t0 = spans[0].start if spans else 0.0
        return [
            {
                "name": s.name,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "start_ms": round((s.start - t0) * 1e3, 3),
                "dur_ms": round(s.dur * 1e3, 3),
                "tid": s.tid,
                "attrs": dict(s.attrs),
            }
            for s in spans
        ]

    def _scheduler_state(self) -> dict:
        if self._snapshot_fn is None:
            return {}
        try:
            return self._snapshot_fn()
        except Exception as e:
            # Breach context is best-effort; the record (with spans) still
            # lands even when the scheduler is mid-teardown.
            return {"error": f"{type(e).__name__}: {e}"}

    def _gate_state(self) -> list:
        if self._gate_fn is None:
            return []
        try:
            return list(self._gate_fn())
        except Exception as e:
            return [{"error": f"{type(e).__name__}: {e}"}]

    def _memory_state(self) -> dict:
        if self._memory_fn is None:
            return {}
        try:
            return dict(self._memory_fn())
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _cache_state(self) -> dict:
        if self._cache_fn is None:
            return {}
        try:
            return dict(self._cache_fn())
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _fleet_state(self) -> dict:
        if self._fleet_fn is None:
            return {}
        try:
            return dict(self._fleet_fn())
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def capture(
        self,
        *,
        trace_id: str = "",
        method: str = "",
        tenant: str = "",
        code: int = 0,
        elapsed_s: float = 0.0,
        reason: str = "",
    ) -> dict:
        """Promote one breached request into the incident ring and return
        the record (callers may enrich their logs with it)."""
        rec = {
            "seq": 0,
            "captured_at": time.time(),
            "reason": reason,
            "method": method,
            "tenant": tenant,
            "trace_id": trace_id,
            "code": int(code),
            "elapsed_s": round(float(elapsed_s), 6),
            "spans": self._span_tree(trace_id),
            "scheduler": self._scheduler_state(),
            "gate": self._gate_state(),
            "memory": self._memory_state(),
            "cache": self._cache_state(),
        }
        fleet = self._fleet_state()
        if fleet:
            # Fleeted hosts only: which member this was and its affinity
            # posture at breach time (omitted entirely when unfleeted,
            # keeping existing record shapes byte-stable).
            rec["fleet"] = fleet
        dropped = 0
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            if self.out_path:
                try:
                    line = json.dumps(rec, default=str) + "\n"
                    if (
                        self.out_max_bytes
                        and self._out_bytes
                        and self._out_bytes + len(line) > self.out_max_bytes
                    ):
                        # One backup generation: the active file demotes to
                        # .1 (still on disk), whatever .1 held is gone —
                        # that loss is what the dropped counter measures.
                        os.replace(self.out_path, self.out_path + ".1")
                        dropped = self._backup_records
                        self.dropped += dropped
                        self._backup_records = self._out_records
                        self._out_records = 0
                        self._out_bytes = 0
                    with open(self.out_path, "a") as f:
                        f.write(line)
                    self._out_bytes += len(line)
                    self._out_records += 1
                except OSError:
                    pass
        if self._m_captured is not None:
            self._m_captured.labels(reason=reason or "unknown").inc()
        if dropped and self._m_dropped is not None:
            self._m_dropped.inc(dropped)
        return rec

    # -- read side (debug endpoint, tests) ---------------------------------

    def records(self, limit: int | None = None) -> list[dict]:
        """Newest-first incident list, optionally truncated to `limit`."""
        with self._lock:
            items = list(self._ring)
        items.reverse()
        if limit is not None:
            items = items[: max(0, int(limit))]
        return items
