"""Counter/gauge/histogram families with one registry + exposition renderer.

The server's and scheduler's hand-rolled Prometheus text lines grew the same
code three times (rpc/server.py _Metrics, serve/scheduler.py metrics_text and
_engine_metric_lines); this module is the single exposition path they all
render through.  Families register on a `Registry` (per-server, never
process-global — tests boot many servers in one process), samples update at
event time, and `render()` emits text-format 0.0.4: HELP + TYPE per family,
histogram `_bucket{le=...}` series cumulative and `le="+Inf"`-terminated,
`_sum`/`_count` alongside.

Latency lives in fixed-bucket histograms, not totals: a `*_seconds_total`
counter answers "how much", a histogram answers "how bad is the tail", and
the tail is what an admission queue tunes against.

Collect hooks run at scrape time for values owned elsewhere (queue depth,
ruleset epoch, engine link gauges) — a hook must never do work a scrape
shouldn't trigger (the scheduler's hook reads the non-building
`RulesetManager.active`, exactly like the render path it replaces).

Copied from `trivy_tpu/obs/metrics.py`, with `device_phase` ported to
torch: a section over CUDA tensors is timed by a pair of `torch.cuda.Event`s
on the current stream and resolved when the samples are drained, so
tracing never waits on the device; a section over CPU tensors keeps the
host clock.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Callable, Iterable

from trivy_tpu_torch import lockcheck

# Request/wait latency buckets: 1ms..60s, roughly log-spaced.  The scan
# server's floor is a batch window of a few ms and its ceiling a deadline
# of minutes; these cover both tails.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Batch fill ratio is bounded [0, 1]; resolution matters near empty
# (window expired) and near full (bytes-capped dispatch).
RATIO_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
# Per-batch byte volumes: 4 KiB .. 256 MiB, x4 steps.
BYTES_BUCKETS = tuple(float(4096 * 4**i) for i in range(9))


def _fmt(v: float | int) -> str:
    """Exposition value: ints stay ints, floats trim trailing zeros."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if v != v or v in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(v, "NaN")
    out = f"{v:.9f}".rstrip("0").rstrip(".")
    return out or "0"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Family:
    kind = ""

    def __init__(
        self, name: str, help_text: str, labelnames: tuple[str, ...],
        lock: threading.Lock,
    ):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            # Label-less families expose their zero sample immediately
            # (a gauge that has never been set must still scrape as 0).
            self._child(())

    def _new_child(self):
        raise NotImplementedError

    def _child(self, key: tuple[str, ...]):
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def clear(self) -> None:
        """Drop every child series.  The seat for collect hooks that
        rebuild a family from live state each scrape (e.g. one
        trivy_tpu_build_info series per *resident* ruleset): without the
        reset, series for evicted residents would keep scraping stale 1s.
        Label-less families re-expose their zero sample immediately."""
        with self._lock:
            self._children.clear()
        if not self.labelnames:
            self._child(())

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != {sorted(self.labelnames)}"
            )
        return self._child(tuple(str(kw[n]) for n in self.labelnames))

    def fold_label(self, labelname: str, value: str, into: str) -> None:
        """Fold every series whose `labelname` equals `value` into the
        series with that label replaced by `into`, then drop the source.

        The cardinality governor's demotion primitive: totals are conserved
        (each event was counted exactly once, folding moves samples rather
        than duplicating them), the destination stays monotonic (a fold
        only adds), and the demoted series disappears from the next scrape
        instead of pinning a stale sample forever."""
        if labelname not in self.labelnames:
            raise ValueError(
                f"{self.name}: no label {labelname!r} in {self.labelnames}"
            )
        i = self.labelnames.index(labelname)
        with self._lock:
            keys = [k for k in self._children if k[i] == str(value)]
            for key in keys:
                src = self._children.pop(key)
                dkey = key[:i] + (str(into),) + key[i + 1 :]
                dst = self._children.get(dkey)
                if dst is None:
                    dst = self._children[dkey] = self._new_child()
                self._fold_child(src, dst)

    def _fold_child(self, src, dst) -> None:
        """Merge src's samples into dst; runs under the family lock, so it
        must touch child fields directly (inc()/observe() would deadlock
        on the same non-reentrant lock)."""
        raise NotImplementedError

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            lines.extend(self._render_child(key, child))
        return lines

    def _render_child(self, key, child) -> list[str]:
        raise NotImplementedError


class _Value:
    __slots__ = ("v", "_lock")

    def __init__(self, lock: threading.Lock):
        self.v = 0.0
        self._lock = lock


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.v += amount

    def set_total(self, value: float) -> None:
        """Collect-hook seat: adopt a monotonic total owned elsewhere
        (e.g. RulesetManager.reloads) instead of double-counting events."""
        with self._lock:
            self.v = value


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def _fold_child(self, src, dst) -> None:
        dst.v += src.v

    def inc(self, amount: float = 1.0) -> None:
        self._child(()).inc(amount)

    def set_total(self, value: float) -> None:
        self._child(()).set_total(value)

    def _render_child(self, key, child) -> list[str]:
        return [
            f"{self.name}{_label_str(self.labelnames, key)} {_fmt(_as_num(child.v))}"
        ]


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.v = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.v += amount

    def dec(self, amount: float = 1.0, floor: float | None = None) -> None:
        with self._lock:
            self.v -= amount
            if floor is not None and self.v < floor:
                self.v = floor


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def _fold_child(self, src, dst) -> None:
        # Gauges fold additively: the governor only demotes counting-style
        # gauges, where "combined level" is the only meaningful rollup.
        dst.v += src.v

    def set(self, value: float) -> None:
        self._child(()).set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._child(()).inc(amount)

    def dec(self, amount: float = 1.0, floor: float | None = None) -> None:
        self._child(()).dec(amount, floor)

    def _render_child(self, key, child) -> list[str]:
        return [
            f"{self.name}{_label_str(self.labelnames, key)} {_fmt(_as_num(child.v))}"
        ]


class _HistogramChild:
    __slots__ = ("counts", "sum", "count", "_buckets", "_lock")

    def __init__(self, buckets: tuple[float, ...], lock: threading.Lock):
        self._buckets = buckets
        self.counts = [0] * len(buckets)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, value: float) -> None:
        i = bisect_left(self._buckets, value)
        with self._lock:
            if i < len(self.counts):
                self.counts[i] += 1
            self.sum += value
            self.count += 1


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help_text, labelnames, lock, buckets):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{name}: histogram needs >= 1 bucket bound")
        self.buckets = b
        super().__init__(name, help_text, labelnames, lock)

    def _new_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def _fold_child(self, src, dst) -> None:
        for i, n in enumerate(src.counts):
            dst.counts[i] += n
        dst.sum += src.sum
        dst.count += src.count

    def observe(self, value: float) -> None:
        self._child(()).observe(value)

    def _render_child(self, key, child) -> list[str]:
        lines = []
        cum = 0
        for bound, n in zip(self.buckets, child.counts):
            cum += n
            labels = _label_str(
                self.labelnames + ("le",), key + (_fmt(bound),)
            )
            lines.append(f"{self.name}_bucket{labels} {cum}")
        inf_labels = _label_str(self.labelnames + ("le",), key + ("+Inf",))
        lines.append(f"{self.name}_bucket{inf_labels} {child.count}")
        plain = _label_str(self.labelnames, key)
        lines.append(f"{self.name}_sum{plain} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{plain} {child.count}")
        return lines


def _as_num(v: float):
    """Render-friendly: whole floats print as ints (counters that only
    ever inc(1) must expose `3`, not `3.0`)."""
    return int(v) if isinstance(v, float) and v.is_integer() else v


class Registry:
    """One scrape surface: ordered families + collect hooks."""

    def __init__(self):
        self._lock = lockcheck.make_lock("obs.metrics.registry")
        self._families: dict[str, _Family] = {}  # owner: _lock
        self._hooks: list[Callable[[], None]] = []  # owner: _lock

    def _register(self, cls, name: str, help_text: str, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set"
                    )
                return fam
            fam = cls(name, help_text, tuple(labelnames),
                      lockcheck.make_lock("obs.metrics.family"), **kw)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help_text: str, labelnames: Iterable[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help_text, labelnames)

    def gauge(
        self, name: str, help_text: str, labelnames: Iterable[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str,
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = LATENCY_BUCKETS,
    ) -> Histogram:
        return self._register(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def add_collect_hook(self, fn: Callable[[], None]) -> None:
        """`fn()` runs at every render(), before lines are built — the seat
        for gauges mirroring live state (queue depth, engine stats).  Hooks
        must be cheap and must never build what is not already built."""
        with self._lock:
            self._hooks.append(fn)

    def render(self) -> str:
        with self._lock:
            hooks = list(self._hooks)
            fams = list(self._families.values())
        for fn in hooks:
            try:
                fn()
            except Exception:
                # A scrape must never 500 because one hook's source object
                # is mid-teardown; the stale sample is the lesser evil.
                pass
        lines: list[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Device-phase attribution: per-kernel device timings from the engines
# ---------------------------------------------------------------------------
#
# The engines' coarse wall timings (dispatch_s / fetch_map_s) lump every
# kernel behind one async dispatch boundary; these helpers split them into
# per-kernel sections.  `device_phase(kernel)` opens a `kernel.<name>` span
# nested under the ambient chunk span, which covers the host's enqueue, and
# on a card records a timing event on the current stream; `.done(*tensors)`
# records the closing event and queues the pair.  Nothing waits on the
# device: a pair resolves to seconds when the samples are drained, once
# both events have completed, so a traced pass keeps the dispatch overlap
# of an untraced one.  A section over CPU tensors (or none) is timed on
# the host clock.  Only when tracing is enabled: the disabled path returns a
# shared no-op handle and costs one predicate.
#
# Samples queue process-globally (engines don't own a registry); a server's
# collect hook drains them into its per-server
# `trivy_tpu_device_phase_seconds{kernel}` histogram at scrape time.

# Kernel sections are sub-millisecond to a few seconds (relay dispatch):
# 50us .. 2.5s, roughly log-spaced.
DEVICE_PHASE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

_DEVICE_PHASE_LOCK = lockcheck.make_lock("obs.metrics.device_phase")
# (kernel, device, seconds or a (start, end) event pair not yet resolved)
_DEVICE_PHASE_PENDING: list[tuple[str, str, object]] = []  # owner: _DEVICE_PHASE_LOCK
# Tracing on with nothing scraping (CLI scans) must not grow unbounded:
# beyond the cap the oldest samples and pairs drop — the scrape path is
# best-effort by design, the span tree keeps the full record.
_DEVICE_PHASE_MAX_PENDING = 4096


def _queue_device_phase(entry: tuple[str, str, object]) -> None:
    with _DEVICE_PHASE_LOCK:
        _DEVICE_PHASE_PENDING.append(entry)
        overflow = len(_DEVICE_PHASE_PENDING) - _DEVICE_PHASE_MAX_PENDING
        if overflow > 0:
            del _DEVICE_PHASE_PENDING[:overflow]


def record_device_phase(kernel: str, seconds: float, device: str = "") -> None:
    """Queue one per-kernel timing for the next scrape drain.

    `device` is the bounded device label ("cuda:0", "cpu", "" when
    unknown) — bounded by construction: values come only from the devices
    of the section's output tensors.  Positional callers land in the ""
    series."""
    _queue_device_phase((kernel, device, seconds))


def drain_device_phases() -> list[tuple[str, str, float]]:
    """Take every resolved (kernel, device, seconds) sample, in the order
    the sections closed (collect-hook seat).  An event pair whose events
    have completed resolves to their elapsed time; one still on the device
    stays queued for a later drain."""
    out: list[tuple[str, str, float]] = []
    with _DEVICE_PHASE_LOCK:
        waiting = []
        for kernel, device, value in _DEVICE_PHASE_PENDING:
            if not isinstance(value, tuple):
                out.append((kernel, device, value))
            elif value[0].query() and value[1].query():
                out.append((kernel, device, value[0].elapsed_time(value[1]) / 1e3))
            else:
                waiting.append((kernel, device, value))
        _DEVICE_PHASE_PENDING[:] = waiting
    return out


class _NoopPhase:
    __slots__ = ()

    def done(self, *arrays) -> float:
        return 0.0


_NOOP_PHASE = _NoopPhase()


def _cuda_event(index: int):
    """A timing event recorded on the current stream of CUDA device
    `index`; never waited on."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(index))
    return ev


def _cuda_index() -> int | None:
    """The current CUDA device's index, or None before CUDA has started
    (a section then keeps the host clock)."""
    import torch

    return torch.cuda.current_device() if torch.cuda.is_initialized() else None


class _DevicePhase:
    __slots__ = ("kernel", "_t0", "_span", "_start")

    def __init__(self, kernel: str):
        from trivy_tpu_torch.obs import trace as obs_trace

        self.kernel = kernel
        # The events bracket the span, so the span holds the enqueue alone
        # and the instrument's own calls fall to the enclosing span.
        index = _cuda_index()
        self._start = None if index is None else (index, _cuda_event(index))
        # Deliberate handle pattern: begin/done brackets an async dispatch
        # across statements, which `with` cannot.  If done() is skipped by
        # an unwinding exception the span misses its ring append but the
        # ambient context heals: the enclosing chunk span's token reset
        # restores the contextvar.
        self._span = obs_trace.span(  # graftlint: ignore[GL006]
            f"kernel.{kernel}", kernel=kernel
        )
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def done(self, *tensors) -> float:
        """Close the section over its output tensors; returns the host
        seconds since it opened (the enqueue, on a card)."""
        dt = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        flat: list = []
        for a in tensors:
            if isinstance(a, (tuple, list)):
                flat.extend(a)
            else:
                flat.append(a)
        device = next((t.device for t in flat if getattr(t, "device", None) is not None),
                      None)
        if (getattr(device, "type", None) == "cuda" and self._start is not None
                and self._start[0] == device.index):
            pair = (self._start[1], _cuda_event(device.index))
            _queue_device_phase((self.kernel, str(device), pair))
        else:
            record_device_phase(self.kernel, dt, device="" if device is None else str(device))
        return dt


def device_phase(kernel: str):
    """Begin a per-kernel timed section; no-op unless tracing is enabled.

    Usage in engine code::

        ph = obs_metrics.device_phase("sieve-step")
        out = step(dev_rows)          # async launch
        ph.done(out)                  # closing event + sample + close span

    `.done(*tensors)` labels the sample with the first tensor's device;
    host-side sections pass none and read the host clock."""
    from trivy_tpu_torch.obs import trace as obs_trace

    if not obs_trace.enabled():
        return _NOOP_PHASE
    return _DevicePhase(kernel)
