"""WatchService: the continuous-scanning plane assembled and running.

Composition root for the watch subsystem: event sources feed the delta
planner on a poll loop, `rules push`/SIGHUP schedules re-verification
sweeps, and both paths publish verdict deltas through the stream.  The
server embeds one via :func:`build_watch_service` (--watch-config) and
surfaces `snapshot()` at GET /debug/watch; the CLI (`trivy-tpu watch`)
drives the same object with a local engine.

Threading: the poll loop and each sweep run on their own daemon
threads; `poll_once()` / `sweep_now()` are the synchronous forms tests
and the CLI's --once mode call directly.  All cross-thread state lives
behind the component locks (sources are only touched from the poll
thread; planner/sweeper/stream counters carry their own locks).
"""

from __future__ import annotations

import threading
import time

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.watch.config import WatchConfig
from trivy_tpu_torch.watch.planner import ContentStore, DeltaPlanner
from trivy_tpu_torch.watch.sources import EventSource, build_sources
from trivy_tpu_torch.watch.stream import VerdictDeltaStream, WebhookEmitter
from trivy_tpu_torch.watch.sweeper import ReverifySweeper


class WatchService:
    def __init__(
        self,
        sources: list[EventSource],
        planner: DeltaPlanner,
        sweeper: ReverifySweeper,
        stream: VerdictDeltaStream,
        content_store: ContentStore | None = None,
        poll_interval_s: float = 30.0,
        clock=time.time,
    ):
        self.sources = list(sources)
        self.planner = planner
        self.sweeper = sweeper
        self.stream = stream
        self.content_store = content_store
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None
        self._lock = lockcheck.make_lock("watch.service")
        self.cycles = 0  # owner: _lock
        self.last_cycle_ts = 0.0  # owner: _lock
        self.last_cycle: dict = {}  # owner: _lock

    # -- poll plane --------------------------------------------------------

    def poll_once(self) -> dict:
        """One full poll cycle across every source (synchronous: tests,
        CLI --once, and each loop iteration)."""
        cycle = {"records": 0, "events": 0, "novel": 0, "cached": 0,
                 "dispatched": 0, "errors": 0, "blobs": 0}
        for source in self.sources:
            records = source.poll()
            cycle["records"] += len(records)
            summary = self.planner.plan(records)
            for k in ("events", "blobs", "novel", "cached",
                      "dispatched", "errors"):
                cycle[k] += summary[k]
        with self._lock:
            self.cycles += 1
            self.last_cycle_ts = self._clock()
            self.last_cycle = dict(cycle)
        return cycle

    def start(self) -> None:
        """Start the background poll loop (idempotent)."""
        if self._loop_thread is not None and self._loop_thread.is_alive():
            return
        self._stop.clear()
        self._loop_thread = threading.Thread(
            target=self._loop, name="watch-poll", daemon=True
        )
        self._loop_thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                pass  # per-source errors are already absorbed; belt+braces
            self._stop.wait(self.poll_interval_s)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._loop_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    def close(self) -> None:
        self.stop()
        self.stream.close()

    # -- sweep plane -------------------------------------------------------

    def sweep_now(self, old_digest: str, new_digest: str) -> dict:
        """Synchronous re-verification sweep (tests, CLI)."""
        return self.sweeper.sweep(old_digest, new_digest)

    def schedule_sweep(self, old_digest: str, new_digest: str) -> bool:
        """Kick a sweep on a background thread after a ruleset change;
        False = nothing to do (no change, or digests unknown)."""
        if not old_digest or not new_digest or old_digest == new_digest:
            return False
        threading.Thread(
            target=self.sweeper.sweep,
            args=(old_digest, new_digest),
            name="watch-sweep",
            daemon=True,
        ).start()
        return True

    # -- observation -------------------------------------------------------

    def lag_s(self) -> float | None:
        """Seconds since the last completed poll cycle (None before the
        first) — the /debug/watch freshness signal."""
        with self._lock:
            last = self.last_cycle_ts
        if not last:
            return None
        return max(0.0, self._clock() - last)

    def snapshot(self) -> dict:
        with self._lock:
            cycles = self.cycles
            last_cycle = dict(self.last_cycle)
        snap = {
            "enabled": True,
            "poll_interval_s": self.poll_interval_s,
            "running": bool(
                self._loop_thread is not None
                and self._loop_thread.is_alive()
            ),
            "cycles": cycles,
            "lag_s": self.lag_s(),
            "last_cycle": last_cycle,
            "sources": [s.snapshot() for s in self.sources],
            "planner": self.planner.snapshot(),
            "sweep": self.sweeper.snapshot(),
            "stream": self.stream.snapshot(),
        }
        if self.content_store is not None:
            snap["content_store"] = self.content_store.snapshot()
        return snap

    def register_collectors(self, registry) -> None:
        """Export the trivy_tpu_watch_* families into a server registry,
        folding the plane's monotonic tallies in by delta at scrape time
        (the gate/cache/fleet collect-hook discipline).  Source labels
        come from the static watch config and outcome/result labels are
        enums — all bounded, so GL007's governor requirement does not
        apply."""
        m_events = registry.counter(
            "trivy_tpu_watch_events_total",
            "change records emitted by each watch event source",
            ("source",),
        )
        m_poll_errors = registry.counter(
            "trivy_tpu_watch_poll_errors_total",
            "failed polls by watch event source",
            ("source",),
        )
        m_blobs = registry.counter(
            "trivy_tpu_watch_blobs_total",
            "blobs the delta planner probed, by outcome "
            "(cached = verdict already held, novel = dispatched)",
            ("outcome",),
        )
        m_emit = registry.counter(
            "trivy_tpu_watch_emit_total",
            "verdict-delta webhook deliveries by result",
            ("result",),
        )
        m_sweeps = registry.counter(
            "trivy_tpu_watch_sweeps_total",
            "re-verification sweeps started",
        )
        g_sweep = registry.gauge(
            "trivy_tpu_watch_sweep_progress",
            "fraction of the current/last sweep's candidates processed "
            "(1.0 = complete or idle)",
        )
        g_lag = registry.gauge(
            "trivy_tpu_watch_poll_lag_seconds",
            "seconds since the last completed poll cycle",
        )
        exported: dict[tuple[int, str], float] = {}

        def _fold(family, labelname: str, value: str, total: float) -> None:
            key = (id(family), f"{labelname}={value}")
            delta = total - exported.get(key, 0)
            if delta > 0:
                family.labels(**{labelname: value}).inc(  # graftlint: ignore[GL007]
                    delta
                )
                exported[key] = total

        def _collect() -> None:
            for s in self.sources:
                snap = s.snapshot()
                _fold(m_events, "source", snap["name"], snap["emitted"])
                _fold(
                    m_poll_errors, "source", snap["name"], snap["errors"]
                )
            p = self.planner.snapshot()
            _fold(m_blobs, "outcome", "cached", p["blobs_cached"])
            _fold(m_blobs, "outcome", "novel", p["blobs_novel"])
            st = self.stream.snapshot()
            hook = st.get("webhook") or {}
            if hook:
                _fold(m_emit, "result", "delivered", hook["delivered"])
                _fold(m_emit, "result", "retried", hook["retried"])
                _fold(
                    m_emit, "result", "dropped",
                    hook["dropped_full"] + hook["dropped_failed"],
                )
            sw = self.sweeper.snapshot()
            delta = sw["sweeps_total"] - exported.get((0, "sweeps"), 0)
            if delta > 0:
                m_sweeps.inc(delta)
                exported[(0, "sweeps")] = sw["sweeps_total"]
            prog = sw["progress"]
            total = prog.get("total") or 0
            done = (
                prog.get("touched", 0)
                + prog.get("skipped_current", 0)
                + prog.get("missing_content", 0)
                + prog.get("failures", 0)
            )
            g_sweep.set(done / total if total else 1.0)
            g_lag.set(self.lag_s() or 0.0)

        registry.add_collect_hook(_collect)


def registry_resolver(client):
    """The production resolve_fn: manifest digests -> layer blob
    descriptors over one RegistryClient.  Fetches are deferred lambdas
    (the planner only pays for novel blobs)."""
    from trivy_tpu_torch.image.registry import parse_reference

    def resolve(record):
        ref_str = (
            f"{record.repo}@{record.digest}"
            if record.digest.startswith("sha256:")
            else f"{record.repo}:{record.tag}"
        )
        ref = parse_reference(ref_str)
        manifest, _raw = client.get_manifest(ref)

        def _fetch(digest: str) -> bytes:
            with client.get_blob(ref, digest) as f:
                return f.read()

        return [
            (layer["digest"], lambda d=layer["digest"]: _fetch(d))
            for layer in manifest.get("layers", [])
        ]

    return resolve


def build_watch_service(
    config: WatchConfig,
    result_cache,
    scan_fn,
    ruleset_digest_fn,
    artifact_cache=None,
    flight=None,
    resolve_fn=None,
    sources: list[EventSource] | None = None,
    sweep_scan_fn=None,
) -> WatchService:
    """Assemble a WatchService from a parsed WatchConfig.  The server
    and CLI both enter here; tests inject `sources`/`resolve_fn` fakes.
    This factory is also the GL015 boundary: event-source and webhook
    construction happen inside trivy_tpu_torch/watch/, never in serve/rpc
    code."""
    if sources is None:
        sources = build_sources(config.sources)
    if resolve_fn is None:
        from trivy_tpu_torch.image.registry import RegistryClient

        insecure = any(s.insecure for s in config.sources)
        resolve_fn = registry_resolver(RegistryClient(insecure=insecure))
    content_store = ContentStore(config.content_store_mb << 20)
    emitter = None
    if config.stream.webhook_url:
        emitter = WebhookEmitter(
            config.stream.webhook_url,
            queue_max=config.stream.webhook_queue,
            attempts=config.stream.webhook_attempts,
            flight=flight,
        )
    stream = VerdictDeltaStream(
        jsonl_path=config.stream.jsonl_path, emitter=emitter
    )

    def _on_planned(record, blob_digest, verdict):
        stream.publish(
            record.image, blob_digest, verdict,
            ruleset_digest=ruleset_digest_fn(),
        )

    planner = DeltaPlanner(
        result_cache,
        scan_fn,
        ruleset_digest_fn,
        resolve_fn,
        artifact_cache=artifact_cache,
        content_store=content_store,
        programs=config.programs,
        on_verdict=_on_planned,
    )

    def _on_swept(blob_digest, old_verdict, new_verdict):
        stream.publish(
            "", blob_digest, new_verdict,
            ruleset_digest=ruleset_digest_fn(), old=old_verdict,
        )

    if sweep_scan_fn is None:
        # Default: re-verdict on the same engine the planner dispatches
        # to (correct when the caller hot-reloads that engine in place,
        # e.g. the CLI; servers pass a digest-routing sweep_scan_fn).
        sweep_scan_fn = lambda items, _digest: scan_fn(items)  # noqa: E731
    sweeper = ReverifySweeper(
        result_cache,
        sweep_scan_fn,
        content_store,
        programs=config.programs,
        on_verdict=_on_swept,
        flight=flight,
    )
    return WatchService(
        sources,
        planner,
        sweeper,
        stream,
        content_store=content_store,
        poll_interval_s=config.poll_interval_s,
    )
