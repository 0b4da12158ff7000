"""Verdict-delta stream: ordered JSONL sink + at-least-once webhook.

The watch plane's output is not verdicts but *changes to verdicts*:
per (image, blob), which findings appeared, disappeared, or changed
since the last verdict for that blob.  Event shape (one JSON object
per line / per webhook POST):

    {"seq": 7, "ts": 1754460000.1, "image": "team/app:latest",
     "blob": "sha256:…", "ruleset_digest": "sha256:…",
     "added": [finding…], "removed": [finding…], "changed": [finding…]}

Ordering: `seq` is assigned and the JSONL line written under one lock,
so the file's line order IS the sequence order — a consumer that tails
the file replays history exactly.

Delivery: the webhook emitter is a bounded FIFO drained by a single
worker thread (one worker = published order is POST order).  Each POST
rides RpcClient.call, inheriting the full rpc/client.py discipline —
jittered exponential backoff, Retry-After floors, the process-wide
retry budget, and the ``rpc.recv`` chaos seam — plus an outer per-event
attempt budget with its own backoff.  An event is only dropped after
that outer budget exhausts (counted + flight-captured); anything less
than total endpoint death delivers at least once, possibly more (the
endpoint must dedupe on `seq`).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.parse

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.ftypes import Secret, SecretFinding

DEFAULT_QUEUE_MAX = 256
DEFAULT_ATTEMPTS = 5
EMIT_BACKOFF_BASE_S = 0.1
EMIT_BACKOFF_CAP_S = 5.0


def _finding_key(f: SecretFinding) -> tuple:
    """Identity of a finding inside one blob: same rule at the same
    location is the "same" finding (its content may still change)."""
    return (f.rule_id, f.start_line, f.end_line)


def diff_findings(
    old: Secret | None, new: Secret | None
) -> tuple[list[dict], list[dict], list[dict]]:
    """(added, removed, changed) finding JSON between two verdicts for
    one blob.  `changed` = same (rule, span) identity, different body
    (e.g. the matched text moved under a rules update)."""
    old_map = {
        _finding_key(f): f for f in (old.findings if old else [])
    }
    new_map = {
        _finding_key(f): f for f in (new.findings if new else [])
    }
    added = [
        f.to_json() for k, f in new_map.items() if k not in old_map
    ]
    removed = [
        f.to_json() for k, f in old_map.items() if k not in new_map
    ]
    changed = [
        f.to_json()
        for k, f in new_map.items()
        if k in old_map and f.to_json() != old_map[k].to_json()
    ]
    return added, removed, changed


class WebhookEmitter:
    """At-least-once delivery of delta events to one HTTP endpoint."""

    sleep = staticmethod(time.sleep)  # test seam (mirrors RpcClient)

    def __init__(
        self,
        url: str,
        queue_max: int = DEFAULT_QUEUE_MAX,
        attempts: int = DEFAULT_ATTEMPTS,
        client=None,
        flight=None,
    ):
        from trivy_tpu_torch.rpc.client import RpcClient

        parts = urllib.parse.urlsplit(
            url if "://" in url else f"http://{url}"
        )
        self.path = parts.path or "/"
        self.url = url
        self.client = client or RpcClient(
            f"{parts.scheme}://{parts.netloc}", timeout_s=30.0
        )
        self.attempts = max(1, int(attempts))
        self.flight = flight
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_max))
        self._lock = lockcheck.make_lock("watch.webhook")
        # All owner: _lock.
        self.enqueued = 0
        self.delivered = 0
        self.retried = 0
        self.dropped_full = 0
        self.dropped_failed = 0
        self._worker = threading.Thread(
            target=self._drain_loop, name="watch-webhook", daemon=True
        )
        self._worker.start()

    def emit(self, event: dict) -> bool:
        """Queue one event; False = queue full (counted, captured)."""
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            with self._lock:
                self.dropped_full += 1
            self._capture(event, "watch-emit-queue-full")
            return False
        with self._lock:
            self.enqueued += 1
        return True

    def _drain_loop(self) -> None:
        while True:
            event = self._queue.get()
            if event is None:  # close() sentinel
                self._queue.task_done()
                return
            try:
                self._deliver(event)
            finally:
                self._queue.task_done()

    def _deliver(self, event: dict) -> None:
        """One event, at-least-once: the event is not surrendered until
        a POST succeeds or the outer attempt budget exhausts.  Each
        attempt is itself a full RpcClient.call retry loop, so injected
        rpc.recv resets/truncations are absorbed two layers deep."""
        last = ""
        for attempt in range(self.attempts):
            try:
                self.client.call(self.path, event)
                with self._lock:
                    self.delivered += 1
                return
            except Exception as e:
                last = f"{type(e).__name__}: {e}"
                with self._lock:
                    self.retried += 1
            if attempt + 1 < self.attempts:
                self.sleep(
                    min(
                        EMIT_BACKOFF_CAP_S,
                        EMIT_BACKOFF_BASE_S * (2**attempt),
                    )
                )
        with self._lock:
            self.dropped_failed += 1
        self._capture(event, f"watch-emit-failed: {last}")

    def _capture(self, event: dict, reason: str) -> None:
        if self.flight is None:
            return
        self.flight.capture(
            method="watch.emit",
            reason=reason[:200],
            trace_id=f"watch-seq-{event.get('seq', '?')}",
        )

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued event resolved (delivered or
        dropped); False on timeout."""
        deadline = time.monotonic() + timeout_s
        while self._queue.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self._queue.unfinished_tasks

    def close(self) -> None:
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "url": self.url,
                "queued": self._queue.qsize(),
                "enqueued": self.enqueued,
                "delivered": self.delivered,
                "retried": self.retried,
                "dropped_full": self.dropped_full,
                "dropped_failed": self.dropped_failed,
            }


class VerdictDeltaStream:
    """Delta computation + fan-out to the JSONL sink and the webhook.

    Per-blob previous verdicts live in a bounded map keyed by blob
    digest (content-addressed: the same blob under two images has one
    verdict history, which is also what the result cache says)."""

    def __init__(
        self,
        jsonl_path: str = "",
        emitter: WebhookEmitter | None = None,
        max_tracked_blobs: int = 4096,
        clock=time.time,
    ):
        self.jsonl_path = jsonl_path
        self.emitter = emitter
        self.max_tracked_blobs = max_tracked_blobs
        self._clock = clock
        self._lock = lockcheck.make_lock("watch.stream")
        # All owner: _lock.
        self._seq = 0
        self._prev: dict[str, Secret] = {}  # blob digest -> last verdict
        self.published = 0
        self.unchanged = 0
        self.jsonl_lines = 0

    def publish(
        self,
        image: str,
        blob_digest: str,
        new: Secret,
        ruleset_digest: str = "",
        old: Secret | None = None,
    ) -> dict | None:
        """Compute and ship the delta for one fresh verdict.  `old`
        overrides the tracked history (the sweeper passes the verdict
        it read under the OLD ruleset digest); None falls back to what
        this stream last saw for the blob.  Returns the event, or None
        when nothing changed (no event is emitted — an unchanged
        verdict is the steady state, not news)."""
        with self._lock:
            base = old if old is not None else self._prev.get(blob_digest)
            added, removed, changed = diff_findings(base, new)
            if base is not None and not (added or removed or changed):
                self.unchanged += 1
                self._remember(blob_digest, new)
                return None
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": round(self._clock(), 3),
                "image": image,
                "blob": blob_digest,
                "ruleset_digest": ruleset_digest,
                "added": added,
                "removed": removed,
                "changed": changed,
            }
            self._remember(blob_digest, new)
            self.published += 1
            # JSONL write under the seq lock: line order == seq order.
            if self.jsonl_path:
                with open(self.jsonl_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(event, sort_keys=True) + "\n")
                self.jsonl_lines += 1
        if self.emitter is not None:
            self.emitter.emit(event)
        return event

    def _remember(self, blob_digest: str, verdict: Secret) -> None:  # graftlint: holds(_lock)
        if (
            blob_digest not in self._prev
            and len(self._prev) >= self.max_tracked_blobs
        ):
            # Bounded: drop the oldest-inserted entry.  Losing history
            # for a blob only means its next verdict reports everything
            # as "added" — safe, and strictly bounded memory.
            self._prev.pop(next(iter(self._prev)))
        self._prev[blob_digest] = verdict

    def flush(self, timeout_s: float = 10.0) -> bool:
        if self.emitter is not None:
            return self.emitter.flush(timeout_s)
        return True

    def close(self) -> None:
        if self.emitter is not None:
            self.emitter.close()

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "seq": self._seq,
                "published": self.published,
                "unchanged": self.unchanged,
                "jsonl_path": self.jsonl_path,
                "jsonl_lines": self.jsonl_lines,
                "tracked_blobs": len(self._prev),
            }
        if self.emitter is not None:
            snap["webhook"] = self.emitter.snapshot()
        return snap
