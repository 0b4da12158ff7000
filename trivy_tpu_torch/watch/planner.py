"""Delta planner: change records in, novel-blob scan tickets out.

The economics the watch plane exists for: at steady state almost every
change event resolves to blobs the fleet has already scanned, so the
planner's job is to prove that *before* any bytes move.  Per record:

1. resolve the image's blob (layer) digests — `resolve_fn(record)`
   returns ``[(blob_digest, fetch_fn), ...]`` with fetch deferred, so
   resolution costs manifest reads only;
2. narrow with the artifact cache's `missing_blobs` diff (the
   MissingBlobs seam: blobs whose analysis the cache already holds);
3. probe the result cache's `exists()` for every configured program —
   only a blob missing a verdict under the ACTIVE ruleset digest is
   novel;
4. fetch + dispatch only the novel blobs through `scan_fn` (the serve
   scheduler on a daemon, a local engine in the CLI), store verdicts,
   and hand each (record, blob, verdict) to `on_verdict` for the
   delta stream.

A re-pushed identical image therefore costs: one manifest resolve, one
`missing_blobs` round, N existence probes — and zero fetches, zero
device dispatches, zero analyzer runs (the BENCH_DELTA acceptance
gate).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.watch.sources import ChangeRecord


class ContentStore:
    """Bounded digest->bytes LRU holding recently fetched blob contents.

    The re-verification sweeper needs the *bytes* of previously scanned
    blobs to re-verdict them under a new ruleset; refetching every blob
    from its registry would turn each `rules push` into a full image
    pull.  The planner feeds every fetch through here, so the sweep's
    working set is usually resident.  Strictly bounded (LRU by bytes):
    blobs evicted before a sweep are simply reported as missing-content
    and skipped."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max(1, int(max_bytes))
        self._lock = lockcheck.make_lock("watch.content_store")
        self._data: OrderedDict[str, bytes] = OrderedDict()  # owner: _lock
        self._bytes = 0  # owner: _lock
        self.evictions = 0  # owner: _lock

    def put(self, digest: str, data: bytes) -> None:
        if len(data) > self.max_bytes:
            return  # larger than the whole store: not worth caching
        with self._lock:
            prev = self._data.pop(digest, None)
            if prev is not None:
                self._bytes -= len(prev)
            self._data[digest] = data
            self._bytes += len(data)
            while self._bytes > self.max_bytes and self._data:
                _, old = self._data.popitem(last=False)
                self._bytes -= len(old)
                self.evictions += 1

    def get(self, digest: str) -> bytes | None:
        with self._lock:
            data = self._data.get(digest)
            if data is not None:
                self._data.move_to_end(digest)
            return data

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "blobs": len(self._data),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "evictions": self.evictions,
            }


class DeltaPlanner:
    """Turn change records into the minimum set of device dispatches."""

    def __init__(
        self,
        result_cache,
        scan_fn: Callable[[list[tuple[str, bytes]]], list],
        ruleset_digest_fn: Callable[[], str],
        resolve_fn: Callable[[ChangeRecord], list],
        artifact_cache=None,
        content_store: ContentStore | None = None,
        programs: tuple[str, ...] = ("secret",),
        on_verdict=None,
    ):
        self.result_cache = result_cache
        self.scan_fn = scan_fn
        self.ruleset_digest_fn = ruleset_digest_fn
        self.resolve_fn = resolve_fn
        self.artifact_cache = artifact_cache
        self.content_store = content_store
        self.programs = tuple(programs) or ("secret",)
        # on_verdict(record, blob_digest, verdict): the stream seam.
        self.on_verdict = on_verdict
        self._lock = lockcheck.make_lock("watch.planner")
        # All owner: _lock.
        self.events_seen = 0
        self.resolve_errors = 0
        self.blobs_probed = 0
        self.blobs_cached = 0
        self.blobs_novel = 0
        self.dispatches = 0  # device dispatches (novel blobs scanned)
        self.dispatch_errors = 0
        self.fetch_bytes = 0

    def _is_novel(self, blob_digest: str, ruleset_digest: str) -> bool:
        """Novel = missing a cached verdict for ANY configured program.
        (One program's hit must not mask another's miss — a license
        verdict never answers a secret probe and vice versa.)"""
        return not all(
            self.result_cache.exists(blob_digest, ruleset_digest, pid)
            for pid in self.programs
        )

    def plan(self, records: list[ChangeRecord]) -> dict:
        """Process one poll's records; returns the cycle summary."""
        summary = {
            "events": len(records),
            "blobs": 0,
            "novel": 0,
            "cached": 0,
            "dispatched": 0,
            "errors": 0,
        }
        for record in records:
            out = self.handle(record)
            summary["blobs"] += out["blobs"]
            summary["novel"] += out["novel"]
            summary["cached"] += out["cached"]
            summary["dispatched"] += out["dispatched"]
            summary["errors"] += out["errors"]
        return summary

    def handle(self, record: ChangeRecord) -> dict:
        """One change record end to end: resolve, probe, dispatch."""
        with self._lock:
            self.events_seen += 1
        out = {"blobs": 0, "novel": 0, "cached": 0, "dispatched": 0,
               "errors": 0}
        try:
            resolved = self.resolve_fn(record)
        except Exception:
            with self._lock:
                self.resolve_errors += 1
            out["errors"] += 1
            return out
        digest = self.ruleset_digest_fn()
        blob_digests = [d for d, _ in resolved]
        out["blobs"] = len(blob_digests)
        # Artifact-level fast path: the MissingBlobs diff narrows to
        # blobs whose analysis the artifact cache lacks, and marks this
        # manifest digest as seen for the next identical push.
        if self.artifact_cache is not None and record.digest:
            try:
                self.artifact_cache.missing_blobs(
                    record.digest, blob_digests
                )
            except Exception:
                pass  # advisory only; the verdict probes decide
        novel: list[tuple[str, Callable[[], bytes]]] = []
        for blob_digest, fetch_fn in resolved:
            with self._lock:
                self.blobs_probed += 1
            if self._is_novel(blob_digest, digest):
                novel.append((blob_digest, fetch_fn))
            else:
                with self._lock:
                    self.blobs_cached += 1
        out["cached"] = out["blobs"] - len(novel)
        out["novel"] = len(novel)
        with self._lock:
            self.blobs_novel += len(novel)
        if not novel:
            return out
        # Fetch only what must be scanned.  Paths are the blob digests
        # themselves: stable names keep stored verdicts byte-identical
        # regardless of which image/tag surfaced the blob.
        items: list[tuple[str, bytes]] = []
        fetched: list[str] = []
        for blob_digest, fetch_fn in novel:
            try:
                data = fetch_fn()
            except Exception:
                out["errors"] += 1
                continue
            if self.content_store is not None:
                self.content_store.put(blob_digest, data)
            with self._lock:
                self.fetch_bytes += len(data)
            items.append((blob_digest, data))
            fetched.append(blob_digest)
        if not items:
            return out
        try:
            verdicts = self.scan_fn(items)
        except Exception:
            with self._lock:
                self.dispatch_errors += 1
            out["errors"] += 1
            return out
        with self._lock:
            self.dispatches += len(items)
        out["dispatched"] = len(items)
        for blob_digest, verdict in zip(fetched, verdicts):
            # Idempotent when the scheduler already stored it (daemon
            # path); load-bearing for the CLI's local-engine path.
            self.result_cache.put(blob_digest, digest, verdict)
            if self.on_verdict is not None:
                self.on_verdict(record, blob_digest, verdict)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            probed = self.blobs_probed
            cached = self.blobs_cached
            return {
                "events_seen": self.events_seen,
                "resolve_errors": self.resolve_errors,
                "blobs_probed": probed,
                "blobs_cached": cached,
                "blobs_novel": self.blobs_novel,
                "dispatches": self.dispatches,
                "dispatch_errors": self.dispatch_errors,
                "fetch_bytes": self.fetch_bytes,
                "hit_rate": (cached / probed) if probed else None,
            }
