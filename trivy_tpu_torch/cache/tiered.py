"""Tiered cache chain: memory -> FS -> remote, degrade-don't-fail.

The fleet economics: at registry scale
most image layers are shared, so the dominant throughput metric is cache
hit rate, and the cache must be consultable from a hot serve path
without ever becoming a new failure mode.  This module composes the
existing backends (store.py MemoryCache/FSCache, redis.py, s3.py) into
one ArtifactCache with the production behaviors the single backends
lack:

- **Reads walk the chain** front to back; a hit in a later tier is
  promoted into every earlier tier so the next probe stops sooner.
- **Errors degrade, never fail.**  Each tier carries a retry budget
  (default 8).  A tier that raises is skipped for that operation, its
  budget decremented, and the walk continues with the next tier; a tier
  whose budget is exhausted is taken out of rotation entirely
  (`degraded` in the snapshot).  A full remote outage therefore costs at
  most `error_budget` slow probes process-wide, after which the chain is
  local-only — no scan ever fails because a cache tier did.
- **Writes are tiered too**: local tiers (memory/fs) are written
  synchronously; remote tiers (redis/s3/remote) are fed by an async
  write-behind queue + daemon thread so a slow remote never sits on the
  scan path.  `flush()` drains the queue (tests, close()).
- **Single-flight dedup**: `single_flight(key, fn)` collapses concurrent
  misses on one key into one execution of `fn`; the serve scheduler uses
  it so N simultaneous scans of a novel blob compute once.
- **Negative-entry TTL**: a miss is remembered for `negative_ttl_s`
  (default 30s) and answered locally without re-probing remote tiers —
  registry-scale scans hammer the same novel blob id many times in the
  window before its result lands.
- **Chaos seams**: every tier read crosses ``faults.fire("cache.get")``
  and every tier write ``faults.fire("cache.put")``, so chaos profiles
  (TRIVY_TPU_FAULTS) can prove the degrade-don't-fail contract in CI.

Every probe lands in the process-global tallies (cache/stats.py) as
`trivy_tpu_cache_requests_total{tier,outcome}`.

Copied from `trivy_tpu/cache/tiered.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable

from trivy_tpu_torch import faults, lockcheck
from trivy_tpu_torch.atypes import ArtifactInfo, BlobInfo
from trivy_tpu_torch.cache import stats as cache_stats
from trivy_tpu_torch.cache.store import ArtifactCache

DEFAULT_ERROR_BUDGET = 8
DEFAULT_NEGATIVE_TTL_S = 30.0
REMOTE_TIER_NAMES = ("redis", "s3", "remote")
_WRITE_QUEUE_MAX = 1024


def tier_name(backend: ArtifactCache) -> str:
    """Bounded metric label for a backend (class-name heuristic, with an
    explicit `cache_tier_name` attribute as the override)."""
    explicit = getattr(backend, "cache_tier_name", "")
    if explicit:
        return explicit
    cls = type(backend).__name__.lower()
    for name in ("memory", "fs", "redis", "s3", "remote"):
        if cls.startswith(name):
            return name
    return "remote"


class _Flight:
    """One in-progress single-flight computation."""

    __slots__ = ("done", "result", "ok")

    def __init__(self):
        self.done = threading.Event()
        self.result: object = None
        self.ok = False


class _Tier:
    """One chain link: backend + retry budget (budget/error fields are
    mutated under the owning TieredCache lock).  `io_lock` serializes
    backend calls: the write-behind thread and scan threads would
    otherwise interleave on a remote backend's single socket."""

    __slots__ = ("backend", "name", "budget", "errors", "last_error",
                 "io_lock")

    def __init__(self, backend: ArtifactCache, name: str, budget: int):
        self.backend = backend
        self.name = name
        self.budget = budget
        self.errors = 0
        self.last_error = ""
        self.io_lock = lockcheck.make_lock(f"cache.tier.{name}")

    @property
    def degraded(self) -> bool:
        return self.errors >= self.budget


class TieredCache(ArtifactCache):
    """ArtifactCache over an ordered tier chain (fastest first)."""

    def __init__(
        self,
        tiers: Iterable[ArtifactCache],
        *,
        error_budget: int = DEFAULT_ERROR_BUDGET,
        negative_ttl_s: float = DEFAULT_NEGATIVE_TTL_S,
        write_behind: bool = True,
    ):
        backends = list(tiers)
        if not backends:
            raise ValueError("TieredCache needs at least one tier")
        self._lock = lockcheck.make_lock("cache.tiered")
        self._tiers = [
            _Tier(b, tier_name(b), error_budget) for b in backends
        ]
        self._negative_ttl_s = negative_ttl_s
        self._negative: dict[str, float] = {}  # owner: _lock
        self._inflight: dict[str, _Flight] = {}  # owner: _lock
        self._dedup_hits = 0  # owner: _lock
        self._wb_queue: queue.Queue | None = None
        self._wb_thread: threading.Thread | None = None
        self._wb_dropped = 0  # owner: _lock
        self._closed = False
        if write_behind and any(
            t.name in REMOTE_TIER_NAMES for t in self._tiers
        ):
            self._wb_queue = queue.Queue(maxsize=_WRITE_QUEUE_MAX)
            self._wb_thread = threading.Thread(
                target=self._write_behind_loop,
                name="cache-write-behind",
                daemon=True,
            )
            self._wb_thread.start()

    @property
    def tiers(self) -> list[_Tier]:
        """The ordered tier chain (read-only view for tests and debug
        surfaces; mutating it is not supported)."""
        return list(self._tiers)

    # -- tier walk ---------------------------------------------------------

    def _live_tiers(self) -> list[_Tier]:
        with self._lock:
            return [t for t in self._tiers if not t.degraded]

    def _tier_error(self, tier: _Tier, op: str, e: Exception) -> None:
        cache_stats.record_request(tier.name, "error")
        with self._lock:
            tier.errors += 1
            tier.last_error = f"{op}: {type(e).__name__}: {e}"

    def _get(self, op: str, getter: Callable[[ArtifactCache], object]):
        """Walk tiers for a read; returns (value, hit_tier_index)."""
        hit_val = None
        hit_idx = -1
        tiers = self._live_tiers()
        for i, tier in enumerate(tiers):
            try:
                faults.fire("cache.get")
                with tier.io_lock:
                    val = getter(tier.backend)
            except Exception as e:
                # Degrade to the next tier; the cache must never fail
                # the scan (the whole point of the retry budget).
                self._tier_error(tier, op, e)
                continue
            if val is not None:
                cache_stats.record_request(tier.name, "hit")
                hit_val, hit_idx = val, i
                break
            cache_stats.record_request(tier.name, "miss")
        return hit_val, hit_idx, tiers

    def _promote(
        self,
        tiers: list[_Tier],
        hit_idx: int,
        putter: Callable[[ArtifactCache], None],
    ) -> None:
        """Copy a hit into every tier in front of the one that served it."""
        for tier in tiers[:hit_idx]:
            try:
                faults.fire("cache.put")
                with tier.io_lock:
                    putter(tier.backend)
            except Exception as e:
                self._tier_error(tier, "promote", e)

    def _put(self, key: str, putter: Callable[[ArtifactCache], None]) -> None:
        """Synchronous local writes; remote tiers go through write-behind."""
        with self._lock:
            self._negative.pop(key, None)
        for tier in self._live_tiers():
            if tier.name in REMOTE_TIER_NAMES and self._wb_queue is not None:
                try:
                    self._wb_queue.put_nowait((tier, putter))
                except queue.Full:
                    with self._lock:
                        self._wb_dropped += 1
                continue
            try:
                faults.fire("cache.put")
                with tier.io_lock:
                    putter(tier.backend)
            except Exception as e:
                self._tier_error(tier, "put", e)

    def _write_behind_loop(self) -> None:
        assert self._wb_queue is not None
        while True:
            item = self._wb_queue.get()
            if item is None:  # close() sentinel
                self._wb_queue.task_done()
                return
            tier, putter = item
            if not tier.degraded:
                try:
                    faults.fire("cache.put")
                    with tier.io_lock:
                        putter(tier.backend)
                    cache_stats.event("write_behind_flush")
                except Exception as e:
                    self._tier_error(tier, "write-behind", e)
            self._wb_queue.task_done()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until queued write-behind work drains (or timeout)."""
        q = self._wb_queue
        if q is None:
            return True
        deadline = time.monotonic() + timeout_s
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        return not q.unfinished_tasks

    # -- negative entries --------------------------------------------------

    def _negative_hit(self, key: str) -> bool:
        if self._negative_ttl_s <= 0:
            return False
        now = time.monotonic()
        with self._lock:
            exp = self._negative.get(key)
            if exp is None:
                return False
            if now >= exp:
                del self._negative[key]
                expired = True
            else:
                expired = False
        if expired:
            cache_stats.record_eviction("negative-expired")
            return False
        return True

    def _remember_miss(self, key: str) -> None:
        if self._negative_ttl_s <= 0:
            return
        with self._lock:
            self._negative[key] = time.monotonic() + self._negative_ttl_s

    # -- ArtifactCache interface -------------------------------------------

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self._put("a::" + artifact_id, lambda b: b.put_artifact(artifact_id, info))

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self._put("b::" + blob_id, lambda b: b.put_blob(blob_id, info))

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        if self._negative_hit("a::" + artifact_id):
            cache_stats.record_request("results", "negative")
            return None
        val, idx, tiers = self._get(
            "get_artifact", lambda b: b.get_artifact(artifact_id)
        )
        if val is None:
            self._remember_miss("a::" + artifact_id)
            return None
        self._promote(tiers, idx, lambda b: b.put_artifact(artifact_id, val))
        return val

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        if self._negative_hit("b::" + blob_id):
            cache_stats.record_request("results", "negative")
            return None
        val, idx, tiers = self._get("get_blob", lambda b: b.get_blob(blob_id))
        if val is None:
            self._remember_miss("b::" + blob_id)
            return None
        self._promote(tiers, idx, lambda b: b.put_blob(blob_id, val))
        return val

    def exists(self, blob_id: str) -> bool:
        if self._negative_hit("b::" + blob_id):
            cache_stats.record_request("results", "negative")
            return False
        # Short-circuit on the first tier that answers: a memory-tier hit
        # must never touch remote tiers — watch-planner novelty probes
        # come in bulk, and letting them fall through to a flaky redis
        # tier burns its error budget on pure existence checks.
        for tier in self._live_tiers():
            try:
                faults.fire("cache.get")
                with tier.io_lock:
                    present = tier.backend.exists(blob_id)
                if present:
                    cache_stats.record_request(tier.name, "hit")
                    return True
                cache_stats.record_request(tier.name, "miss")
            except Exception as e:
                self._tier_error(tier, "exists", e)
        return False

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        ids = list(blob_ids)
        for tier in self._live_tiers():
            try:
                with tier.io_lock:
                    tier.backend.delete_blobs(ids)
            except Exception as e:
                self._tier_error(tier, "delete_blobs", e)

    def clear(self) -> None:
        for tier in self._live_tiers():
            try:
                with tier.io_lock:
                    tier.backend.clear()
            except Exception as e:
                self._tier_error(tier, "clear", e)
        with self._lock:
            self._negative.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self._wb_queue is not None:
            self._wb_queue.put(None)
            if self._wb_thread is not None:
                self._wb_thread.join(timeout=5.0)
        for tier in self._tiers:
            try:
                tier.backend.close()
            except Exception:
                pass  # already tearing down; backend sockets may be gone

    # -- single-flight -----------------------------------------------------

    def single_flight(self, key: str, fn: Callable[[], object]):
        """Collapse concurrent computations of `key`: the first caller
        (the leader) runs `fn`; callers that arrive while it is in
        flight block and share its result.  A leader that raises
        propagates to itself only — followers see the failed flight and
        compute solo (the retry is theirs to make)."""
        with self._lock:
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight()
                self._inflight[key] = flight
                leader = True
            else:
                self._dedup_hits += 1
                leader = False
        if not leader:
            flight.done.wait()
            if flight.ok:
                return flight.result
            return fn()
        try:
            flight.result = fn()
            flight.ok = True
            return flight.result
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            flight.done.set()

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            tiers = [
                {
                    "name": t.name,
                    "errors": t.errors,
                    "budget": t.budget,
                    "degraded": t.degraded,
                    "last_error": t.last_error,
                }
                for t in self._tiers
            ]
            negative = len(self._negative)
            dedup = self._dedup_hits
            dropped = self._wb_dropped
        q = self._wb_queue
        return {
            "tiers": tiers,
            "negative_entries": negative,
            "negative_ttl_s": self._negative_ttl_s,
            "single_flight_dedup": dedup,
            "write_behind": {
                "enabled": q is not None,
                "queued": (q.unfinished_tasks if q is not None else 0),
                "dropped": dropped,
            },
        }
