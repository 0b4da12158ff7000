"""Process-global cache accounting: requests per tier, evictions, events.

The result cache is consulted from CLI scans (ImageArtifact.inspect),
the serve scheduler (pre-ticket hit demux), and background write-behind
threads alike, so the question "what is THIS process's hit rate" is
per-process, not per-cache-instance — the gatelog pattern (obs/gatelog.py).
Consumers:

- `GET /debug/cache` serves :func:`snapshot`;
- the server's collect hook folds :func:`request_tallies` into
  `trivy_tpu_cache_requests_total{tier,outcome}` and
  :func:`eviction_tallies` into
  `trivy_tpu_cache_evictions_total{reason}`;
- the flight recorder embeds :func:`snapshot` in captures;
- bench/cache-smoke assert warm-pass deltas (miss == 0,
  `layer_analysis` == 0, `device_dispatch` == 0) from before/after
  snapshots.

Labels are bounded enums (metric-safe).  Tiers: `memory`, `fs`,
`redis`, `s3`, `remote`, `results` (the aggregated ScanResultCache
verdict), `artifact` (the MissingBlobs diff in the image walk).
Outcomes: `hit`, `miss`, `error` (tier degraded, scan continued),
`negative` (served from a negative entry inside its TTL).  Eviction
reasons: `corrupt` (undecodable JSON self-healed off disk),
`stale-schema` (BLOB_JSON_SCHEMA_VERSION mismatch), `ttl`,
`negative-expired`, `capacity`.

Counts are monotonic since process start — safe to export as counter
families via delta collect hooks.

Copied from `trivy_tpu/cache/stats.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from trivy_tpu_torch import lockcheck

_LOCK = lockcheck.make_lock("cache.stats")
_REQUESTS: dict[tuple[str, str], int] = {}  # owner: _LOCK
_EVICTIONS: dict[str, int] = {}  # owner: _LOCK
_EVENTS: dict[str, int] = {}  # owner: _LOCK

TIERS = ("memory", "fs", "redis", "s3", "remote", "results", "artifact")
OUTCOMES = ("hit", "miss", "error", "negative")
EVICTION_REASONS = (
    "corrupt", "stale-schema", "ttl", "negative-expired", "capacity",
)


def record_request(tier: str, outcome: str, n: int = 1) -> None:
    """Count one (or n) cache lookups against a tier with its outcome."""
    if n <= 0:
        return
    key = (tier, outcome)
    with _LOCK:
        _REQUESTS[key] = _REQUESTS.get(key, 0) + n


def record_eviction(reason: str, n: int = 1) -> None:
    """Count a self-heal/expiry eviction by bounded reason."""
    if n <= 0:
        return
    with _LOCK:
        _EVICTIONS[reason] = _EVICTIONS.get(reason, 0) + n


def event(name: str, n: int = 1) -> None:
    """Generic monotonic event counter (`layer_analysis`,
    `device_dispatch`, `write_behind_flush`...) — the signals the
    cold-vs-warm assertions in bench_cache / cache-smoke diff."""
    if n <= 0:
        return
    with _LOCK:
        _EVENTS[name] = _EVENTS.get(name, 0) + n


def request_tallies() -> dict[tuple[str, str], int]:
    """(tier, outcome) -> count since process start (monotonic)."""
    with _LOCK:
        return dict(_REQUESTS)


def eviction_tallies() -> dict[str, int]:
    """reason -> count since process start (monotonic)."""
    with _LOCK:
        return dict(_EVICTIONS)


def events() -> dict[str, int]:
    with _LOCK:
        return dict(_EVENTS)


def snapshot() -> dict:
    """JSON-shaped view for /debug/cache and flight captures."""
    with _LOCK:
        requests = [
            {"tier": t, "outcome": o, "count": c}
            for (t, o), c in sorted(_REQUESTS.items())
        ]
        evictions = [
            {"reason": r, "count": c} for r, c in sorted(_EVICTIONS.items())
        ]
        ev = dict(_EVENTS)
    hits = sum(r["count"] for r in requests if r["outcome"] == "hit")
    misses = sum(r["count"] for r in requests if r["outcome"] == "miss")
    total = hits + misses
    return {
        "requests": requests,
        "evictions": evictions,
        "events": ev,
        "hits": hits,
        "misses": misses,
        "hit_rate": (hits / total) if total else None,
    }


def clear() -> None:
    """Reset all tallies (tests/bench isolation)."""
    with _LOCK:
        _REQUESTS.clear()
        _EVICTIONS.clear()
        _EVENTS.clear()
