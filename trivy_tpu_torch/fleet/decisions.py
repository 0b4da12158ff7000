"""Fleet routing decision audit: why did this request go to that member?

Every dispatch attempt the router makes records a structured decision
here — the digest key it hashed, the member it picked, *why* that member
(primary, or which spill rung moved past the one before it), the
attempt's outcome, and whether the serving host reported the digest as
already resident (affinity hit) — so "why is member B serving digest X"
is answerable from a running client instead of reconstructed from logs.

Process-global on purpose, mirroring obs/gatelog.py: routers are built
per engine, but the question ("where did THIS process send its
traffic") is per-process.  Consumers:

- `FleetRouter.report()` (and through it `GET /debug/fleet` on hosts
  that also run a router) serves `records()` newest-first;
- metrics collect hooks fold `tallies()` into
  `trivy_tpu_fleet_route_total{member,reason}` and
  `affinity_tallies()` into `trivy_tpu_fleet_affinity_total{outcome}`
  by delta;
- the bench's affinity-hit-rate metric is computed from
  `affinity_tallies()` directly.

Reasons are a bounded enum (metric-label safe): `primary` (the digest's
rendezvous owner), `spill-health` (an earlier candidate was not
admitted — down/draining/probe-busy), `spill-reject` (an earlier
candidate answered 503 or a long-Retry-After 429), `spill-error` (an
earlier candidate's connection failed).  Outcomes: `ok`, `reject`, `error`,
`skip` (health refused the candidate without a request).  Affinity:
`hit`, `miss`, `unknown` (the host predates the fleet headers or the
request never completed).
"""

from __future__ import annotations

import time
from collections import deque

from trivy_tpu_torch import lockcheck

DEFAULT_CAPACITY = 256

_LOCK = lockcheck.make_lock("fleet.decisions")
_RING: deque = deque(maxlen=DEFAULT_CAPACITY)  # owner: _LOCK
_TALLIES: dict[tuple[str, str], int] = {}  # owner: _LOCK (survives eviction)
_AFFINITY: dict[str, int] = {}  # owner: _LOCK (hit/miss/unknown)
_SEQ = 0  # owner: _LOCK


def record(
    *,
    digest: str,
    member: str,
    reason: str,
    outcome: str,
    affinity: str = "unknown",
    attempt: int = 0,
    error: str = "",
) -> dict:
    """Append one routing decision; returns the stored record."""
    global _SEQ
    rec: dict = {
        "captured_at": time.time(),  # wall timestamp, not a duration
        "digest": digest,
        "member": member,
        "reason": reason,
        "outcome": outcome,
        "affinity": affinity,
        "attempt": attempt,
    }
    if error:
        rec["error"] = error
    with _LOCK:
        _SEQ += 1
        rec["seq"] = _SEQ
        _RING.append(rec)
        key = (member, reason)
        _TALLIES[key] = _TALLIES.get(key, 0) + 1
        if outcome == "ok":
            _AFFINITY[affinity] = _AFFINITY.get(affinity, 0) + 1
    return rec


def records(limit: int | None = None) -> list[dict]:
    """Newest-first decision records (shallow copies)."""
    with _LOCK:
        out = [dict(r) for r in reversed(_RING)]
    return out[:limit] if limit is not None else out


def last() -> dict | None:
    with _LOCK:
        return dict(_RING[-1]) if _RING else None


def tallies() -> dict[tuple[str, str], int]:
    """(member, reason) -> decision count since process start.  Counts
    are monotonic and survive ring eviction — safe to export as a
    counter family (member names come from static fleet config, a
    bounded set)."""
    with _LOCK:
        return dict(_TALLIES)


def affinity_tallies() -> dict[str, int]:
    """hit/miss/unknown counts over *completed* requests."""
    with _LOCK:
        return dict(_AFFINITY)


def affinity_hit_rate() -> float | None:
    """hits / (hits + misses), or None before any attributed request."""
    with _LOCK:
        hits = _AFFINITY.get("hit", 0)
        misses = _AFFINITY.get("miss", 0)
    total = hits + misses
    return (hits / total) if total else None


def clear() -> None:
    """Reset ring, tallies, and sequence (tests)."""
    global _SEQ
    with _LOCK:
        _RING.clear()
        _TALLIES.clear()
        _AFFINITY.clear()
        _SEQ = 0
