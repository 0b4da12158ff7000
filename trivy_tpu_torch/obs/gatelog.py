"""Hybrid-gate decision audit: why did this process verify on DFA/device?

Copied from `trivy_tpu/obs/gatelog.py` (the port imports nothing from the
JAX package).  In the port, `engine/hybrid.py` records the verify gate and
`engine/device.py` the megakernel gate here; the server consumers named
below come with the port's server.

Every hybrid-gate resolution (engine/hybrid.py) records its decision
here: the requested and chosen backend and the reason.  The megakernel
gate (engine/device.py) prices the link and records the measured link
terms (`engine/link.py` `probe_link`), the post-codec effective rate the
cost model priced (`effective_link_rate`), the thresholds it was held
against and the margin by which it won, so "why did the megakernel stay
off" is answerable from a running process instead of re-derived by hand
from bench output.

The log is process-global on purpose: engines are constructed from CLI
scans, server scheduler lanes, and reload threads alike, and the
question ("what did the gate see on THIS host") is per-process, not
per-registry.  Consumers:

- `GET /debug/gate` serves `records()` newest-first;
- the server's collect hook folds `tallies()` into
  `trivy_tpu_hybrid_gate_decision_total{backend,reason}` and the latest
  margin into `trivy_tpu_hybrid_gate_margin`;
- the flight recorder embeds `records()` in breach captures, so an
  incident shows the gate state that routed it.

Reasons are a bounded enum (metric-label safe): `cuda` (`auto` on a CUDA
device, which verifies fused unpriced), `no-device`, `forced`,
`mega-wide` and `mega-narrow` (the megakernel gate's priced verdict — the
record carries `profile`/`devices`), `fallback`, `breaker` (a runtime
circuit-breaker transition re-routing batches — see engine/breaker.py and
the serve scheduler's failure domains).

Backends are likewise bounded: `dfa`, `device` (legacy flag-map
stream), `fused` (device-resident verify — lane verdicts resolve
on-device and only a packed keep-mask crosses the link; see
engine/nfa_device.py), `auto`.  The serve scheduler's degraded ladder
steps fused -> legacy-device -> host-DFA, each rung visible here and in
`/debug/gate`.
"""

from __future__ import annotations

import time
from collections import deque

from trivy_tpu_torch import lockcheck

DEFAULT_CAPACITY = 256

_LOCK = lockcheck.make_lock("obs.gatelog")
_RING: deque = deque(maxlen=DEFAULT_CAPACITY)  # owner: _LOCK
_TALLIES: dict[tuple[str, str], int] = {}  # owner: _LOCK (survives eviction)
_SEQ = 0  # owner: _LOCK


def record(
    *,
    requested: str,
    backend: str,
    reason: str,
    profile: str | None = None,
    devices: int | None = None,
    link_mb_per_sec: float | None = None,
    link_rtt_s: float | None = None,
    h2d_ratio: float | None = None,
    d2h_ratio: float | None = None,
    eff_mb_per_sec: float | None = None,
    eff_threshold_mb_per_sec: float | None = None,
    rtt_threshold_s: float | None = None,
    codec: str | None = None,
    margin: float | None = None,
    error: str = "",
) -> dict:
    """Append one gate decision; returns the stored record.

    `margin` is signed distance from the flip point (positive = the link
    cleared the device bar); None when the decision never priced the link
    (no device, forced mode).
    """
    global _SEQ
    rec: dict = {
        "captured_at": time.time(),  # wall timestamp, not a duration
        "requested": requested,
        "backend": backend,
        "reason": reason,
        "margin": margin,
    }
    if profile is not None:
        rec["profile"] = profile
    if devices is not None:
        rec["devices"] = devices
    if link_mb_per_sec is not None:
        rec["link"] = {
            "mb_per_sec": link_mb_per_sec,
            "rtt_s": link_rtt_s,
            "h2d_ratio": h2d_ratio,
            "d2h_ratio": d2h_ratio,
            "eff_mb_per_sec": eff_mb_per_sec,
            "codec": codec,
        }
    if eff_threshold_mb_per_sec is not None:
        rec["thresholds"] = {
            "eff_mb_per_sec": eff_threshold_mb_per_sec,
            "rtt_s": rtt_threshold_s,
        }
    if error:
        rec["error"] = error
    with _LOCK:
        _SEQ += 1
        rec["seq"] = _SEQ
        _RING.append(rec)
        key = (backend, reason)
        _TALLIES[key] = _TALLIES.get(key, 0) + 1
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
    """(backend, reason) -> decision count since process start.  Counts
    are monotonic and survive ring eviction — safe to export as a
    counter family."""
    with _LOCK:
        return dict(_TALLIES)


def last_margin() -> float | None:
    """Margin of the newest decision that priced the link, or None."""
    with _LOCK:
        for rec in reversed(_RING):
            if rec.get("margin") is not None:
                return rec["margin"]
    return None


def clear() -> None:
    """Reset ring, tallies, and sequence (tests)."""
    global _SEQ
    with _LOCK:
        _RING.clear()
        _TALLIES.clear()
        _SEQ = 0
