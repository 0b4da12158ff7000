"""Process-global device-memory ledger: raw HBM truth + attributed truth.

Every top ROADMAP item (device-resident hit rows, mesh sharding, resident
ruleset/content caches) turns on one question the observatory could not
answer before this module: *what is in HBM right now, who put it there,
and how close are we to the edge?*  Two complementary truths:

  raw         per-device usage/peak/limit sampled from the CUDA caching
              allocator (``cuda_stats``: ``torch.cuda.memory_stats()``
              and ``torch.cuda.mem_get_info()``).  Guarded — the CPU has
              no allocator stats, so the ledger keeps working from
              registrations alone and ``pressure()`` reports its source.
  attributed  a registration ledger: every long-lived device allocation
              (resident ruleset slots, `ResidentChunkCache` entries,
              pipeline staging buffers, verify-stream tensor sets,
              compiled-ruleset NFA tensors) calls
              ``track(component, nbytes)`` and holds the returned handle;
              ``release()``/GC of the owner removes the bytes.  The
              per-device, per-component sums are exact by construction —
              `/debug/memory` reports both sides and their residual.

The ledger is process-global for the same reason the device-phase sample
queue is (obs/metrics.py): allocations happen in engine code that owns no
registry, while exposition is per-server.  Servers bridge the two with
``register_collectors(registry)``, which exports

  trivy_tpu_device_hbm_bytes{device,component}   attributed bytes (plus a
                                                 ``_unattributed`` series
                                                 for the raw residual)
  trivy_tpu_device_hbm_peak_bytes{device}        raw peak when the backend
                                                 reports one, else the
                                                 attributed high-water mark
  trivy_tpu_hbm_pressure                         used/limit fraction the
                                                 admission watermarks act on

Tracking is off by default and costs one predicate + a shared no-op
handle when off — the same pattern as ``device_phase`` — so the scan path
pays one predicate a call site with memwatch compiled in.  Servers
call ``enable()``; ``TRIVY_TPU_MEMWATCH=1`` forces it on for ad-hoc runs.

Copied from `trivy_tpu/obs/memwatch.py`, with the JAX sampler replaced by
``cuda_stats``, the default provider (``set_stats_provider(None)``
restores it after a test or bench injected another).

Thread-safety: one leaf lock guards the ledger; the stats provider is
always called *outside* it (a test provider may legitimately read the
ledger back).  ``ruleset_digest(digest)`` is a contextvar scope: track()
calls inside it inherit the digest tag, which is how the resident pool
reconciles its manifest byte *estimates* against measured engine
allocations without threading a digest through every engine layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import weakref
from typing import Callable

from trivy_tpu_torch import lockcheck

_LOCK = lockcheck.make_lock("obs.memwatch")
_enabled = os.environ.get("TRIVY_TPU_MEMWATCH", "") == "1"
_seq = 0  # owner: _LOCK
_allocs: dict[int, "_Allocation"] = {}  # owner: _LOCK
# Attributed high-water mark per device, maintained incrementally so the
# peak survives releases.  owner: _LOCK
_attr_peak: dict[str, int] = {}
# Injected in tests/bench to fake an allocator; None = the real
# cuda_stats sampler below.
_stats_provider: Callable[[], dict] | None = None
# When the backend reports no bytes_limit (CPU), pressure() can still run
# in attributed mode against this explicit budget (0 = no budget known).
_attr_limit = 0
_default_device: str | None = None  # lazily resolved, cached


class _NoopHandle:
    """Shared do-nothing handle returned while tracking is off (the
    `_NOOP_PHASE` pattern: one predicate, zero allocation, on the hot
    path)."""

    __slots__ = ()
    nbytes = 0
    component = ""
    device = ""
    digest = ""

    def resize(self, nbytes: int) -> None:
        pass

    def release(self) -> None:
        pass


NOOP_HANDLE = _NoopHandle()

_digest_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "trivy_tpu_memwatch_digest", default=""
)


class _Allocation:
    """One tracked long-lived device allocation; release is idempotent."""

    __slots__ = ("seq", "component", "device", "digest", "nbytes",
                 "released", "__weakref__")

    def __init__(self, seq: int, component: str, device: str, digest: str,
                 nbytes: int):
        self.seq = seq
        self.component = component
        self.device = device
        self.digest = digest
        self.nbytes = int(nbytes)
        self.released = False

    def resize(self, nbytes: int) -> None:
        with _LOCK:
            if self.released:
                return
            self.nbytes = int(nbytes)
            _bump_peak_locked(self.device)

    def release(self) -> None:
        with _LOCK:
            if self.released:
                return
            self.released = True
            _allocs.pop(self.seq, None)


def _bump_peak_locked(device: str) -> None:  # graftlint: holds(_LOCK)
    total = sum(a.nbytes for a in _allocs.values() if a.device == device)
    if total > _attr_peak.get(device, 0):
        _attr_peak[device] = total


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn tracking on (idempotent).  Servers call this at construction;
    already-live allocations made while off are simply not in the ledger."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the whole ledger + peaks + injected provider (tests/bench)."""
    global _attr_limit, _stats_provider, _default_device
    with _LOCK:
        for a in _allocs.values():
            a.released = True
        _allocs.clear()
        _attr_peak.clear()
    _stats_provider = None
    _attr_limit = 0
    _default_device = None


def _device_name() -> str:
    """Default device tag for untagged registrations: "cuda:<i>" of the
    current CUDA device, matching the raw-sampler keys so attributed and
    raw rows join in snapshot(); "cpu" without a card."""
    global _default_device
    if _default_device is None:
        import torch

        if torch.cuda.is_available():
            _default_device = f"cuda:{torch.cuda.current_device()}"
        else:
            _default_device = "cpu"
    return _default_device


def track(component: str, nbytes: int, device: str = "", digest: str = "",
          owner=None):
    """Register `nbytes` of long-lived device memory under `component`.

    Returns a handle: ``resize(nbytes)`` for allocations that grow,
    ``release()`` when freed.  Pass ``owner=`` to auto-release when that
    object is garbage-collected (the safety net for engine-held tensors
    dropped by pool eviction).  With an empty `digest`, the ambient
    ``ruleset_digest(...)`` scope tags the allocation, which is what lets
    the resident pool measure per-ruleset bytes.  No-op (shared handle)
    while tracking is off.
    """
    if not _enabled:
        return NOOP_HANDLE
    global _seq
    dev = device or _device_name()
    dig = digest or _digest_ctx.get()
    with _LOCK:
        _seq += 1
        alloc = _Allocation(_seq, component, dev, dig, int(nbytes))
        _allocs[alloc.seq] = alloc
        _bump_peak_locked(dev)
    if owner is not None:
        weakref.finalize(owner, alloc.release)
    return alloc


@contextlib.contextmanager
def ruleset_digest(digest: str):
    """Scope within which untagged track() calls inherit `digest`."""
    tok = _digest_ctx.set(digest or "")
    try:
        yield
    finally:
        _digest_ctx.reset(tok)


def nbytes_of(value) -> int:
    """Best-effort byte size of a cached value: .nbytes, or the sum over
    a tuple/list of such (the shapes engines actually cache)."""
    n = getattr(value, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(value, (tuple, list)):
        return sum(nbytes_of(v) for v in value)
    return 0


# -- read side -------------------------------------------------------------


def total_bytes() -> int:
    with _LOCK:
        return sum(a.nbytes for a in _allocs.values())


def allocation_count() -> int:
    with _LOCK:
        return len(_allocs)


def bytes_for_digest(digest: str, exclude: tuple[str, ...] = ()) -> int:
    """Attributed bytes tagged with `digest` (the resident pool's measured
    side), minus any components in `exclude`."""
    if not digest:
        return 0
    with _LOCK:
        return sum(
            a.nbytes
            for a in _allocs.values()
            if a.digest == digest and a.component not in exclude
        )


def set_stats_provider(fn: Callable[[], dict] | None) -> None:
    """Inject (or with None, restore) the raw per-device stats source.
    The provider returns ``{device: {"bytes_in_use": int,
    "peak_bytes_in_use": int, "bytes_limit": int}}`` and is always called
    outside the ledger lock, so a fake may read the ledger back."""
    global _stats_provider
    _stats_provider = fn


def set_attributed_limit(nbytes: int) -> None:
    """Byte budget pressure() falls back to when no raw bytes_limit is
    reported (the CPU) — attributed_total/limit."""
    global _attr_limit
    _attr_limit = max(0, int(nbytes))


def cuda_stats() -> dict:
    """Default raw sampler: per CUDA device the caching allocator's bytes
    in use and their peak, and the card's total memory as the limit.  Only
    once CUDA is initialised (a scrape never creates a context); {} on the
    CPU, where the ledger carries on from registrations alone."""
    import torch

    out: dict[str, dict] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        _free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", in_use)),
            "bytes_limit": int(total),
        }
    return out


def raw_stats() -> dict:
    """Per-device raw allocator stats ({} on backends without them)."""
    fn = _stats_provider or cuda_stats
    try:
        return dict(fn())
    except Exception:
        return {}


def pressure() -> dict:
    """How close to the edge: ``fraction`` in [0, 1] with its ``source``.

    "measured": max over devices of raw bytes_in_use/bytes_limit.
    "attributed": ledger total / set_attributed_limit() budget (no raw
    limits available).  "none": no limit known from either side —
    fraction 0.0, watermarks can't act.
    """
    raw = raw_stats()
    best = {"fraction": 0.0, "source": "none", "device": None,
            "bytes_in_use": 0, "bytes_limit": 0}
    for dev, ms in raw.items():
        limit = ms.get("bytes_limit", 0)
        if limit and limit > 0:
            frac = ms.get("bytes_in_use", 0) / limit
            if best["source"] == "none" or frac > best["fraction"]:
                best = {
                    "fraction": frac, "source": "measured", "device": dev,
                    "bytes_in_use": ms.get("bytes_in_use", 0),
                    "bytes_limit": limit,
                }
    if best["source"] == "none" and _attr_limit > 0:
        used = total_bytes()
        best = {
            "fraction": used / _attr_limit, "source": "attributed",
            "device": None, "bytes_in_use": used, "bytes_limit": _attr_limit,
        }
    return best


def snapshot(top: int = 10) -> dict:
    """The `/debug/memory` body: per-device raw + attributed breakdown,
    residuals, watermark-ready pressure, and the `top` largest live
    allocations.  Attributed sums equal the live ledger exactly (zero
    tolerance by construction); the raw residual is the backend's
    unattributed remainder."""
    raw = raw_stats()
    with _LOCK:
        allocs = [
            (a.component, a.device, a.digest, a.nbytes)
            for a in _allocs.values()
        ]
        peaks = dict(_attr_peak)
    devices: dict[str, dict] = {}
    for comp, dev, _dig, nb in allocs:
        d = devices.setdefault(dev, {"attributed": {}, "attributed_bytes": 0})
        d["attributed"][comp] = d["attributed"].get(comp, 0) + nb
        d["attributed_bytes"] += nb
    for dev in raw:
        devices.setdefault(dev, {"attributed": {}, "attributed_bytes": 0})
    for dev, d in devices.items():
        d["attributed_peak_bytes"] = peaks.get(dev, 0)
        ms = raw.get(dev)
        d["raw"] = ms
        d["residual_bytes"] = (
            ms["bytes_in_use"] - d["attributed_bytes"] if ms else None
        )
    allocs.sort(key=lambda t: t[3], reverse=True)
    return {
        "enabled": _enabled,
        "devices": devices,
        "attributed_total_bytes": sum(nb for *_x, nb in allocs),
        "registered_allocations": len(allocs),
        "top": [
            {"component": c, "device": d, "digest": g, "nbytes": n}
            for c, d, g, n in allocs[: max(0, int(top))]
        ],
        "pressure": pressure(),
    }


def explain_block() -> dict:
    """The small `Explain.memory` dict attached to --explain responses."""
    p = pressure()
    return {
        "pressure": round(p["fraction"], 4),
        "source": p["source"],
        "attributed_bytes": total_bytes(),
        "allocations": allocation_count(),
    }


def register_collectors(registry) -> None:
    """Create the HBM gauge families on `registry` and add the collect
    hook that rebuilds them from live ledger + raw stats each scrape
    (clear + re-set, the build_info pattern, so released components stop
    scraping instead of pinning stale samples)."""
    g_bytes = registry.gauge(
        "trivy_tpu_device_hbm_bytes",
        "device bytes by attributed component "
        '(component="_unattributed" = raw in-use minus the ledger)',
        labelnames=("device", "component"),
    )
    g_peak = registry.gauge(
        "trivy_tpu_device_hbm_peak_bytes",
        "peak device bytes (backend allocator peak when reported, else "
        "the attributed high-water mark)",
        labelnames=("device",),
    )
    g_pressure = registry.gauge(
        "trivy_tpu_hbm_pressure",
        "max used/limit fraction across devices (0 = no limit known); "
        "the --hbm-soft-pct/--hbm-hard-pct watermarks act on this",
    )

    def _collect() -> None:
        snap = snapshot(top=0)
        g_bytes.clear()
        g_peak.clear()
        for dev, d in snap["devices"].items():
            for comp, nb in d["attributed"].items():
                g_bytes.labels(device=dev, component=comp).set(nb)
            residual = d.get("residual_bytes")
            if residual is not None and residual > 0:
                g_bytes.labels(device=dev, component="_unattributed").set(
                    residual
                )
            ms = d.get("raw")
            peak = (
                ms["peak_bytes_in_use"] if ms else d["attributed_peak_bytes"]
            )
            g_peak.labels(device=dev).set(peak)
        g_pressure.set(snap["pressure"]["fraction"])

    registry.add_collect_hook(_collect)
