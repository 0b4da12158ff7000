"""Per-method SLOs tracked as multi-window burn rates (SRE-workbook style).

A single latency histogram answers "how bad is the tail right now"; an SLO
answers "are we spending our error budget faster than we can afford".  This
module layers declarative objectives over the request stream the server
already observes into `trivy_tpu_request_seconds`:

  * An `Objective` per RPC method: a latency threshold + target fraction
    (e.g. 99% of requests under 1s) and an error target (e.g. 99.9% of
    requests not 5xx/408).  Defaults apply to every method; a YAML file
    (`--slo-config`) overrides per method.
  * Burn rates over three windows (5m/1h/6h): burn = bad_fraction /
    (1 - target).  Burn 1.0 means "spending budget exactly as provisioned";
    14.4 over 5m is the classic page-now threshold.  Multi-window reporting
    distinguishes a blip (5m hot, 6h calm) from a slow leak (all hot).
  * Budget remaining over the longest window: 1 - burn_6h (can go
    negative — the operator should know *how far* over budget they are).

Request outcomes land in a ring of fixed 10s time slots per method (max
6h/10s = 2160 slots), so window sums are O(slots) at scrape time and O(1)
at observe time.  The latency threshold is snapped DOWN to the nearest
`LATENCY_BUCKETS` bound so every burn number is exactly derivable from the
exported `request_seconds` histogram — the SLO layer never claims precision
the histogram cannot back.

Classification: 5xx and 408 (deadline expired server-side) burn the error
budget; 429 does NOT — a QoS rejection is the server protecting itself,
not failing the tenant — but it still triggers flight-recorder capture
(see obs/flight.py) because the tenant experienced it as a failure.

All clock inputs are injectable (`now=`) so tests are deterministic.

Copied from `trivy_tpu/obs/slo.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from time import monotonic

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.obs import metrics as obs_metrics

# (label, seconds) — ordered short to long; the last window funds the
# budget-remaining number.
WINDOWS = (("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))
SLOT_SECONDS = 10.0


def snap_threshold(
    threshold_s: float,
    buckets: tuple[float, ...] = obs_metrics.LATENCY_BUCKETS,
) -> float:
    """Largest histogram bucket bound <= threshold (or the smallest bound
    if the threshold sits below all of them), so "slow" is exactly the
    histogram's count above that bound."""
    i = bisect_right(buckets, float(threshold_s))
    return buckets[i - 1] if i > 0 else buckets[0]


@dataclass(frozen=True)
class Objective:
    """One method's SLO: latency_target of requests under
    latency_threshold_s, error_target of requests not an error."""

    latency_threshold_s: float = 1.0
    latency_target: float = 0.99
    error_target: float = 0.999

    def validate(self) -> None:
        if self.latency_threshold_s <= 0:
            raise ValueError(
                f"latency_threshold_s must be > 0, got {self.latency_threshold_s}"
            )
        for name in ("latency_target", "error_target"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v}")


def load_slo_config(path: str) -> tuple[Objective, dict[str, Objective]]:
    """Parse an --slo-config YAML file:

        default:
          latency_threshold_s: 1.0
          latency_target: 0.99
          error_target: 0.999
        methods:
          scan_secrets: {latency_threshold_s: 0.25}

    Method entries inherit unset fields from `default`, which itself
    inherits from the built-in Objective defaults."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: SLO config must be a mapping")

    def build(raw: object, base: Objective) -> Objective:
        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: objective entries must be mappings")
        obj = Objective(
            latency_threshold_s=float(
                raw.get("latency_threshold_s", base.latency_threshold_s)
            ),
            latency_target=float(
                raw.get("latency_target", base.latency_target)
            ),
            error_target=float(raw.get("error_target", base.error_target)),
        )
        obj.validate()
        return obj

    default = build(doc.get("default"), Objective())
    methods = {
        str(m): build(raw, default)
        for m, raw in (doc.get("methods") or {}).items()
    }
    return default, methods


class _Slot:
    """One SLOT_SECONDS bucket of request outcomes for one method."""

    __slots__ = ("t0", "total", "slow", "errors")

    def __init__(self, t0: float):
        self.t0 = t0
        self.total = 0
        self.slow = 0
        self.errors = 0


class SloTracker:
    """Classifies every (method, code, elapsed) observation against its
    objective, keeps the per-window slot rings, and exposes the
    trivy_tpu_slo_* families plus the /debug/slo report."""

    def __init__(
        self,
        registry: obs_metrics.Registry,
        default: Objective | None = None,
        per_method: dict[str, Objective] | None = None,
        slot_s: float = SLOT_SECONDS,
        now=monotonic,
    ):
        self._now = now
        self._slot_s = float(slot_s)
        self._max_window = max(w for _, w in WINDOWS)
        self._default = self._snap(default or Objective())
        self._per_method = {
            m: self._snap(o) for m, o in (per_method or {}).items()
        }
        self._lock = lockcheck.make_lock("obs.slo")
        self._methods: dict[str, deque[_Slot]] = {}  # owner: _lock

        self._m_burn = registry.gauge(
            "trivy_tpu_slo_burn_rate",
            "error-budget burn rate (1.0 = spending exactly as provisioned)",
            ("method", "slo", "window"),
        )
        self._m_budget = registry.gauge(
            "trivy_tpu_slo_budget_remaining",
            "fraction of the error budget left over the longest window "
            "(negative = over budget)",
            ("method", "slo"),
        )
        self._m_breaches = registry.counter(
            "trivy_tpu_slo_breaches_total",
            "individual requests that breached an objective",
            ("method", "slo"),
        )
        self._m_threshold = registry.gauge(
            "trivy_tpu_slo_latency_threshold_seconds",
            "latency objective threshold (snapped to a histogram bound)",
            ("method",),
        )
        registry.add_collect_hook(self._collect)

    @staticmethod
    def _snap(obj: Objective) -> Objective:
        obj.validate()
        return Objective(
            latency_threshold_s=snap_threshold(obj.latency_threshold_s),
            latency_target=obj.latency_target,
            error_target=obj.error_target,
        )

    def objective(self, method: str) -> Objective:
        return self._per_method.get(method, self._default)

    # -- observe (request threads) ----------------------------------------

    def observe(
        self, method: str, code: int, elapsed_s: float
    ) -> tuple[str, ...]:
        """Record one request outcome.  Returns the objectives it breached
        (() / ("latency",) / ("error",) / ("latency", "error")) so the
        caller can decide whether to promote the request into the flight
        ring.  429 never appears here — see the module docstring."""
        obj = self.objective(method)
        slow = elapsed_s > obj.latency_threshold_s
        err = code == 408 or code >= 500
        now = self._now()
        t0 = now - (now % self._slot_s)
        with self._lock:
            slots = self._methods.setdefault(method, deque())
            if not slots or slots[-1].t0 != t0:
                slots.append(_Slot(t0))
                horizon = now - self._max_window - self._slot_s
                while slots and slots[0].t0 < horizon:
                    slots.popleft()
            slot = slots[-1]
            slot.total += 1
            if slow:
                slot.slow += 1
            if err:
                slot.errors += 1
        breached = []
        if slow:
            breached.append("latency")
            self._m_breaches.labels(method=method, slo="latency").inc()
        if err:
            breached.append("error")
            self._m_breaches.labels(method=method, slo="error").inc()
        return tuple(breached)

    # -- report (scrape / debug endpoint) ----------------------------------

    def _window_sums(
        self, slots: list[_Slot], now: float
    ) -> dict[str, tuple[int, int, int]]:
        out = {}
        for label, width in WINDOWS:
            total = slow = errors = 0
            for s in slots:
                # A slot counts toward a window while any part of it
                # overlaps [now - width, now].
                if s.t0 + self._slot_s >= now - width:
                    total += s.total
                    slow += s.slow
                    errors += s.errors
            out[label] = (total, slow, errors)
        return out

    @staticmethod
    def _burn(bad: int, total: int, target: float) -> float:
        if total <= 0:
            return 0.0
        return (bad / total) / max(1.0 - target, 1e-9)

    def report(self) -> dict:
        """The /debug/slo payload: per method, the (snapped) objective,
        window sums, burn per window, and budget remaining over the
        longest window."""
        now = self._now()
        with self._lock:
            snap = {m: list(slots) for m, slots in self._methods.items()}
        budget_label = WINDOWS[-1][0]
        methods = {}
        for m, slots in sorted(snap.items()):
            obj = self.objective(m)
            sums = self._window_sums(slots, now)
            windows = {}
            for label, _ in WINDOWS:
                total, slow, errors = sums[label]
                windows[label] = {
                    "total": total,
                    "slow": slow,
                    "errors": errors,
                    "latency_burn": round(
                        self._burn(slow, total, obj.latency_target), 4
                    ),
                    "error_burn": round(
                        self._burn(errors, total, obj.error_target), 4
                    ),
                }
            long = windows[budget_label]
            methods[m] = {
                "objective": {
                    "latency_threshold_s": obj.latency_threshold_s,
                    "latency_target": obj.latency_target,
                    "error_target": obj.error_target,
                },
                "windows": windows,
                "latency_budget_remaining": round(
                    1.0 - long["latency_burn"], 4
                ),
                "error_budget_remaining": round(1.0 - long["error_burn"], 4),
            }
        return {
            "slot_seconds": self._slot_s,
            "windows": {label: width for label, width in WINDOWS},
            "budget_window": budget_label,
            "methods": methods,
        }

    def _collect(self) -> None:
        """Scrape-time mirror of report() into the gauge families.  Must
        never raise and never do work a scrape shouldn't trigger — it only
        sums slots already recorded."""
        now = self._now()
        with self._lock:
            snap = {m: list(slots) for m, slots in self._methods.items()}
        budget_label = WINDOWS[-1][0]
        for m, slots in snap.items():
            obj = self.objective(m)
            sums = self._window_sums(slots, now)
            self._m_threshold.labels(method=m).set(obj.latency_threshold_s)
            for label, _ in WINDOWS:
                total, slow, errors = sums[label]
                self._m_burn.labels(method=m, slo="latency", window=label).set(
                    self._burn(slow, total, obj.latency_target)
                )
                self._m_burn.labels(method=m, slo="error", window=label).set(
                    self._burn(errors, total, obj.error_target)
                )
            total, slow, errors = sums[budget_label]
            self._m_budget.labels(method=m, slo="latency").set(
                1.0 - self._burn(slow, total, obj.latency_target)
            )
            self._m_budget.labels(method=m, slo="error").set(
                1.0 - self._burn(errors, total, obj.error_target)
            )
