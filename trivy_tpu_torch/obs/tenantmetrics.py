"""Per-tenant/per-digest metric dimensions behind a cardinality governor.

Label values drawn from the wire (client IDs, ruleset digests) are
unbounded: one misbehaving client minting a fresh ClientID per request
would otherwise grow a metric series per request until the scrape — and
the process — falls over.  The governor bounds that: the top-K keys by
request volume get their own series, everything else collapses into the
`_other` rollup, and K is an operator knob (`--max-tenant-series`).

Mechanics:

  * Admission is immediate while fewer than K keys are resident (the
    first K distinct keys each get a series — no warmup cliff).
  * Every `cadence` observations the governor re-ranks all keys by
    (-count, key) and installs the new top-K.  The sort key makes
    promotion/demotion a pure function of the observation sequence —
    deterministic, testable, no timestamps.
  * Demotion *folds* the key's existing series into `_other` via
    `_Family.fold_label`, so totals are conserved (sum over tenants +
    `_other` always equals the untenanted family) and the scrape shrinks
    instead of accumulating dead series.
  * Counts halve at each rebalance (so an ancient burst cannot pin
    residency forever) and keys that decay to zero are dropped (so the
    counts table is bounded too, not just the label space).

A key named literally `_other` aliases into the rollup; conservation is
unaffected, the tenant just cannot be distinguished from the tail.

graftlint GL007 enforces the contract repo-wide: a `.labels()` value for
an unbounded label name must be a literal or routed through
`resolve()`/`lookup()` here.

Copied from `trivy_tpu/obs/tenantmetrics.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from typing import Callable

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.obs import metrics as obs_metrics

OTHER = "_other"
# Rebalance cadence: cheap enough to amortize (one O(n log n) sort per
# 256 events over a table bounded by decay), frequent enough that a
# traffic shift re-ranks within seconds under load.
REBALANCE_CADENCE = 256


class CardinalityGovernor:
    """Top-K label admission.  `resolve` counts the key's volume and
    returns the label value to use (the key itself while resident, else
    OTHER); `lookup` returns the same mapping without counting — use it
    for follow-up observations of an already-admitted request so one
    request is one unit of volume no matter how many families it lands
    in."""

    def __init__(
        self,
        max_series: int = 16,
        cadence: int = REBALANCE_CADENCE,
        on_demote: Callable[[str], None] | None = None,
        name: str = "obs.tenant.governor",
    ):
        self.max_series = max(0, int(max_series))
        self.cadence = max(1, int(cadence))
        self.on_demote = on_demote
        self._lock = lockcheck.make_lock(name)
        self._counts: dict[str, int] = {}  # owner: _lock
        self._resident: dict[str, bool] = {}  # owner: _lock
        self._seen = 0  # owner: _lock

    def resolve(self, key: str) -> str:
        key = str(key)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._seen += 1
            if (
                key not in self._resident
                and len(self._resident) < self.max_series
            ):
                self._resident[key] = True
            if self._seen % self.cadence == 0:
                self._rebalance()
            return key if key in self._resident else OTHER

    def lookup(self, key: str) -> str:
        with self._lock:
            return str(key) if str(key) in self._resident else OTHER

    def resident(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._resident))

    def _rebalance(self) -> None:  # graftlint: holds(_lock)
        ranked = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        new = {k: True for k, _ in ranked[: self.max_series]}
        demoted = [k for k in self._resident if k not in new]
        self._resident = new
        self._counts = {
            k: v // 2
            for k, v in self._counts.items()
            if v // 2 > 0 or k in new
        }
        for k in demoted:
            if self.on_demote is not None:
                self.on_demote(k)


class TenantMetrics:
    """The tenant/digest-labelled families the scheduler feeds, each
    behind its own governor.  Tenant keys are client IDs ("" = anonymous,
    kept as its own key: the anonymous crowd is usually the biggest
    tenant and the operator should see it).  Digest "" (the builtin
    ruleset lane) maps to "default"."""

    def __init__(
        self,
        registry: obs_metrics.Registry,
        max_tenant_series: int = 16,
        max_digest_series: int | None = None,
        cadence: int = REBALANCE_CADENCE,
    ):
        self._m_requests = registry.counter(
            "trivy_tpu_tenant_requests_total",
            "admitted tickets by tenant and ruleset digest "
            '(long tail rolls up into tenant="_other")',
            ("tenant", "digest"),
        )
        self._m_rejected = registry.counter(
            "trivy_tpu_tenant_rejected_total",
            "admission rejections by tenant and reason",
            ("tenant", "reason"),
        )
        self._m_wait = registry.histogram(
            "trivy_tpu_tenant_ticket_wait_seconds",
            "queue wait (submit to dispatch) by tenant",
            ("tenant",),
            buckets=obs_metrics.LATENCY_BUCKETS,
        )
        self._m_phase = registry.histogram(
            "trivy_tpu_tenant_batch_phase_seconds",
            "per-dispatch engine phase time by ruleset digest",
            ("digest", "phase"),
            buckets=obs_metrics.LATENCY_BUCKETS,
        )
        self.tenants = CardinalityGovernor(
            max_series=max_tenant_series,
            cadence=cadence,
            on_demote=self._demote_tenant,
            name="obs.tenant.governor",
        )
        # Digests are additionally bounded upstream by pool residency, but
        # UnknownRulesetError paths still see arbitrary wire digests.
        self.digests = CardinalityGovernor(
            max_series=(
                max(4, max_tenant_series)
                if max_digest_series is None
                else max_digest_series
            ),
            cadence=cadence,
            on_demote=self._demote_digest,
            name="obs.digest.governor",
        )

    @staticmethod
    def _digest_key(digest: str) -> str:
        return digest or "default"

    def _demote_tenant(self, key: str) -> None:
        self._m_requests.fold_label("tenant", key, OTHER)
        self._m_rejected.fold_label("tenant", key, OTHER)
        self._m_wait.fold_label("tenant", key, OTHER)

    def _demote_digest(self, key: str) -> None:
        self._m_requests.fold_label("digest", key, OTHER)
        self._m_phase.fold_label("digest", key, OTHER)

    # -- event seats (scheduler paths) ------------------------------------

    def admit(self, tenant: str, digest: str) -> None:
        """One admitted ticket: the volume signal both governors rank by."""
        self._m_requests.labels(
            tenant=self.tenants.resolve(tenant),
            digest=self.digests.resolve(self._digest_key(digest)),
        ).inc()

    def reject(self, tenant: str, reason: str) -> None:
        self._m_rejected.labels(
            tenant=self.tenants.resolve(tenant), reason=reason
        ).inc()

    def wait(self, tenant: str, seconds: float) -> None:
        self._m_wait.labels(tenant=self.tenants.lookup(tenant)).observe(
            seconds
        )

    def phase(self, digest: str, phase: str, seconds: float) -> None:
        self._m_phase.labels(
            digest=self.digests.lookup(self._digest_key(digest)), phase=phase
        ).observe(seconds)
