"""Per-tenant admission QoS: token buckets over requests/s and bytes/s.

Backpressure before this layer was *global*: a bounded queue and a flat
per-client inflight cap.  Those protect the server, not the tenants — one
client free to burst 256 tickets still monopolizes every fill window until
its queue share drains.  Token buckets bound the *rate* each tenant may
admit work at, and because a bucket knows exactly when it will next afford
a request, rejections carry a deterministic Retry-After instead of the
scheduler's fixed hint.

Design constraints:

  * Admission runs on every request thread, so the controller is one lock
    around O(1) arithmetic — no timers, no background refill thread.
    Buckets refill lazily from the elapsed monotonic time at each take.
  * `try_admit` is all-or-nothing across the request bucket AND the byte
    bucket: both are checked before either is debited, so a rejection
    never leaks tokens (the classic double-bucket partial-debit bug).
  * A request larger than the byte burst can never afford itself; it is
    clamped to the full burst (pay the whole bucket) so oversized-but-
    legitimate requests degrade to "at most one per refill interval"
    instead of an infinite Retry-After.
  * The module has no dependency on trivy_tpu_torch.serve: the scheduler maps a
    nonzero wait into its AdmissionError hierarchy (HTTP 429).

All clock inputs are injectable (`now=`) so tests are deterministic.

Copied from `trivy_tpu/tenancy/qos.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass

from trivy_tpu_torch import lockcheck


class TokenBucket:
    """Lazily-refilled token bucket.  Unlocked on purpose: the owning
    controller serializes access (one bucket is never shared across
    controllers), so per-bucket locks would only add an order-graph node.
    """

    __slots__ = ("rate", "burst", "tokens", "updated")

    def __init__(self, rate: float, burst: float, now: float):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst  # start full: first burst is free
        self.updated = float(now)

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self.updated)
        self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self.updated = now

    def wait_for(self, n: float, now: float) -> float:
        """Seconds until `n` tokens are affordable (0.0 = affordable now).
        `n` is clamped to the burst so an oversized request waits for a
        full bucket, never forever."""
        self._refill(now)
        n = min(float(n), self.burst)
        if self.tokens >= n:
            return 0.0
        return (n - self.tokens) / self.rate

    def take(self, n: float, now: float) -> None:
        """Debit `n` (clamped to burst); caller must have seen
        wait_for() == 0 under the same lock."""
        self._refill(now)
        self.tokens = max(0.0, self.tokens - min(float(n), self.burst))


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission budget.  0 means unlimited on that axis;
    bursts default to one second of rate."""

    rps: float = 0.0  # requests per second
    burst: float = 0.0  # request bucket depth (0 = max(rps, 1))
    bytes_per_s: float = 0.0  # payload bytes per second
    bytes_burst: float = 0.0  # byte bucket depth (0 = bytes_per_s)
    max_inflight: int | None = None  # overrides ServeConfig's flat cap

    def request_burst(self) -> float:
        return self.burst if self.burst > 0 else max(self.rps, 1.0)

    def byte_burst(self) -> float:
        return self.bytes_burst if self.bytes_burst > 0 else self.bytes_per_s


@dataclass
class QosStats:
    admitted: int = 0
    rejected_requests: int = 0  # request-rate bucket said no
    rejected_bytes: int = 0  # byte-rate bucket said no


class TenantAdmission:
    """The per-tenant admission controller the scheduler consults before
    any ticket enters a lane.  Unknown tenants get the default quota;
    `set_quota` installs per-tenant overrides at runtime (tests, future
    admin RPC)."""

    def __init__(
        self,
        default: TenantQuota | None = None,
        quotas: dict[str, TenantQuota] | None = None,
    ):
        self._lock = lockcheck.make_lock("tenancy.qos")
        self._default = default or TenantQuota()
        self._quotas: dict[str, TenantQuota] = dict(quotas or {})  # owner: _lock
        self._req_buckets: dict[str, TokenBucket] = {}  # owner: _lock
        self._byte_buckets: dict[str, TokenBucket] = {}  # owner: _lock
        self.stats = QosStats()  # counters; mutated under _lock

    # -- configuration ---------------------------------------------------

    def set_quota(self, tenant: str, quota: TenantQuota | None) -> None:
        """Install (or with None, drop) a per-tenant override.  Buckets
        reset so the new rate applies immediately."""
        with self._lock:
            if quota is None:
                self._quotas.pop(tenant, None)
            else:
                self._quotas[tenant] = quota
            self._req_buckets.pop(tenant, None)
            self._byte_buckets.pop(tenant, None)

    def quota(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, self._default)

    def max_inflight(self, tenant: str) -> int | None:
        """Per-tenant inflight override, None = use the scheduler's flat
        ServeConfig cap."""
        return self.quota(tenant).max_inflight

    def snapshot(self, now: float) -> dict:
        """Bucket levels at `now`, for flight-recorder capture.  Read-only:
        refill is *computed* against `now`, never applied, so a snapshot
        cannot perturb admission.  Only rate-limited tenants appear —
        unlimited quotas never create buckets."""
        with self._lock:
            tenants: dict[str, dict] = {}
            for kind, table in (
                ("request", self._req_buckets),
                ("byte", self._byte_buckets),
            ):
                for tenant, b in table.items():
                    level = min(
                        b.burst,
                        b.tokens + max(0.0, now - b.updated) * b.rate,
                    )
                    entry = tenants.setdefault(tenant, {})
                    entry[f"{kind}_tokens"] = round(level, 3)
                    entry[f"{kind}_burst"] = b.burst
            return {
                "tenants": tenants,
                "admitted": self.stats.admitted,
                "rejected_requests": self.stats.rejected_requests,
                "rejected_bytes": self.stats.rejected_bytes,
            }

    # -- admission (request threads) -------------------------------------

    def _bucket(  # graftlint: holds(_lock)
        self,
        table: dict[str, TokenBucket],
        tenant: str,
        rate: float,
        burst: float,
        now: float,
    ) -> TokenBucket:
        b = table.get(tenant)
        if b is None or b.rate != rate or b.burst != max(burst, 1.0):
            b = table[tenant] = TokenBucket(rate, burst, now)
        return b

    def try_admit(
        self, tenant: str, nbytes: int, now: float
    ) -> tuple[float, str]:
        """Charge one request of `nbytes` against the tenant's buckets.
        Returns (0.0, "") when admitted, else (retry_after_s, reason) with
        reason "requests" or "bytes" and NOTHING debited."""
        with self._lock:
            q = self._quotas.get(tenant, self._default)
            rb = bb = None
            if q.rps > 0:
                rb = self._bucket(
                    self._req_buckets, tenant, q.rps, q.request_burst(), now
                )
                wait = rb.wait_for(1.0, now)
                if wait > 0:
                    self.stats.rejected_requests += 1
                    return wait, "requests"
            if q.bytes_per_s > 0:
                bb = self._bucket(
                    self._byte_buckets, tenant, q.bytes_per_s,
                    q.byte_burst(), now,
                )
                wait = bb.wait_for(float(nbytes), now)
                if wait > 0:
                    self.stats.rejected_bytes += 1
                    return wait, "bytes"
            if rb is not None:
                rb.take(1.0, now)
            if bb is not None:
                bb.take(float(nbytes), now)
            self.stats.admitted += 1
            return 0.0, ""
