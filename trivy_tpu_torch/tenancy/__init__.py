"""trivy_tpu_torch.tenancy — multi-tenant ruleset serving.

The single-ruleset server becomes a platform in three layers, all living
here between the scheduler (trivy_tpu/serve/) and the registry
(trivy_tpu/registry/):

  pool.py   ResidentRulesetPool — LRU of compiled-ruleset engines, bounded
            by count and estimated device bytes.  Each slot owns its own
            RulesetManager, so the epoch-swap machinery applies
            per-ruleset: in-flight batches always finish on their engine.
  qos.py    Per-tenant admission control — token buckets over requests/s
            and bytes/s plus per-tenant inflight caps, answering with a
            deterministic Retry-After instead of queue pressure.

The scheduler keys its admission queue by ruleset digest (one lane per
digest), coalesces same-digest tickets from different clients into shared
device batches, and round-robins lanes by weight so one hot tenant cannot
starve the rest.  See serve/scheduler.py for the lane mechanics.

Copied from `trivy_tpu/tenancy/__init__.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from trivy_tpu_torch.tenancy.pool import (
    PoolStats,
    ResidentRulesetPool,
    UnknownRulesetError,
    slot_key,
    split_slot_key,
)
from trivy_tpu_torch.tenancy.qos import (
    QosStats,
    TenantAdmission,
    TenantQuota,
    TokenBucket,
)

__all__ = [
    "PoolStats",
    "QosStats",
    "ResidentRulesetPool",
    "TenantAdmission",
    "TenantQuota",
    "TokenBucket",
    "UnknownRulesetError",
    "slot_key",
    "split_slot_key",
]
