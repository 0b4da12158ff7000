"""trivy_tpu_torch.serve — continuous cross-request batching for the secret engine.

The serving shape (request queue -> continuous batcher -> device engine ->
demux) that turns the chunk pipeline's per-scan overlap into a traffic-scale
optimization: concurrent Scan requests coalesce into one device batch under a
fill-or-timeout window, exactly the Orca/vLLM-style micro-batching used by
inference servers.  See scheduler.py for the engine-owner model.

Multi-tenancy keys the queue by ruleset digest: per-digest lanes
coalesce same-digest tickets from different clients, weighted round-robin
picks among ready lanes, and per-tenant token buckets (trivy_tpu/tenancy/)
gate admission before any ticket enters a lane.

Copied from `trivy_tpu/serve/__init__.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from trivy_tpu_torch.serve.scheduler import (
    AdmissionError,
    BatchScheduler,
    BreakerOpenError,
    ClientOverloadedError,
    HbmPressureError,
    QueueFullError,
    QuotaExceededError,
    SchedulerClosedError,
    SchedulerStats,
    SecretBatch,
    ServeConfig,
    Ticket,
)
from trivy_tpu_torch.tenancy import (
    ResidentRulesetPool,
    TenantAdmission,
    TenantQuota,
    UnknownRulesetError,
)

__all__ = [
    "AdmissionError",
    "BatchScheduler",
    "BreakerOpenError",
    "ClientOverloadedError",
    "HbmPressureError",
    "QueueFullError",
    "QuotaExceededError",
    "ResidentRulesetPool",
    "SchedulerClosedError",
    "SchedulerStats",
    "SecretBatch",
    "ServeConfig",
    "TenantAdmission",
    "TenantQuota",
    "Ticket",
    "UnknownRulesetError",
]
