"""Observability substrate of the port: span tracing (obs/trace.py), the
counter/gauge/histogram registry with per-kernel device phases
(obs/metrics.py), the device-memory ledger (obs/memwatch.py: raw CUDA
allocator stats + per-component attributed bytes), the gate decision
log (obs/gatelog.py), and for the server per-method SLO burn rates
(obs/slo.py), tenant-labelled families behind a cardinality governor
(obs/tenantmetrics.py) and the breach-triggered flight recorder
(obs/flight.py).

Copied from `trivy_tpu/obs/` (without the bench ledger, perfledger.py).
The engines wrap every stage in a span (the device engine's
`chunk.encode`, `chunk.h2d`, `chunk.exec`, `sieve.megakernel`,
`chunk.fetch`; the default engine's `hybrid.scan` over `hybrid.allow`,
`sieve`, `sieve.wait`, `verify.dedupe`, `verify.assemble`,
`verify.dispatch`, `verify.fetch`, `verify.padded`; both engines'
`verify` and `confirm`) and each device section in a `device_phase`,
timed by CUDA events that are read when the samples are drained, never
waited on.  `engine.build` and its parts span the default engine's
construction.  Under `torch.profiler`, `trace.merge_into_profile` writes
the spans into the profiler's trace on its clock.

Everything is off by default: `span()` returns a no-op singleton unless
tracing was enabled (`TRIVY_TPU_TRACE=1` or `trace.enable()`), so the
scan path pays one predicate per call site.
"""

from trivy_tpu_torch.obs import (
    flight,
    gatelog,
    memwatch,
    metrics,
    slo,
    tenantmetrics,
    trace,
)

__all__ = [
    "flight",
    "gatelog",
    "memwatch",
    "metrics",
    "slo",
    "tenantmetrics",
    "trace",
]
