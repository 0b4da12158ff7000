"""Fleet plane: multi-host serving behind digest-affine routing.

The mesh plane (mesh/) spreads one process over its devices, and the
result cache (cache/) makes scan *results* fleet-shareable.  This
package scales the remaining axis — many server processes — without
giving up what makes a single host fast: ruleset residency (the tenancy
pool) and warm executables (the executable cache).  The pieces:

- `membership.py` — the static member table (name, endpoint, weight)
  with per-host health driven by /readyz probes and passive request
  outcomes, plus `FleetSelf` (a server's own fleet posture);
- `ring.py` — rendezvous (HRW) hashing of ruleset digest -> member:
  stable primary, ordered spillover, ~1/N movement on membership change;
- `decisions.py` — the bounded routing-decision audit ring (the
  gatelog shape, per-process);
- `router.py` — the client-side policy `RemoteSecretEngine` plugs in:
  primary-first dispatch, health-aware spillover within the retry
  budget, decision attribution.

The reference seam is Trivy's client/server Driver split
(pkg/scanner/scan.go:131): there, a load balancer fronts N servers and
affinity is luck; here the client routes, so affinity is policy.

`FleetRouter` imports lazily (PEP 562): it pulls in rpc/client.py,
which imports rpc/server.py, which imports THIS package for the server
side — eager re-export would cycle.

Copied from `trivy_tpu/fleet/`; the port imports nothing from the JAX
package.  The members are the port's servers, each over its own engines.
"""

from __future__ import annotations

from trivy_tpu_torch.fleet.membership import (
    FleetConfig,
    FleetConfigError,
    FleetMembership,
    FleetSelf,
    Member,
    MemberHealth,
    load_fleet_config,
    parse_fleet_config,
    probe_readyz,
)
from trivy_tpu_torch.fleet.ring import candidates, primary, score

__all__ = [
    "FleetConfig",
    "FleetConfigError",
    "FleetExhaustedError",
    "FleetMembership",
    "FleetRouter",
    "FleetSelf",
    "Member",
    "MemberHealth",
    "candidates",
    "load_fleet_config",
    "parse_fleet_config",
    "primary",
    "probe_readyz",
    "score",
]


def __getattr__(name: str):
    if name in ("FleetRouter", "FleetExhaustedError"):
        from trivy_tpu_torch.fleet import router as _router

        return getattr(_router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
