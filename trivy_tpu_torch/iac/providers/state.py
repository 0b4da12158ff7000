"""The single cross-provider state document (reference: pkg/iac/state).

Every adapter produces one ``State``; ``to_rego()`` is the input
document cloud checks evaluate against (``input.aws.s3.buckets``...).

Copied from `trivy_tpu/iac/providers/state.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers import types
from trivy_tpu_torch.iac.providers.aws import AWS
from trivy_tpu_torch.iac.providers.azure import Azure
from trivy_tpu_torch.iac.providers.google import Google
from trivy_tpu_torch.iac.providers.kubernetes import Kubernetes


@dataclass
class State:
    aws: AWS = field(default_factory=AWS)
    azure: Azure = field(default_factory=Azure)
    google: Google = field(default_factory=Google)
    kubernetes: Kubernetes = field(default_factory=Kubernetes)

    def to_rego(self) -> dict:
        return types.to_rego(self)

    def service_has_resources(self, provider: str, service: str) -> bool:
        """Whether any resources were adapted for provider/service — the
        applicability gate (rego/scanner isPolicyApplicable): a cloud
        check only evaluates when its subtype's state is non-empty, so
        an S3-only terraform file never reports PASS rows for rds/elb/…
        checks it could not possibly have exercised."""
        prov = getattr(self, provider, None)
        if prov is None:
            return False
        if not service:
            return True
        svc = getattr(prov, service, None)
        if svc is None:
            return False
        for f in dataclasses.fields(svc):
            v = getattr(svc, f.name)
            if isinstance(v, list) and v:
                return True
            if v is not None and not isinstance(v, list) and f.name != "metadata":
                return True
        return False
