"""Kubernetes provider state skeleton (reference: pkg/iac/providers/kubernetes).

Kubernetes manifests already evaluate directly against their YAML
documents (iac/engine.py kubernetes path); this typed view exists for
checks that address ``input.kubernetes....`` cloud-style state.

Copied from `trivy_tpu/iac/providers/kubernetes.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import Metadata, StringValue


@dataclass
class NetworkPolicy:
    metadata: Metadata
    name: StringValue


@dataclass
class Kubernetes:
    network_policies: list[NetworkPolicy] = field(default_factory=list)
