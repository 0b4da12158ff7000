"""Azure provider state skeleton (reference: pkg/iac/providers/azure).

Services grow here the same way aws/ did: one dataclass per service
with value-typed fields, adapted by trivy_tpu_torch/iac/adapters.

Copied from `trivy_tpu/iac/providers/azure.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import BoolValue, Metadata, StringValue


@dataclass
class StorageAccount:
    metadata: Metadata
    name: StringValue
    enforce_https: BoolValue


@dataclass
class Storage:
    accounts: list[StorageAccount] = field(default_factory=list)


@dataclass
class Azure:
    storage: Storage = field(default_factory=Storage)
