"""Google Cloud provider state skeleton (reference: pkg/iac/providers/google).

Copied from `trivy_tpu/iac/providers/google.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import BoolValue, Metadata, StringValue


@dataclass
class StorageBucket:
    metadata: Metadata
    name: StringValue
    uniform_bucket_level_access: BoolValue


@dataclass
class Storage:
    buckets: list[StorageBucket] = field(default_factory=list)


@dataclass
class Google:
    storage: Storage = field(default_factory=Storage)
