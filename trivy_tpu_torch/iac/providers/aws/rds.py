"""AWS RDS typed state (reference: pkg/iac/providers/aws/rds).

Copied from `trivy_tpu/iac/providers/aws/rds.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import (
    BoolValue,
    IntValue,
    Metadata,
    StringValue,
)


@dataclass
class Encryption:
    metadata: Metadata
    encrypt_storage: BoolValue
    kms_key_id: StringValue


@dataclass
class Instance:
    metadata: Metadata
    encryption: Encryption
    public_access: BoolValue
    backup_retention_period_days: IntValue
    replication_source_arn: StringValue


@dataclass
class Cluster:
    metadata: Metadata
    encryption: Encryption
    backup_retention_period_days: IntValue


@dataclass
class RDS:
    instances: list[Instance] = field(default_factory=list)
    clusters: list[Cluster] = field(default_factory=list)
