"""AWS S3 typed state (reference: pkg/iac/providers/aws/s3).

Copied from `trivy_tpu/iac/providers/aws/s3.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import (
    BoolValue,
    Metadata,
    StringValue,
)


@dataclass
class PublicAccessBlock:
    metadata: Metadata
    block_public_acls: BoolValue
    block_public_policy: BoolValue
    ignore_public_acls: BoolValue
    restrict_public_buckets: BoolValue


@dataclass
class Encryption:
    metadata: Metadata
    enabled: BoolValue
    algorithm: StringValue
    kms_key_id: StringValue


@dataclass
class Versioning:
    metadata: Metadata
    enabled: BoolValue
    mfa_delete: BoolValue


@dataclass
class Logging:
    metadata: Metadata
    enabled: BoolValue
    target_bucket: StringValue


@dataclass
class Bucket:
    metadata: Metadata
    name: StringValue
    acl: StringValue
    encryption: Encryption
    versioning: Versioning
    logging: Logging
    # None when the config never declares one — checks test for absence
    # via `not bucket.publicaccessblock`.
    public_access_block: PublicAccessBlock | None = None


@dataclass
class S3:
    buckets: list[Bucket] = field(default_factory=list)
