"""AWS CloudTrail typed state (reference: pkg/iac/providers/aws/cloudtrail).

Copied from `trivy_tpu/iac/providers/aws/cloudtrail.py`;
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
class Trail:
    metadata: Metadata
    name: StringValue
    is_multi_region: BoolValue
    enable_log_file_validation: BoolValue
    kms_key_id: StringValue
    bucket_name: StringValue
    is_logging: BoolValue


@dataclass
class CloudTrail:
    trails: list[Trail] = field(default_factory=list)
