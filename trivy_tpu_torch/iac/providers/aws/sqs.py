"""AWS SQS typed state (reference: pkg/iac/providers/aws/sqs).

Copied from `trivy_tpu/iac/providers/aws/sqs.py`;
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
class Encryption:
    metadata: Metadata
    kms_key_id: StringValue
    managed_encryption: BoolValue


@dataclass
class Queue:
    metadata: Metadata
    encryption: Encryption
    policies: list[StringValue] = field(default_factory=list)


@dataclass
class SQS:
    queues: list[Queue] = field(default_factory=list)
