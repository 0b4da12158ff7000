"""AWS KMS typed state (reference: pkg/iac/providers/aws/kms).

Copied from `trivy_tpu/iac/providers/aws/kms.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import (
    BoolValue,
    Metadata,
    StringValue,
)

KEY_USAGE_SIGN = "SIGN_VERIFY"


@dataclass
class Key:
    metadata: Metadata
    usage: StringValue
    rotation_enabled: BoolValue


@dataclass
class KMS:
    keys: list[Key] = field(default_factory=list)
