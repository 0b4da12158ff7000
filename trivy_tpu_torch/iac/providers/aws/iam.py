"""AWS IAM typed state (reference: pkg/iac/providers/aws/iam).

Copied from `trivy_tpu/iac/providers/aws/iam.py`;
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
class Document:
    metadata: Metadata
    value: StringValue  # raw JSON policy document


@dataclass
class Policy:
    metadata: Metadata
    name: StringValue
    document: Document


@dataclass
class PasswordPolicy:
    metadata: Metadata
    minimum_length: IntValue
    require_uppercase: BoolValue
    require_lowercase: BoolValue
    require_symbols: BoolValue
    require_numbers: BoolValue
    max_age_days: IntValue
    reuse_prevention_count: IntValue


@dataclass
class IAM:
    policies: list[Policy] = field(default_factory=list)
    password_policy: PasswordPolicy | None = None
