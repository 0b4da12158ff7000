"""AWS EC2 typed state (reference: pkg/iac/providers/aws/ec2).

Copied from `trivy_tpu/iac/providers/aws/ec2.py`;
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
class MetadataOptions:
    metadata: Metadata
    http_tokens: StringValue
    http_endpoint: StringValue


@dataclass
class BlockDevice:
    metadata: Metadata
    encrypted: BoolValue


@dataclass
class Instance:
    metadata: Metadata
    metadata_options: MetadataOptions
    root_block_device: BlockDevice | None = None
    ebs_block_devices: list[BlockDevice] = field(default_factory=list)


@dataclass
class SecurityGroupRule:
    metadata: Metadata
    description: StringValue
    cidrs: list[StringValue] = field(default_factory=list)


@dataclass
class SecurityGroup:
    metadata: Metadata
    description: StringValue
    ingress_rules: list[SecurityGroupRule] = field(default_factory=list)
    egress_rules: list[SecurityGroupRule] = field(default_factory=list)
    is_default: BoolValue | None = None


@dataclass
class EC2:
    instances: list[Instance] = field(default_factory=list)
    security_groups: list[SecurityGroup] = field(default_factory=list)
