"""AWS ELB(v2) typed state (reference: pkg/iac/providers/aws/elb).

Copied from `trivy_tpu/iac/providers/aws/elb.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.types import (
    BoolValue,
    Metadata,
    StringValue,
)

TYPE_APPLICATION = "application"
TYPE_NETWORK = "network"


@dataclass
class Action:
    metadata: Metadata
    type: StringValue


@dataclass
class Listener:
    metadata: Metadata
    protocol: StringValue
    tls_policy: StringValue
    default_actions: list[Action] = field(default_factory=list)


@dataclass
class LoadBalancer:
    metadata: Metadata
    type: StringValue
    internal: BoolValue
    drop_invalid_header_fields: BoolValue
    listeners: list[Listener] = field(default_factory=list)


@dataclass
class ELB:
    load_balancers: list[LoadBalancer] = field(default_factory=list)
