"""Typed cloud provider state (reference: pkg/iac/providers).

Adapters (trivy_tpu_torch/iac/adapters) lower raw terraform / CloudFormation /
live-account parses into these dataclasses; ``state.State.to_rego()``
exposes the result to rego checks as ``input.aws.s3.buckets[...]`` with
the same key naming the real trivy-checks bundle addresses.

Copied from `trivy_tpu/iac/providers/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.iac.providers.state import State  # noqa: F401
