"""Adapters lowering raw IaC parses into typed provider state
(reference: pkg/iac/adapters).

Copied from `trivy_tpu/iac/adapters/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.iac.adapters.cloudformation import adapt_cloudformation  # noqa: F401
from trivy_tpu_torch.iac.adapters.terraform import adapt_terraform  # noqa: F401
