"""IaC engine: rego-subset evaluator + per-format parsers + builtin checks.

The reference's largest subsystem (pkg/iac, 47k LoC) reduced to its
load-bearing core: policy-as-code evaluation (iac/rego.py) over structured
inputs (iac/inputs.py, iac/hcl.py), with the builtin check corpus as .rego
sources (iac/checks/) exactly like the trivy-checks bundle.

Copied from `trivy_tpu/iac/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.iac.engine import IacScanner, load_checks

__all__ = ["IacScanner", "load_checks"]
