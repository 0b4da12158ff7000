"""AWS cloud scanning (pkg/cloud/aws).

Enumerates live account resources over the AWS APIs (SigV4, stdlib HTTP),
adapts them into the same conftest-style resource documents the terraform
checks evaluate, and reports per-service findings — one policy corpus for
IaC and live cloud state, the reference's own design (its cloud scans run
the same AVD checks against adapted state).

Copied from `trivy_tpu/cloud/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.cloud.aws import AwsScanner, AwsError

__all__ = ["AwsScanner", "AwsError"]
