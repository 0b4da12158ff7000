"""AWS provider state (reference: pkg/iac/providers/aws).

Copied from `trivy_tpu/iac/providers/aws/__init__.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.iac.providers.aws import (
    cloudtrail,
    ec2,
    elb,
    iam,
    kms,
    rds,
    s3,
    sqs,
)


@dataclass
class AWS:
    s3: s3.S3 = field(default_factory=s3.S3)
    ec2: ec2.EC2 = field(default_factory=ec2.EC2)
    iam: iam.IAM = field(default_factory=iam.IAM)
    rds: rds.RDS = field(default_factory=rds.RDS)
    cloudtrail: cloudtrail.CloudTrail = field(
        default_factory=cloudtrail.CloudTrail
    )
    sqs: sqs.SQS = field(default_factory=sqs.SQS)
    kms: kms.KMS = field(default_factory=kms.KMS)
    elb: elb.ELB = field(default_factory=elb.ELB)
