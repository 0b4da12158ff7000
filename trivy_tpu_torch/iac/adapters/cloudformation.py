"""CloudFormation -> typed provider state (reference:
pkg/iac/adapters/cloudformation/aws).

Input is the template document ``iac/inputs.py cloudformation_input``
produces: ``{"Resources": {logical_id: {"Type": "AWS::S3::Bucket",
"Properties": {...}}}}`` with intrinsics folded to ``Fn::*`` /
``Ref`` dict forms.  Those unresolved intrinsics adapt as
*unresolvable* fields, matching the terraform adapter's handling of
opaque references.

Copied from `trivy_tpu/iac/adapters/cloudformation.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from typing import Any

from trivy_tpu_torch.iac.providers.aws import (
    cloudtrail as ct,
    ec2,
    elb,
    kms,
    rds,
    s3,
    sqs,
)
from trivy_tpu_torch.iac.providers.state import State
from trivy_tpu_torch.iac.providers.types import (
    Bool,
    BoolDefault,
    Int,
    IntDefault,
    Metadata,
    Range,
    String,
    StringDefault,
)

_INTRINSIC_KEYS = ("Ref", "Fn::GetAtt", "Fn::Sub", "Fn::Join", "Fn::If",
                   "Fn::ImportValue", "Fn::Select", "Fn::FindInMap")


def _unresolved(v: Any) -> bool:
    return isinstance(v, dict) and any(k in v for k in _INTRINSIC_KEYS)


class _CfnRes:
    def __init__(self, logical_id: str, body: dict, filename: str):
        self.logical_id = logical_id
        self.props = body.get("Properties") or {}
        if not isinstance(self.props, dict):
            self.props = {}
        self.meta = Metadata(
            rng=Range(
                filename=filename,
                start_line=int(body.get("__startline__", 0) or 0),
                end_line=int(body.get("__endline__", 0) or 0),
            ),
            reference=logical_id,
        )

    def bool(self, name: str, default: bool = False,
             props: dict | None = None) -> Any:
        p = self.props if props is None else props
        if name not in p:
            return BoolDefault(default, self.meta)
        v = p[name]
        if _unresolved(v):
            return BoolDefault(default, self.meta.with_(unresolvable=True))
        if isinstance(v, str):
            v = v.strip().lower() == "true"
        return Bool(v, self.meta)

    def string(self, name: str, default: str = "",
               props: dict | None = None) -> Any:
        p = self.props if props is None else props
        if name not in p:
            return StringDefault(default, self.meta)
        v = p[name]
        if _unresolved(v):
            return StringDefault(default, self.meta.with_(unresolvable=True))
        return String(v, self.meta)

    def int(self, name: str, default: int = 0) -> Any:
        if name not in self.props:
            return IntDefault(default, self.meta)
        v = self.props[name]
        if _unresolved(v):
            return IntDefault(default, self.meta.with_(unresolvable=True))
        return Int(v, self.meta)


def adapt_cloudformation(doc: dict, filename: str = "") -> State:
    state = State()
    resources = doc.get("Resources")
    if not isinstance(resources, dict):
        return state
    by_type: dict[str, list[_CfnRes]] = {}
    for lid, body in resources.items():
        if not isinstance(body, dict):
            continue
        rtype = str(body.get("Type", ""))
        by_type.setdefault(rtype, []).append(_CfnRes(lid, body, filename))

    for r in by_type.get("AWS::S3::Bucket", []):
        state.aws.s3.buckets.append(_cfn_bucket(r))
    for r in by_type.get("AWS::EC2::SecurityGroup", []):
        state.aws.ec2.security_groups.append(_cfn_security_group(r))
    for r in by_type.get("AWS::EC2::Instance", []):
        state.aws.ec2.instances.append(_cfn_instance(r))
    for r in by_type.get("AWS::RDS::DBInstance", []):
        state.aws.rds.instances.append(
            rds.Instance(
                metadata=r.meta,
                encryption=rds.Encryption(
                    metadata=r.meta,
                    encrypt_storage=r.bool("StorageEncrypted"),
                    kms_key_id=r.string("KmsKeyId"),
                ),
                public_access=r.bool("PubliclyAccessible"),
                backup_retention_period_days=r.int("BackupRetentionPeriod",
                                                   default=1),
                replication_source_arn=r.string(
                    "SourceDBInstanceIdentifier"
                ),
            )
        )
    for r in by_type.get("AWS::CloudTrail::Trail", []):
        state.aws.cloudtrail.trails.append(
            ct.Trail(
                metadata=r.meta,
                name=r.string("TrailName"),
                is_multi_region=r.bool("IsMultiRegionTrail"),
                enable_log_file_validation=r.bool("EnableLogFileValidation"),
                kms_key_id=r.string("KMSKeyId"),
                bucket_name=r.string("S3BucketName"),
                is_logging=r.bool("IsLogging", default=True),
            )
        )
    for r in by_type.get("AWS::SQS::Queue", []):
        state.aws.sqs.queues.append(
            sqs.Queue(
                metadata=r.meta,
                encryption=sqs.Encryption(
                    metadata=r.meta,
                    kms_key_id=r.string("KmsMasterKeyId"),
                    managed_encryption=r.bool("SqsManagedSseEnabled"),
                ),
            )
        )
    for r in by_type.get("AWS::KMS::Key", []):
        state.aws.kms.keys.append(
            kms.Key(
                metadata=r.meta,
                usage=r.string("KeyUsage", default="ENCRYPT_DECRYPT"),
                rotation_enabled=r.bool("EnableKeyRotation"),
            )
        )
    _cfn_elb(by_type, state)
    return state


def _cfn_bucket(r: _CfnRes) -> s3.Bucket:
    props = r.props
    pab = None
    pab_props = props.get("PublicAccessBlockConfiguration")
    if isinstance(pab_props, dict):
        pab = s3.PublicAccessBlock(
            metadata=r.meta,
            block_public_acls=r.bool("BlockPublicAcls", props=pab_props),
            block_public_policy=r.bool("BlockPublicPolicy", props=pab_props),
            ignore_public_acls=r.bool("IgnorePublicAcls", props=pab_props),
            restrict_public_buckets=r.bool("RestrictPublicBuckets",
                                           props=pab_props),
        )
    enc_enabled, algorithm, kms_id = False, None, None
    be = props.get("BucketEncryption")
    if isinstance(be, dict):
        for rule in be.get("ServerSideEncryptionConfiguration") or []:
            if not isinstance(rule, dict):
                continue
            by_default = rule.get("ServerSideEncryptionByDefault")
            if isinstance(by_default, dict):
                enc_enabled = True
                algorithm = by_default.get("SSEAlgorithm")
                kms_id = by_default.get("KMSMasterKeyID")
    vc = props.get("VersioningConfiguration")
    versioned = (
        isinstance(vc, dict) and str(vc.get("Status", "")) == "Enabled"
    )
    lc = props.get("LoggingConfiguration")
    target = lc.get("DestinationBucketName") if isinstance(lc, dict) else None
    # CFN AccessControl values are CamelCase ("PublicRead"); checks
    # compare against the canned-ACL wire form ("public-read").
    acl_raw = props.get("AccessControl")
    acl_map = {
        "Private": "private",
        "PublicRead": "public-read",
        "PublicReadWrite": "public-read-write",
        "AuthenticatedRead": "authenticated-read",
        "LogDeliveryWrite": "log-delivery-write",
        "BucketOwnerRead": "bucket-owner-read",
        "BucketOwnerFullControl": "bucket-owner-full-control",
    }
    acl = (
        String(acl_map.get(str(acl_raw), str(acl_raw)), r.meta)
        if acl_raw is not None and not _unresolved(acl_raw)
        else StringDefault("private", r.meta)
    )
    return s3.Bucket(
        metadata=r.meta,
        name=r.string("BucketName"),
        acl=acl,
        encryption=s3.Encryption(
            metadata=r.meta,
            enabled=Bool(enc_enabled, r.meta, explicit=be is not None),
            algorithm=String(algorithm or "", r.meta,
                             explicit=algorithm is not None),
            kms_key_id=(
                String(kms_id, r.meta)
                if kms_id is not None and not _unresolved(kms_id)
                else StringDefault("", r.meta)
            ),
        ),
        versioning=s3.Versioning(
            metadata=r.meta,
            enabled=Bool(versioned, r.meta, explicit=vc is not None),
            mfa_delete=BoolDefault(False, r.meta),
        ),
        logging=s3.Logging(
            metadata=r.meta,
            enabled=Bool(target is not None, r.meta,
                         explicit=lc is not None),
            target_bucket=(
                String(target, r.meta)
                if target is not None and not _unresolved(target)
                else StringDefault("", r.meta)
            ),
        ),
        public_access_block=pab,
    )


def _cfn_security_group(r: _CfnRes) -> ec2.SecurityGroup:
    sg = ec2.SecurityGroup(
        metadata=r.meta,
        description=r.string("GroupDescription"),
    )
    for key, dest in (
        ("SecurityGroupIngress", sg.ingress_rules),
        ("SecurityGroupEgress", sg.egress_rules),
    ):
        for rule in r.props.get(key) or []:
            if not isinstance(rule, dict):
                continue
            cidrs = []
            for ck in ("CidrIp", "CidrIpv6"):
                if ck in rule and not _unresolved(rule[ck]):
                    cidrs.append(String(rule[ck], r.meta))
            dest.append(
                ec2.SecurityGroupRule(
                    metadata=r.meta,
                    description=r.string("Description", props=rule),
                    cidrs=cidrs,
                )
            )
    return sg


def _cfn_instance(r: _CfnRes) -> ec2.Instance:
    inst = ec2.Instance(
        metadata=r.meta,
        metadata_options=ec2.MetadataOptions(
            metadata=r.meta,
            # AWS::EC2::Instance has no MetadataOptions property; the
            # account default is IMDSv1-compatible
            http_tokens=StringDefault("optional", r.meta),
            http_endpoint=StringDefault("enabled", r.meta),
        ),
    )
    for bdm in r.props.get("BlockDeviceMappings") or []:
        if not isinstance(bdm, dict):
            continue
        ebs = bdm.get("Ebs")
        if not isinstance(ebs, dict):
            continue
        dev = ec2.BlockDevice(
            metadata=r.meta,
            encrypted=r.bool("Encrypted", props=ebs),
        )
        if inst.root_block_device is None:
            inst.root_block_device = dev
        else:
            inst.ebs_block_devices.append(dev)
    if inst.root_block_device is None:
        inst.root_block_device = ec2.BlockDevice(
            metadata=r.meta, encrypted=BoolDefault(False, r.meta)
        )
    return inst


def _cfn_elb(by_type: dict[str, list[_CfnRes]], state: State) -> None:
    lbs: list[tuple[_CfnRes, elb.LoadBalancer]] = []
    for r in by_type.get("AWS::ElasticLoadBalancingV2::LoadBalancer", []):
        drop = False
        for attr in r.props.get("LoadBalancerAttributes") or []:
            if (
                isinstance(attr, dict)
                and attr.get("Key")
                == "routing.http.drop_invalid_header_fields.enabled"
                and str(attr.get("Value", "")).lower() == "true"
            ):
                drop = True
        lb = elb.LoadBalancer(
            metadata=r.meta,
            type=r.string("Type", default=elb.TYPE_APPLICATION),
            internal=Bool(
                str(r.props.get("Scheme", "")) == "internal", r.meta,
                explicit="Scheme" in r.props,
            ),
            drop_invalid_header_fields=Bool(
                drop, r.meta,
                explicit="LoadBalancerAttributes" in r.props,
            ),
        )
        lbs.append((r, lb))
        state.aws.elb.load_balancers.append(lb)
    for r in by_type.get("AWS::ElasticLoadBalancingV2::Listener", []):
        listener = elb.Listener(
            metadata=r.meta,
            protocol=r.string("Protocol"),
            tls_policy=r.string("SslPolicy"),
            default_actions=[
                elb.Action(metadata=r.meta,
                           type=r.string("Type", props=act))
                for act in r.props.get("DefaultActions") or []
                if isinstance(act, dict)
            ],
        )
        arn = r.props.get("LoadBalancerArn")
        attached = False
        if isinstance(arn, dict):
            target = arn.get("Ref") or arn.get("Fn::GetAtt")
            if isinstance(target, list):
                target = target[0] if target else None
            for lr, lb in lbs:
                if target == lr.logical_id:
                    lb.listeners.append(listener)
                    attached = True
                    break
        if not attached and lbs:
            lbs[0][1].listeners.append(listener)
