"""Terraform -> typed provider state (reference:
pkg/iac/adapters/terraform/adapt.go and its per-service subpackages).

Input is the conftest-style document ``iac/hcl.py`` produces:
``{"resource": {"aws_s3_bucket": {"logs": {...attrs..., "__startline__",
"__endline__"}}}}``.  Blocks carry line markers; attributes don't, so a
field's range is its enclosing block's range.  A field is *explicit*
when the attribute is present, *default* otherwise, and *unresolvable*
when the parser left an opaque reference string (hcl._RefStr).

Handles both the AWS-provider-v3 inline style (acl / versioning /
server_side_encryption_configuration blocks on aws_s3_bucket) and the
v4+ split-resource style (aws_s3_bucket_acl, aws_s3_bucket_versioning,
aws_s3_bucket_public_access_block... matched back to their bucket by
the ``bucket`` attribute, by label reference or by name).

Copied from `trivy_tpu/iac/adapters/terraform.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

from trivy_tpu_torch.iac.hcl import _RefStr
from trivy_tpu_torch.iac.providers.aws import (
    cloudtrail as ct,
    ec2,
    elb,
    iam,
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
    StringValue,
)


class _Res:
    """One terraform resource instance with attr/block accessors."""

    def __init__(self, rtype: str, label: str, body: dict, filename: str):
        self.rtype = rtype
        self.label = label
        self.body = body
        self.filename = filename

    @property
    def reference(self) -> str:
        return f"{self.rtype}.{self.label}"

    def rng(self, body: dict | None = None) -> Range:
        b = body if body is not None else self.body
        return Range(
            filename=self.filename,
            start_line=int(b.get("__startline__", 0) or 0),
            end_line=int(b.get("__endline__", 0) or 0),
        )

    def meta(self, body: dict | None = None) -> Metadata:
        return Metadata(rng=self.rng(body), reference=self.reference)

    def attr(self, name: str, body: dict | None = None) -> Any:
        b = body if body is not None else self.body
        return b.get(name)

    def has(self, name: str, body: dict | None = None) -> bool:
        b = body if body is not None else self.body
        return name in b

    def blocks(self, name: str, body: dict | None = None) -> list[dict]:
        """Nested blocks normalised to a list (hcl.py accumulates
        repeated blocks into lists, single blocks stay dicts)."""
        v = (body if body is not None else self.body).get(name)
        if isinstance(v, dict):
            return [v]
        if isinstance(v, list):
            return [b for b in v if isinstance(b, dict)]
        return []

    # -- typed field constructors -------------------------------------
    def bool(self, name: str, default: bool = False,
             body: dict | None = None) -> Any:
        m = self.meta(body)
        if not self.has(name, body):
            return BoolDefault(default, m)
        v = self.attr(name, body)
        if isinstance(v, _RefStr):
            return BoolDefault(default, m.with_(unresolvable=True))
        return Bool(_truthy(v), m)

    def string(self, name: str, default: str = "",
               body: dict | None = None) -> StringValue:
        m = self.meta(body)
        if not self.has(name, body):
            return StringDefault(default, m)
        v = self.attr(name, body)
        if isinstance(v, _RefStr):
            return StringDefault(default, m.with_(unresolvable=True))
        return String(v, m)

    def int(self, name: str, default: int = 0,
            body: dict | None = None) -> Any:
        m = self.meta(body)
        if not self.has(name, body):
            return IntDefault(default, m)
        v = self.attr(name, body)
        if isinstance(v, _RefStr):
            return IntDefault(default, m.with_(unresolvable=True))
        return Int(v, m)


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "enabled", "yes", "on")
    return bool(v)


def _iter_resources(docs: list[dict], filename: str) -> Iterator[_Res]:
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        resources = doc.get("resource")
        if not isinstance(resources, dict):
            continue
        for rtype, insts in resources.items():
            if not isinstance(insts, dict):
                continue
            for label, body in insts.items():
                if isinstance(body, dict):
                    yield _Res(rtype, label, body, filename)
                elif isinstance(body, list):
                    for b in body:
                        if isinstance(b, dict):
                            yield _Res(rtype, label, b, filename)


def _refers_to(value: Any, res: _Res, name_attr: str = "bucket") -> bool:
    """Does a split-resource's parent attribute point at `res`?  Either
    an unresolved reference (`aws_s3_bucket.logs.id`) or the parent's
    literal name."""
    if value is None:
        return False
    sval = str(value)
    if f"{res.rtype}.{res.label}" in sval:
        return True
    own = res.attr(name_attr)
    return own is not None and not isinstance(own, _RefStr) and sval == str(own)


def adapt_terraform(docs: list[dict], filename: str = "") -> State:
    """Lower conftest-style terraform documents into one State."""
    all_res = list(_iter_resources(docs, filename))
    by_type: dict[str, list[_Res]] = {}
    for r in all_res:
        by_type.setdefault(r.rtype, []).append(r)

    state = State()
    _adapt_s3(by_type, state)
    _adapt_ec2(by_type, state)
    _adapt_iam(by_type, state)
    _adapt_rds(by_type, state)
    _adapt_cloudtrail(by_type, state)
    _adapt_sqs(by_type, state)
    _adapt_kms(by_type, state)
    _adapt_elb(by_type, state)
    return state


# ---------------------------------------------------------------- s3


def _adapt_s3(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_s3_bucket", []):
        bucket = s3.Bucket(
            metadata=r.meta(),
            name=r.string("bucket"),
            acl=r.string("acl", default="private"),
            encryption=_s3_encryption(r),
            versioning=_s3_versioning(r),
            logging=_s3_logging(r),
        )
        _s3_split_resources(by_type, r, bucket)
        state.aws.s3.buckets.append(bucket)


def _s3_encryption(r: _Res, body: dict | None = None,
                   owner: _Res | None = None) -> s3.Encryption:
    owner = owner or r
    enc_blocks = r.blocks("server_side_encryption_configuration", body)
    for enc in enc_blocks:
        for rule in r.blocks("rule", enc) or [enc]:
            for by_default in r.blocks(
                "apply_server_side_encryption_by_default", rule
            ):
                m = Metadata(rng=r.rng(by_default), reference=owner.reference)
                algorithm = by_default.get("sse_algorithm")
                return s3.Encryption(
                    metadata=m,
                    enabled=Bool(True, m),
                    algorithm=String(algorithm or "", m,
                                     explicit=algorithm is not None),
                    kms_key_id=String(
                        by_default.get("kms_master_key_id") or "", m,
                        explicit="kms_master_key_id" in by_default,
                    ),
                )
            # cloud-scan adapters flatten the v4 wrapper away and put
            # sse_algorithm directly on the rule
            if rule.get("sse_algorithm"):
                m = Metadata(rng=r.rng(rule), reference=owner.reference)
                algorithm = rule.get("sse_algorithm")
                return s3.Encryption(
                    metadata=m,
                    enabled=Bool(True, m),
                    algorithm=String(
                        algorithm if isinstance(algorithm, str) else "", m,
                        explicit=isinstance(algorithm, str),
                    ),
                    kms_key_id=String(
                        rule.get("kms_master_key_id") or "", m,
                        explicit="kms_master_key_id" in rule,
                    ),
                )
    m = r.meta(body)
    return s3.Encryption(
        metadata=m,
        enabled=BoolDefault(False, m),
        algorithm=StringDefault("", m),
        kms_key_id=StringDefault("", m),
    )


def _s3_versioning(r: _Res, body: dict | None = None,
                   owner: _Res | None = None) -> s3.Versioning:
    owner = owner or r
    # v3 inline block: versioning { enabled = true } — v4 split
    # resource: versioning_configuration { status = "Enabled" }.
    for v in r.blocks("versioning", body):
        m = Metadata(rng=r.rng(v), reference=owner.reference)
        return s3.Versioning(
            metadata=m,
            enabled=Bool(_truthy(v.get("enabled")), m),
            mfa_delete=Bool(_truthy(v.get("mfa_delete")), m,
                            explicit="mfa_delete" in v),
        )
    for v in r.blocks("versioning_configuration", body):
        m = Metadata(rng=r.rng(v), reference=owner.reference)
        return s3.Versioning(
            metadata=m,
            enabled=Bool(str(v.get("status", "")).lower() == "enabled", m),
            mfa_delete=Bool(
                str(v.get("mfa_delete", "")).lower() == "enabled", m,
                explicit="mfa_delete" in v,
            ),
        )
    m = r.meta(body)
    return s3.Versioning(
        metadata=m,
        enabled=BoolDefault(False, m),
        mfa_delete=BoolDefault(False, m),
    )


def _s3_logging(r: _Res, body: dict | None = None,
                owner: _Res | None = None) -> s3.Logging:
    owner = owner or r
    for lg in r.blocks("logging", body):
        m = Metadata(rng=r.rng(lg), reference=owner.reference)
        tb = lg.get("target_bucket")
        return s3.Logging(
            metadata=m,
            enabled=Bool(tb is not None, m),
            target_bucket=String("" if isinstance(tb, _RefStr) else tb, m,
                                 explicit=not isinstance(tb, _RefStr)),
        )
    m = r.meta(body)
    return s3.Logging(
        metadata=m,
        enabled=BoolDefault(False, m),
        target_bucket=StringDefault("", m),
    )


def _s3_split_resources(by_type: dict[str, list[_Res]], r: _Res,
                        bucket: s3.Bucket) -> None:
    """Attach v4 split resources to their bucket."""
    for pab in by_type.get("aws_s3_bucket_public_access_block", []):
        if not _refers_to(pab.attr("bucket"), r):
            continue
        m = Metadata(rng=pab.rng(), reference=r.reference)
        bucket.public_access_block = s3.PublicAccessBlock(
            metadata=m,
            block_public_acls=pab.bool("block_public_acls"),
            block_public_policy=pab.bool("block_public_policy"),
            ignore_public_acls=pab.bool("ignore_public_acls"),
            restrict_public_buckets=pab.bool("restrict_public_buckets"),
        )
    for acl in by_type.get("aws_s3_bucket_acl", []):
        if _refers_to(acl.attr("bucket"), r) and acl.has("acl"):
            bucket.acl = acl.string("acl", default="private")
    for ver in by_type.get("aws_s3_bucket_versioning", []):
        if _refers_to(ver.attr("bucket"), r):
            bucket.versioning = _s3_versioning(ver, owner=r)
    for enc in by_type.get(
        "aws_s3_bucket_server_side_encryption_configuration", []
    ):
        if not _refers_to(enc.attr("bucket"), r):
            continue
        # split resource nests rule{} directly under the resource body
        wrapped = {
            "server_side_encryption_configuration": enc.body,
            "__startline__": enc.body.get("__startline__", 0),
            "__endline__": enc.body.get("__endline__", 0),
        }
        bucket.encryption = _s3_encryption(
            _Res(enc.rtype, enc.label, wrapped, enc.filename), owner=r
        )
    for lg in by_type.get("aws_s3_bucket_logging", []):
        if _refers_to(lg.attr("bucket"), r):
            m = Metadata(rng=lg.rng(), reference=r.reference)
            tb = lg.attr("target_bucket")
            bucket.logging = s3.Logging(
                metadata=m,
                enabled=Bool(tb is not None, m),
                target_bucket=lg.string("target_bucket"),
            )


# --------------------------------------------------------------- ec2


def _adapt_ec2(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_instance", []):
        mo_blocks = r.blocks("metadata_options")
        if mo_blocks:
            mo = mo_blocks[0]
            m = Metadata(rng=r.rng(mo), reference=r.reference)
            opts = ec2.MetadataOptions(
                metadata=m,
                http_tokens=String(mo.get("http_tokens") or "optional", m,
                                   explicit="http_tokens" in mo),
                http_endpoint=String(mo.get("http_endpoint") or "enabled", m,
                                     explicit="http_endpoint" in mo),
            )
        else:
            m = r.meta()
            opts = ec2.MetadataOptions(
                metadata=m,
                # AWS launches without a block as IMDSv1-compatible
                http_tokens=StringDefault("optional", m),
                http_endpoint=StringDefault("enabled", m),
            )
        inst = ec2.Instance(metadata=r.meta(), metadata_options=opts)
        for rbd in r.blocks("root_block_device"):
            m = Metadata(rng=r.rng(rbd), reference=r.reference)
            inst.root_block_device = ec2.BlockDevice(
                metadata=m,
                encrypted=Bool(_truthy(rbd.get("encrypted")), m,
                               explicit="encrypted" in rbd),
            )
        if inst.root_block_device is None:
            m = r.meta()
            inst.root_block_device = ec2.BlockDevice(
                metadata=m, encrypted=BoolDefault(False, m)
            )
        for ebd in r.blocks("ebs_block_device"):
            m = Metadata(rng=r.rng(ebd), reference=r.reference)
            inst.ebs_block_devices.append(
                ec2.BlockDevice(
                    metadata=m,
                    encrypted=Bool(_truthy(ebd.get("encrypted")), m,
                                   explicit="encrypted" in ebd),
                )
            )
        state.aws.ec2.instances.append(inst)

    for r in by_type.get("aws_security_group", []):
        sg = ec2.SecurityGroup(
            metadata=r.meta(),
            description=r.string("description"),
        )
        for kind, dest in (
            ("ingress", sg.ingress_rules),
            ("egress", sg.egress_rules),
        ):
            for blk in r.blocks(kind):
                dest.append(_sg_rule(r, blk))
        # standalone aws_security_group_rule resources referencing this
        # group by id
        for rule in by_type.get("aws_security_group_rule", []):
            if not _refers_to(rule.attr("security_group_id"), r,
                              name_attr="name"):
                continue
            typed = _sg_rule(rule, rule.body)
            if str(rule.attr("type") or "ingress") == "egress":
                sg.egress_rules.append(typed)
            else:
                sg.ingress_rules.append(typed)
        state.aws.ec2.security_groups.append(sg)

    for r in by_type.get("aws_default_vpc", []):
        m = r.meta()
        state.aws.ec2.security_groups.append(
            ec2.SecurityGroup(
                metadata=m,
                description=StringDefault("Default VPC security group", m),
                is_default=Bool(True, m),
            )
        )


def _sg_rule(r: _Res, blk: dict) -> ec2.SecurityGroupRule:
    m = Metadata(rng=r.rng(blk), reference=r.reference)
    cidrs: list[StringValue] = []
    raw = blk.get("cidr_blocks") or []
    if isinstance(raw, (str, _RefStr)):
        raw = [raw]
    for c in raw:
        if isinstance(c, _RefStr):
            cidrs.append(StringDefault("", m.with_(unresolvable=True)))
        else:
            cidrs.append(String(c, m))
    return ec2.SecurityGroupRule(
        metadata=m,
        description=String(blk.get("description") or "", m,
                           explicit="description" in blk),
        cidrs=cidrs,
    )


# --------------------------------------------------------------- iam


def _adapt_iam(by_type: dict[str, list[_Res]], state: State) -> None:
    for rtype in ("aws_iam_policy", "aws_iam_role_policy",
                  "aws_iam_user_policy", "aws_iam_group_policy"):
        for r in by_type.get(rtype, []):
            m = r.meta()
            raw = r.attr("policy")
            if isinstance(raw, (dict, list)):
                raw = json.dumps(raw)
            doc = iam.Document(
                metadata=m,
                value=String("" if isinstance(raw, _RefStr) else raw or "", m,
                             explicit=r.has("policy")),
            )
            state.aws.iam.policies.append(
                iam.Policy(metadata=m, name=r.string("name"), document=doc)
            )
    for r in by_type.get("aws_iam_account_password_policy", []):
        m = r.meta()
        state.aws.iam.password_policy = iam.PasswordPolicy(
            metadata=m,
            minimum_length=r.int("minimum_password_length", default=6),
            require_uppercase=r.bool("require_uppercase_characters"),
            require_lowercase=r.bool("require_lowercase_characters"),
            require_symbols=r.bool("require_symbols"),
            require_numbers=r.bool("require_numbers"),
            max_age_days=r.int("max_password_age", default=0),
            reuse_prevention_count=r.int("password_reuse_prevention",
                                         default=0),
        )


# --------------------------------------------------------------- rds


def _rds_encryption(r: _Res) -> rds.Encryption:
    m = r.meta()
    return rds.Encryption(
        metadata=m,
        encrypt_storage=r.bool("storage_encrypted"),
        kms_key_id=r.string("kms_key_id"),
    )


def _adapt_rds(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_db_instance", []):
        state.aws.rds.instances.append(
            rds.Instance(
                metadata=r.meta(),
                encryption=_rds_encryption(r),
                public_access=r.bool("publicly_accessible"),
                backup_retention_period_days=r.int(
                    "backup_retention_period", default=0
                ),
                replication_source_arn=r.string("replicate_source_db"),
            )
        )
    for r in by_type.get("aws_rds_cluster", []):
        state.aws.rds.clusters.append(
            rds.Cluster(
                metadata=r.meta(),
                encryption=_rds_encryption(r),
                backup_retention_period_days=r.int(
                    "backup_retention_period", default=1
                ),
            )
        )


# --------------------------------------------------------- cloudtrail


def _adapt_cloudtrail(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_cloudtrail", []):
        state.aws.cloudtrail.trails.append(
            ct.Trail(
                metadata=r.meta(),
                name=r.string("name"),
                is_multi_region=r.bool("is_multi_region_trail"),
                enable_log_file_validation=r.bool(
                    "enable_log_file_validation"
                ),
                kms_key_id=r.string("kms_key_id"),
                bucket_name=r.string("s3_bucket_name"),
                is_logging=r.bool("enable_logging", default=True),
            )
        )


# --------------------------------------------------------------- sqs


def _adapt_sqs(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_sqs_queue", []):
        m = r.meta()
        state.aws.sqs.queues.append(
            sqs.Queue(
                metadata=m,
                encryption=sqs.Encryption(
                    metadata=m,
                    kms_key_id=r.string("kms_master_key_id"),
                    managed_encryption=r.bool("sqs_managed_sse_enabled"),
                ),
            )
        )


# --------------------------------------------------------------- kms


def _adapt_kms(by_type: dict[str, list[_Res]], state: State) -> None:
    for r in by_type.get("aws_kms_key", []):
        state.aws.kms.keys.append(
            kms.Key(
                metadata=r.meta(),
                usage=r.string("key_usage", default="ENCRYPT_DECRYPT"),
                rotation_enabled=r.bool("enable_key_rotation"),
            )
        )


# --------------------------------------------------------------- elb


def _adapt_elb(by_type: dict[str, list[_Res]], state: State) -> None:
    lbs: list[tuple[_Res, elb.LoadBalancer]] = []
    for rtype in ("aws_lb", "aws_alb"):
        for r in by_type.get(rtype, []):
            lb = elb.LoadBalancer(
                metadata=r.meta(),
                type=r.string("load_balancer_type",
                              default=elb.TYPE_APPLICATION),
                internal=r.bool("internal"),
                drop_invalid_header_fields=r.bool(
                    "drop_invalid_header_fields"
                ),
            )
            lbs.append((r, lb))
            state.aws.elb.load_balancers.append(lb)
    for rtype in ("aws_lb_listener", "aws_alb_listener"):
        for lr in by_type.get(rtype, []):
            listener = elb.Listener(
                metadata=lr.meta(),
                protocol=lr.string("protocol"),
                tls_policy=lr.string("ssl_policy"),
                default_actions=[
                    elb.Action(
                        metadata=Metadata(rng=lr.rng(act),
                                          reference=lr.reference),
                        type=String(act.get("type") or "", Metadata(
                            rng=lr.rng(act), reference=lr.reference
                        ), explicit="type" in act),
                    )
                    for act in lr.blocks("default_action")
                ],
            )
            arn = lr.attr("load_balancer_arn")
            for r, lb in lbs:
                if _refers_to(arn, r, name_attr="name"):
                    lb.listeners.append(listener)
                    break
            else:
                if lbs:
                    lbs[0][1].listeners.append(listener)
