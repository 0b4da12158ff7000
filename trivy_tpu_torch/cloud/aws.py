"""AWS account scanning: enumerate, adapt, evaluate.

Service adapters pull live state (S3 buckets with ACL/encryption/
versioning, EC2 instances with metadata options) through SigV4-signed XML
APIs and synthesize the conftest-style document the terraform AVD checks
already understand:

    {"resource": {"aws_s3_bucket": {...}, "aws_instance": {...}}}

so cloud scans and IaC scans share one policy corpus (the reference's
adapters feed the same rego state model, pkg/iac/adapters/cloud).

AWS_ENDPOINT_URL redirects every service to an S3-compatible/localstack
endpoint, which is also how the tests drive a fake account.

Copied from `trivy_tpu/cloud/aws.py`;
the port imports nothing from the JAX package.  The port adds the host spans
`aws.adapt` (one a service) and `aws.checks`.
"""

from __future__ import annotations

import logging
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from trivy_tpu_torch.cache.s3 import S3Client, S3Error

logger = logging.getLogger(__name__)

SUPPORTED_SERVICES = (
    "s3", "ec2", "rds", "iam", "cloudtrail", "kms",
    "sns", "sqs", "ecr", "eks", "dynamodb", "cloudfront", "efs",
    "kinesis", "logs", "lambda", "redshift", "ecs",
)


class AwsError(RuntimeError):
    pass


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _find(el, name):
    for child in el.iter():
        if _strip_ns(child.tag) == name:
            return child
    return None


def _findall(el, name):
    return [c for c in el.iter() if _strip_ns(c.tag) == name]


class _AwsApi(S3Client):
    """SigV4 requests with query strings + XML replies, riding the cache
    client's generalized signing (service/scope and canonical query are
    parameters of the base _request)."""

    def call(self, method: str, path_and_query: str) -> ET.Element | None:
        path, _, query = path_and_query.partition("?")
        if not path.startswith("/"):
            path = "/" + path
        try:
            status, payload = self._request(method, path, query=query)
        except S3Error as e:
            raise AwsError(str(e)) from e
        if status == 404:
            return None
        if status >= 400:
            raise AwsError(
                f"aws: {method} {path_and_query}: HTTP {status}: "
                f"{payload[:200]!r}"
            )
        if not payload:
            return None
        try:
            return ET.fromstring(payload)
        except ET.ParseError as e:
            raise AwsError(f"aws: bad XML from {path_and_query}: {e}") from e

    @staticmethod
    def _decode_json(status: int, payload: bytes, what: str) -> dict:
        import json as _json

        if status >= 400:
            raise AwsError(f"aws: {what}: HTTP {status}: {payload[:200]!r}")
        try:
            out = _json.loads(payload or b"{}")
        except ValueError as e:
            raise AwsError(f"aws: bad JSON from {what}: {e}") from e
        return out if isinstance(out, dict) else {}

    def call_json(self, target: str, body: dict) -> dict:
        """JSON-protocol service call (CloudTrail/KMS/DynamoDB/Kinesis):
        POST / with the x-amz-target routing header, amz-json-1.1 body."""
        import json as _json

        data = _json.dumps(body).encode()
        try:
            status, payload = self._request(
                "POST",
                "/",
                body=data,
                headers_extra={
                    "x-amz-target": target,
                    "content-type": "application/x-amz-json-1.1",
                },
            )
        except S3Error as e:
            raise AwsError(str(e)) from e
        return self._decode_json(status, payload, target)

    def call_rest_json(self, method: str, path: str) -> dict:
        """REST-JSON service call (EKS/EFS-style GET APIs)."""
        try:
            status, payload = self._request(method, path)
        except S3Error as e:
            raise AwsError(str(e)) from e
        return self._decode_json(status, payload, f"{method} {path}")


@dataclass
class AwsScanner:
    services: list[str] = field(default_factory=lambda: ["s3"])
    endpoint: str = ""
    region: str = ""
    errors: list[str] = field(default_factory=list)

    def _api(self, service: str) -> _AwsApi:
        import os

        endpoint = self.endpoint or os.environ.get("AWS_ENDPOINT_URL", "")
        # SigV4 signing name when it differs from the service key.
        sign = {"efs": "elasticfilesystem"}.get(service, service)
        if not endpoint:
            region = self.region or os.environ.get("AWS_REGION", "us-east-1")
            if service == "cloudfront":
                # Global control plane (no regional hostnames).
                endpoint = "https://cloudfront.amazonaws.com"
            elif service == "ecr":
                endpoint = f"https://api.ecr.{region}.amazonaws.com"
            else:
                endpoint = f"https://{sign}.{region}.amazonaws.com"
        return _AwsApi(
            bucket="", region=self.region, endpoint=endpoint, service=sign
        )

    # -- adapters ----------------------------------------------------------

    def adapt_s3(self, api: _AwsApi) -> dict:
        """Buckets + attributes -> aws_s3_bucket/-acl resources."""
        root = api.call("GET", "/")
        buckets: dict[str, dict] = {}
        if root is None:
            return {}
        for b in _findall(root, "Bucket"):
            name_el = _find(b, "Name")
            if name_el is None or not name_el.text:
                continue
            name = name_el.text
            doc: dict = {"bucket": name}
            try:
                acl = api.call("GET", f"/{name}?acl")
                if acl is not None and self._acl_is_public(acl):
                    doc["acl"] = "public-read"
                enc = api.call("GET", f"/{name}?encryption")
                if enc is not None and _find(enc, "SSEAlgorithm") is not None:
                    doc["server_side_encryption_configuration"] = {
                        "rule": {"sse_algorithm": True}
                    }
                ver = api.call("GET", f"/{name}?versioning")
                status = _find(ver, "Status") if ver is not None else None
                if status is not None and (status.text or "") == "Enabled":
                    doc["versioning"] = {"enabled": True}
            except AwsError as e:
                # A bucket whose attributes cannot be read must not pass as
                # private/encrypted; record the degradation for the caller
                # (a degraded scan must not turn CI green).
                logger.warning("s3 bucket %s: %s", name, e)
                self.errors.append(f"s3 bucket {name}: {e}")
            buckets[name] = doc
        return {"aws_s3_bucket": buckets} if buckets else {}

    @staticmethod
    def _acl_is_public(acl: ET.Element) -> bool:
        for grant in _findall(acl, "Grant"):
            uri = _find(grant, "URI")
            if uri is not None and (uri.text or "").endswith(
                ("AllUsers", "AuthenticatedUsers")
            ):
                return True
        return False

    def adapt_ec2(self, api: _AwsApi) -> dict:
        """DescribeInstances/Volumes/SecurityGroups -> aws_instance /
        aws_ebs_volume / aws_security_group resources.

        Traversal uses DIRECT children only: real responses nest further
        <item>/<instanceId> elements under networkInterfaceSet, and a
        deep .iter() search would let those overwrite the instance doc.
        Each Describe call degrades independently (adapt_s3's contract): a
        role missing one permission still scans what the others return,
        with the gap recorded in self.errors."""

        def children(el, name):
            return [c for c in list(el) if _strip_ns(c.tag) == name]

        def child(el, name):
            got = children(el, name)
            return got[0] if got else None

        def call(action: str):
            try:
                return api.call(
                    "GET", f"/?Action={action}&Version=2016-11-15"
                )
            except AwsError as e:
                logger.warning("ec2 %s: %s", action, e)
                self.errors.append(f"ec2 {action}: {e}")
                return None

        out: dict = {}

        root = call("DescribeInstances")
        instances: dict[str, dict] = {}
        for rset in children(root, "reservationSet") if root is not None else []:
            for res_item in children(rset, "item"):
                for iset in children(res_item, "instancesSet"):
                    for item in children(iset, "item"):
                        iid = child(item, "instanceId")
                        if iid is None or not iid.text:
                            continue
                        doc: dict = {}
                        pub = child(item, "ipAddress")
                        if pub is not None and pub.text:
                            doc["associate_public_ip_address"] = True
                        mo = child(item, "metadataOptions")
                        tokens = child(mo, "httpTokens") if mo is not None else None
                        doc["metadata_options"] = {
                            "http_tokens": (tokens.text or "optional")
                            if tokens is not None
                            else "optional"
                        }
                        instances[iid.text] = doc
        if instances:
            out["aws_instance"] = instances

        vroot = call("DescribeVolumes")
        volumes: dict[str, dict] = {}
        for vset in children(vroot, "volumeSet") if vroot is not None else []:
            for item in children(vset, "item"):
                vid = child(item, "volumeId")
                if vid is None or not vid.text:
                    continue
                enc = child(item, "encrypted")
                volumes[vid.text] = {
                    "encrypted": enc is not None and enc.text == "true"
                }
        if volumes:
            out["aws_ebs_volume"] = volumes

        sroot = call("DescribeSecurityGroups")
        groups: dict[str, dict] = {}
        srets = children(sroot, "securityGroupInfo") if sroot is not None else []
        for gset in srets:
            for item in children(gset, "item"):
                # Explicit None test: leaf Elements are falsy, so
                # `a or b` would discard a found groupId.
                gid = child(item, "groupId")
                if gid is None:
                    gid = child(item, "groupName")
                if gid is None or not gid.text:
                    continue
                ingress = []
                for perms in children(item, "ipPermissions"):
                    for perm in children(perms, "item"):
                        cidrs = []
                        for set_tag, ip_tag in (
                            ("ipRanges", "cidrIp"),
                            ("ipv6Ranges", "cidrIpv6"),
                        ):
                            for rset in children(perm, set_tag):
                                for r in children(rset, "item"):
                                    ip = child(r, ip_tag)
                                    if ip is not None and ip.text:
                                        cidrs.append(ip.text)
                        if cidrs:
                            ingress.append({"cidr_blocks": cidrs})
                groups[gid.text] = {"ingress": ingress}
        if groups:
            out["aws_security_group"] = groups
        return out

    def adapt_rds(self, api: _AwsApi) -> dict:
        """DescribeDBInstances -> aws_db_instance resources (the cloud
        adapter feeds the same fields the terraform corpus checks:
        storage_encrypted, publicly_accessible)."""
        root = api.call("GET", "/?Action=DescribeDBInstances&Version=2014-10-31")
        if root is None:
            return {}
        dbs: dict[str, dict] = {}
        for item in root.iter():
            if _strip_ns(item.tag) != "DBInstance":
                continue
            ident = _find(item, "DBInstanceIdentifier")
            if ident is None or not ident.text:
                continue
            enc = _find(item, "StorageEncrypted")
            pub = _find(item, "PubliclyAccessible")
            dbs[ident.text] = {
                "storage_encrypted": (enc is not None and enc.text == "true"),
                "publicly_accessible": (pub is not None and pub.text == "true"),
            }
        return {"aws_db_instance": dbs} if dbs else {}

    def adapt_iam(self, api: _AwsApi) -> dict:
        """GetAccountPasswordPolicy -> aws_iam_account_password_policy.

        An account with no policy set must FAIL the password-policy check,
        not vanish: AWS answers NoSuchEntity, which adapts to an empty
        policy document (every minimum is unset)."""
        try:
            root = api.call(
                "GET", "/?Action=GetAccountPasswordPolicy&Version=2010-05-08"
            )
        except AwsError as e:
            if "NoSuchEntity" not in str(e):
                raise
            root = None
        policy: dict = {}
        if root is not None:
            for el in root.iter():
                tag = _strip_ns(el.tag)
                if tag == "MinimumPasswordLength" and el.text:
                    policy["minimum_password_length"] = int(el.text)
                elif tag == "RequireSymbols":
                    policy["require_symbols"] = el.text == "true"
                elif tag == "RequireNumbers":
                    policy["require_numbers"] = el.text == "true"
                elif tag == "MaxPasswordAge" and el.text:
                    policy["max_password_age"] = int(el.text)
        return {"aws_iam_account_password_policy": {"account": policy}}

    def adapt_cloudtrail(self, api: _AwsApi) -> dict:
        """DescribeTrails -> aws_cloudtrail resources (multi-region and
        log-validation fields feed the terraform corpus)."""
        out = api.call_json(
            "com.amazonaws.cloudtrail.v20131101.CloudTrail_20131101"
            ".DescribeTrails",
            {},
        )
        trails: dict[str, dict] = {}
        for t in out.get("trailList") or []:
            name = t.get("Name") or t.get("TrailARN", "")
            if not name:
                continue
            trails[name] = {
                "is_multi_region_trail": bool(t.get("IsMultiRegionTrail")),
                "enable_log_file_validation": bool(
                    t.get("LogFileValidationEnabled")
                ),
                "kms_key_id": t.get("KmsKeyId", ""),
            }
        if not trails:
            # No audit logging at all must FAIL the trail checks, not
            # vanish (adapt_iam's absence contract): an empty document
            # fails every per-field requirement.
            trails["account"] = {}
        return {"aws_cloudtrail": trails}

    def adapt_kms(self, api: _AwsApi) -> dict:
        """ListKeys (paginated) + DescribeKey + GetKeyRotationStatus ->
        aws_kms_key resources.  Only customer-managed symmetric keys are
        rotation-checked (rotation is unsupported/meaningless for
        asymmetric and AWS-managed keys); a key whose state cannot be
        read is recorded (self.errors), never assumed rotated."""
        key_ids: list[str] = []
        marker = None
        while True:
            req: dict = {"Marker": marker} if marker else {}
            out = api.call_json("TrentService.ListKeys", req)
            key_ids.extend(
                k.get("KeyId", "") for k in out.get("Keys") or []
            )
            marker = out.get("NextMarker")
            if not out.get("Truncated") or not marker:
                break

        keys: dict[str, dict] = {}
        for key_id in key_ids:
            if not key_id:
                continue
            try:
                meta = (
                    api.call_json(
                        "TrentService.DescribeKey", {"KeyId": key_id}
                    ).get("KeyMetadata")
                    or {}
                )
                if meta.get("KeyManager", "CUSTOMER") != "CUSTOMER":
                    continue
                if meta.get("KeySpec", "SYMMETRIC_DEFAULT") != "SYMMETRIC_DEFAULT":
                    continue
                status = api.call_json(
                    "TrentService.GetKeyRotationStatus", {"KeyId": key_id}
                )
                keys[key_id] = {
                    "enable_key_rotation": bool(status.get("KeyRotationEnabled"))
                }
            except AwsError as e:
                logger.warning("kms key %s: %s", key_id, e)
                self.errors.append(f"kms key {key_id}: {e}")
        return {"aws_kms_key": keys} if keys else {}

    def _query_paged(
        self, api: _AwsApi, base: str, item_tag: str
    ) -> list[str]:
        """Collect `item_tag` texts across NextToken pages of a Query-XML
        list action (a degraded page is an error, never a silent pass)."""
        from urllib.parse import quote

        out: list[str] = []
        token = None
        while True:
            url = base if token is None else (
                f"{base}&NextToken={quote(token, safe='')}"
            )
            root = api.call("GET", url)
            if root is None:
                return out
            out.extend(
                el.text
                for el in root.iter()
                if _strip_ns(el.tag) == item_tag and el.text
            )
            token = next(
                (
                    el.text
                    for el in root.iter()
                    if _strip_ns(el.tag) == "NextToken" and el.text
                ),
                None,
            )
            if not token:
                return out

    def adapt_sns(self, api: _AwsApi) -> dict:
        """ListTopics (paginated) + GetTopicAttributes -> aws_sns_topic."""
        topics: dict[str, dict] = {}
        arns = self._query_paged(
            api, "/?Action=ListTopics&Version=2010-03-31", "TopicArn"
        )
        from urllib.parse import quote

        for arn in arns:
            name = arn.rsplit(":", 1)[-1]
            topics[name] = {"kms_master_key_id": ""}
            try:
                attrs = api.call(
                    "GET",
                    "/?Action=GetTopicAttributes&Version=2010-03-31"
                    f"&TopicArn={quote(arn, safe='')}",
                )
            except AwsError as e:
                self.errors.append(f"sns topic {name}: {e}")
                continue
            for entry in attrs.iter() if attrs is not None else []:
                if _strip_ns(entry.tag) != "entry":
                    continue
                k, v = _find(entry, "key"), _find(entry, "value")
                if k is not None and k.text == "KmsMasterKeyId":
                    topics[name]["kms_master_key_id"] = (
                        v.text if v is not None and v.text else ""
                    )
        return {"aws_sns_topic": topics} if topics else {}

    def adapt_sqs(self, api: _AwsApi) -> dict:
        """ListQueues (paginated) + GetQueueAttributes -> aws_sqs_queue."""
        urls = self._query_paged(
            api, "/?Action=ListQueues&Version=2012-11-05", "QueueUrl"
        )
        from urllib.parse import quote, urlparse

        queues: dict[str, dict] = {}
        for url in urls:
            name = urlparse(url).path.rsplit("/", 1)[-1]
            q = {"kms_master_key_id": "", "sqs_managed_sse_enabled": False}
            queues[name] = q
            try:
                attrs = api.call(
                    "GET",
                    f"/?Action=GetQueueAttributes&Version=2012-11-05"
                    f"&QueueUrl={quote(url, safe='')}&AttributeName.1=All",
                )
            except AwsError as e:
                self.errors.append(f"sqs queue {name}: {e}")
                continue
            for attr in attrs.iter() if attrs is not None else []:
                if _strip_ns(attr.tag) != "Attribute":
                    continue
                k, v = _find(attr, "Name"), _find(attr, "Value")
                if k is None or v is None:
                    continue
                if k.text == "KmsMasterKeyId":
                    q["kms_master_key_id"] = v.text or ""
                elif k.text == "SqsManagedSseEnabled":
                    q["sqs_managed_sse_enabled"] = v.text == "true"
        return {"aws_sqs_queue": queues} if queues else {}

    def adapt_ecr(self, api: _AwsApi) -> dict:
        """DescribeRepositories (paginated) -> aws_ecr_repository."""
        repos: dict[str, dict] = {}
        token = None
        while True:
            req: dict = {"nextToken": token} if token else {}
            out = api.call_json(
                "AmazonEC2ContainerRegistry_V20150921.DescribeRepositories",
                req,
            )
            for r in out.get("repositories") or []:
                name = r.get("repositoryName", "")
                if not name:
                    continue
                enc = r.get("encryptionConfiguration") or {}
                repos[name] = {
                    "image_scanning_configuration": {
                        "scan_on_push": bool(
                            (r.get("imageScanningConfiguration") or {}).get(
                                "scanOnPush"
                            )
                        )
                    },
                    "image_tag_mutability": r.get(
                        "imageTagMutability", "MUTABLE"
                    ),
                    "encryption_configuration": {
                        "encryption_type": enc.get("encryptionType", "AES256")
                    },
                }
            token = out.get("nextToken")
            if not token:
                break
        return {"aws_ecr_repository": repos} if repos else {}

    def adapt_eks(self, api: _AwsApi) -> dict:
        """ListClusters (paginated) + DescribeCluster -> aws_eks_cluster."""
        from urllib.parse import quote

        names: list[str] = []
        token = None
        while True:
            path = "/clusters" if token is None else (
                f"/clusters?nextToken={quote(token, safe='')}"
            )
            out = api.call_rest_json("GET", path)
            names.extend(out.get("clusters") or [])
            token = out.get("nextToken")
            if not token:
                break
        clusters: dict[str, dict] = {}
        for name in names:
            try:
                c = api.call_rest_json("GET", f"/clusters/{name}").get(
                    "cluster"
                ) or {}
            except AwsError as e:
                self.errors.append(f"eks cluster {name}: {e}")
                continue
            vpc = c.get("resourcesVpcConfig") or {}
            log_types: list[str] = []
            for grp in (c.get("logging") or {}).get("clusterLogging") or []:
                if grp.get("enabled"):
                    log_types.extend(grp.get("types") or [])
            clusters[name] = {
                "vpc_config": {
                    "endpoint_public_access": bool(
                        vpc.get("endpointPublicAccess", True)
                    ),
                    "public_access_cidrs": vpc.get("publicAccessCidrs")
                    or ["0.0.0.0/0"],
                },
                "enabled_cluster_log_types": log_types,
            }
        return {"aws_eks_cluster": clusters} if clusters else {}

    def adapt_dynamodb(self, api: _AwsApi) -> dict:
        """ListTables (paginated) + DescribeTable +
        DescribeContinuousBackups -> aws_dynamodb_table resources."""
        names: list[str] = []
        start = None
        while True:
            req: dict = (
                {"ExclusiveStartTableName": start} if start else {}
            )
            out = api.call_json("DynamoDB_20120810.ListTables", req)
            names.extend(out.get("TableNames") or [])
            start = out.get("LastEvaluatedTableName")
            if not start:
                break
        tables: dict[str, dict] = {}
        for name in names:
            t: dict = {
                "server_side_encryption": {"enabled": False, "kms_key_arn": ""},
                "point_in_time_recovery": {"enabled": False},
            }
            tables[name] = t
            try:
                desc = api.call_json(
                    "DynamoDB_20120810.DescribeTable", {"TableName": name}
                ).get("Table") or {}
                sse = desc.get("SSEDescription") or {}
                t["server_side_encryption"] = {
                    "enabled": sse.get("Status") == "ENABLED",
                    "kms_key_arn": sse.get("KMSMasterKeyArn", ""),
                }
                backups = api.call_json(
                    "DynamoDB_20120810.DescribeContinuousBackups",
                    {"TableName": name},
                ).get("ContinuousBackupsDescription") or {}
                pitr = backups.get("PointInTimeRecoveryDescription") or {}
                t["point_in_time_recovery"] = {
                    "enabled": pitr.get("PointInTimeRecoveryStatus")
                    == "ENABLED"
                }
            except AwsError as e:
                self.errors.append(f"dynamodb table {name}: {e}")
        return {"aws_dynamodb_table": tables} if tables else {}

    def adapt_cloudfront(self, api: _AwsApi) -> dict:
        """ListDistributions (Marker-paginated) + GetDistributionConfig ->
        aws_cloudfront_distribution resources."""
        from urllib.parse import quote

        ids: list[str] = []
        marker = None
        while True:
            path = "/2020-05-31/distribution" if marker is None else (
                f"/2020-05-31/distribution?Marker={quote(marker, safe='')}"
            )
            root = api.call("GET", path)
            if root is None:
                break
            ids.extend(
                _find(s, "Id").text
                for s in root.iter()
                if _strip_ns(s.tag) == "DistributionSummary"
                and _find(s, "Id") is not None
            )
            truncated = next(
                (
                    el.text == "true"
                    for el in root.iter()
                    if _strip_ns(el.tag) == "IsTruncated"
                ),
                False,
            )
            marker = next(
                (
                    el.text
                    for el in root.iter()
                    if _strip_ns(el.tag) == "NextMarker" and el.text
                ),
                None,
            )
            if not truncated or not marker:
                break
        dists: dict[str, dict] = {}
        for dist_id in ids:
            try:
                cfg = api.call(
                    "GET", f"/2020-05-31/distribution/{dist_id}/config"
                )
            except AwsError as e:
                self.errors.append(f"cloudfront {dist_id}: {e}")
                continue
            if cfg is None:
                continue
            d: dict = {}
            beh = _find(cfg, "DefaultCacheBehavior")
            if beh is not None:
                vpp = _find(beh, "ViewerProtocolPolicy")
                d["default_cache_behavior"] = {
                    "viewer_protocol_policy": (
                        vpp.text if vpp is not None and vpp.text else "allow-all"
                    )
                }
            cert = _find(cfg, "ViewerCertificate")
            if cert is not None:
                mpv = _find(cert, "MinimumProtocolVersion")
                default_cert = _find(cert, "CloudFrontDefaultCertificate")
                d["viewer_certificate"] = {
                    "minimum_protocol_version": (
                        mpv.text if mpv is not None and mpv.text else "TLSv1"
                    ),
                    "cloudfront_default_certificate": (
                        default_cert is not None
                        and default_cert.text == "true"
                    ),
                }
            logging_el = _find(cfg, "Logging")
            enabled = (
                _find(logging_el, "Enabled") if logging_el is not None else None
            )
            if enabled is not None and enabled.text == "true":
                bucket = _find(logging_el, "Bucket")
                d["logging_config"] = {
                    "bucket": bucket.text if bucket is not None else ""
                }
            dists[dist_id] = d
        return {"aws_cloudfront_distribution": dists} if dists else {}

    def adapt_efs(self, api: _AwsApi) -> dict:
        """DescribeFileSystems (Marker-paginated) -> aws_efs_file_system."""
        from urllib.parse import quote

        systems: dict[str, dict] = {}
        marker = None
        while True:
            path = "/2015-02-01/file-systems" if marker is None else (
                f"/2015-02-01/file-systems?Marker={quote(marker, safe='')}"
            )
            out = api.call_rest_json("GET", path)
            for fs in out.get("FileSystems") or []:
                fsid = fs.get("FileSystemId", "")
                if fsid:
                    systems[fsid] = {"encrypted": bool(fs.get("Encrypted"))}
            marker = out.get("NextMarker")
            if not marker:
                break
        return {"aws_efs_file_system": systems} if systems else {}

    def adapt_kinesis(self, api: _AwsApi) -> dict:
        """ListStreams (paginated) + DescribeStreamSummary ->
        aws_kinesis_stream resources."""
        names: list[str] = []
        start = None
        while True:
            req: dict = (
                {"ExclusiveStartStreamName": start} if start else {}
            )
            out = api.call_json("Kinesis_20131202.ListStreams", req)
            page = out.get("StreamNames") or []
            names.extend(page)
            if not out.get("HasMoreStreams") or not page:
                break
            start = page[-1]
        streams: dict[str, dict] = {}
        for name in names:
            streams[name] = {"encryption_type": "NONE"}
            try:
                desc = api.call_json(
                    "Kinesis_20131202.DescribeStreamSummary",
                    {"StreamName": name},
                ).get("StreamDescriptionSummary") or {}
                streams[name]["encryption_type"] = desc.get(
                    "EncryptionType", "NONE"
                )
            except AwsError as e:
                self.errors.append(f"kinesis stream {name}: {e}")
        return {"aws_kinesis_stream": streams} if streams else {}

    def adapt_logs(self, api: _AwsApi) -> dict:
        """DescribeLogGroups -> aws_cloudwatch_log_group resources."""
        groups: dict[str, dict] = {}
        token = None
        while True:
            req: dict = {"nextToken": token} if token else {}
            out = api.call_json("Logs_20140328.DescribeLogGroups", req)
            for g in out.get("logGroups") or []:
                name = g.get("logGroupName", "")
                if name:
                    groups[name] = {"kms_key_id": g.get("kmsKeyId", "")}
            token = out.get("nextToken")
            if not token:
                break
        return {"aws_cloudwatch_log_group": groups} if groups else {}

    def adapt_lambda(self, api: _AwsApi) -> dict:
        """ListFunctions (REST JSON, Marker-paginated) ->
        aws_lambda_function resources."""
        from urllib.parse import quote

        fns: dict[str, dict] = {}
        marker = None
        while True:
            path = "/2015-03-31/functions/"
            if marker:
                path += f"?Marker={quote(marker, safe='')}"
            out = api.call_rest_json("GET", path)
            for f in out.get("Functions") or []:
                name = f.get("FunctionName", "")
                if not name:
                    continue
                tracing = f.get("TracingConfig") or {}
                fns[name] = {
                    "tracing_config": {
                        "mode": tracing.get("Mode", "PassThrough")
                    }
                }
            marker = out.get("NextMarker")
            if not marker:
                break
        return {"aws_lambda_function": fns} if fns else {}

    def adapt_redshift(self, api: _AwsApi) -> dict:
        """DescribeClusters (Marker-paginated Query XML) ->
        aws_redshift_cluster resources."""
        from urllib.parse import quote

        clusters: dict[str, dict] = {}
        marker = None
        while True:
            url = "/?Action=DescribeClusters&Version=2012-12-01"
            if marker:
                url += f"&Marker={quote(marker, safe='')}"
            root = api.call("GET", url)
            if root is None:
                break
            for item in root.iter():
                if _strip_ns(item.tag) != "Cluster":
                    continue
                ident = _find(item, "ClusterIdentifier")
                if ident is None or not ident.text:
                    continue
                enc = _find(item, "Encrypted")
                clusters[ident.text] = {
                    "encrypted": enc is not None and enc.text == "true"
                }
            nxt = next(
                (
                    el.text
                    for el in root.iter()
                    if _strip_ns(el.tag) == "Marker" and el.text
                ),
                None,
            )
            if not nxt or nxt == marker:
                break
            marker = nxt
        return {"aws_redshift_cluster": clusters} if clusters else {}

    def adapt_ecs(self, api: _AwsApi) -> dict:
        """ListClusters + DescribeClusters (JSON protocol, SETTINGS
        included; 100-ARN describe batches) -> aws_ecs_cluster
        resources.  Per-cluster describe failures are recorded in
        self.errors — a degraded page is an error, never a silent pass."""
        arns: list[str] = []
        token = None
        while True:
            req: dict = {"nextToken": token} if token else {}
            out = api.call_json(
                "AmazonEC2ContainerServiceV20141113.ListClusters", req
            )
            arns.extend(out.get("clusterArns") or [])
            token = out.get("nextToken")
            if not token:
                break
        if not arns:
            return {}
        clusters: dict[str, dict] = {}
        for off in range(0, len(arns), 100):  # DescribeClusters cap
            out = api.call_json(
                "AmazonEC2ContainerServiceV20141113.DescribeClusters",
                {"clusters": arns[off : off + 100], "include": ["SETTINGS"]},
            )
            for fail in out.get("failures") or []:
                self.errors.append(
                    f"ecs cluster {fail.get('arn', '?')}: "
                    f"{fail.get('reason', 'describe failure')}"
                )
            for c in out.get("clusters") or []:
                name = c.get("clusterName", "")
                if not name:
                    continue
                clusters[name] = {
                    "setting": [
                        {
                            "name": s.get("name", ""),
                            "value": s.get("value", ""),
                        }
                        for s in c.get("settings") or []
                    ]
                }
        return {"aws_ecs_cluster": clusters} if clusters else {}

    # -- scan --------------------------------------------------------------

    def scan(self) -> list:
        """Adapt every requested service, evaluate the terraform check
        corpus over the combined resource document, return
        Misconfiguration results per service."""
        from trivy_tpu_torch.iac.engine import shared_scanner
        from trivy_tpu_torch.obs import trace as obs_trace

        resources: dict = {}
        for service in self.services:
            if service not in SUPPORTED_SERVICES:
                raise AwsError(
                    f"unsupported service {service!r} "
                    f"(supported: {', '.join(SUPPORTED_SERVICES)})"
                )
            adapter = getattr(self, f"adapt_{service}")
            with obs_trace.span("aws.adapt", service=service):
                resources.update(adapter(self._api(service)))
        if not resources:
            return []
        doc = {"resource": resources}
        import json as _json

        with obs_trace.span("aws.checks"):
            mc = shared_scanner().scan("cloud.tf.json", _json.dumps(doc).encode())
        return [mc] if mc is not None else []
