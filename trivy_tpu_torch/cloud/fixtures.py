"""AWS account fixture: an in-process endpoint serving a seeded account for
every service `cloud/aws.py` adapts (`SUPPORTED_SERVICES`).

For the port's tests and `chip_smoke.py`; the scanner never imports this
module.  `seeded_account(n, seed)` draws `n` resources of each kind a
service lists (instances, volumes and security groups for ec2; one
password policy for iam, which an account has once), half of them planted
failing the service's `PLANTED` checks and half passing them.
`serve_account(account)` answers the wire shapes the adapters read: the
Query-XML actions (`?Action=`), the JSON-protocol calls (`X-Amz-Target`),
the REST-JSON paths and S3's bucket listing, with pagination where the
real APIs page (KMS `Marker`, SNS and SQS `NextToken`).  Point
`AwsScanner(endpoint=)` or `AWS_ENDPOINT_URL` at `http://127.0.0.1:<port>`.

`planted_check(account, results)` holds a scan's failures to the plant:
every failing resource named by each planted check of its service, and no
passing resource named by any of them.  Checks that no adapted field can
satisfy (the adapters never read S3 logging or public access blocks, RDS
retention, security group descriptions) fail passing resources too, so
they are not planted.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

# service -> the checks its failing resources are planted to fail
PLANTED = {
    "s3": ("AVD-AWS-0092", "AVD-AWS-0088", "AVD-AWS-0090"),
    "ec2": ("AVD-AWS-0009", "AVD-AWS-0028", "AVD-AWS-0026", "AVD-AWS-0107"),
    "rds": ("AVD-AWS-0080", "AVD-AWS-0180"),
    "iam": ("AVD-AWS-0063",),
    "cloudtrail": ("AVD-AWS-0014", "AVD-AWS-0015", "AVD-AWS-0016"),
    "kms": ("AVD-AWS-0065",),
    "sns": ("AVD-AWS-0095",),
    "sqs": ("AVD-AWS-0096",),
    "ecr": ("AVD-AWS-0030", "AVD-AWS-0031", "AVD-AWS-0033"),
    "eks": ("AVD-AWS-0040", "AVD-AWS-0039", "AVD-AWS-0038"),
    "dynamodb": ("AVD-AWS-0024", "AVD-AWS-0025"),
    "cloudfront": ("AVD-AWS-0012", "AVD-AWS-0013", "AVD-AWS-0010"),
    "efs": ("AVD-AWS-0037",),
    "kinesis": ("AVD-AWS-0064",),
    "logs": ("AVD-AWS-0017",),
    "lambda": ("AVD-AWS-0066",),
    "redshift": ("AVD-AWS-0084",),
    "ecs": ("AVD-AWS-0034",),
}
# the ec2 checks, by the kind of resource each names
EC2_KIND_CHECKS = {"instance": ("AVD-AWS-0009", "AVD-AWS-0028"), "volume": ("AVD-AWS-0026",),
                   "sg": ("AVD-AWS-0107",)}
PAGE = 8  # resources a page where the fake pages
REGION = "us-east-1"
ACCOUNT = "123456789012"


def seeded_account(n: int = 20, seed: int = 0) -> dict:
    """{service: [{"name", "kind", "fail"}]}: `n` resources of each kind
    (one iam password policy), half of each kind failing, which half drawn
    from `seed`."""
    rng = random.Random(seed)
    kinds = {"ec2": ("instance", "volume", "sg")}
    prefix = {"instance": "i-0", "volume": "vol-0", "sg": "sg-0"}
    account: dict = {}
    for service in PLANTED:
        rows = []
        for kind in kinds.get(service, ("",)):
            count = 1 if service == "iam" else n
            failing = set(rng.sample(range(count), max(1, count // 2)))
            for i in range(count):
                name = (f"{prefix[kind]}{rng.getrandbits(40):010x}" if kind
                        else "account" if service == "iam" else f"{service}-res-{i:02d}")
                rows.append({"name": name, "kind": kind, "fail": i in failing})
        account[service] = rows
    return account


def _xml(tag: str, body: str) -> bytes:
    return f'<?xml version="1.0"?><{tag}>{body}</{tag}>'.encode()


def _page(items: list, token: str | None) -> tuple[list, str | None]:
    start = int(token or 0)
    nxt = start + PAGE
    return items[start:nxt], (str(nxt) if nxt < len(items) else None)


def serve_account(account: dict) -> ThreadingHTTPServer:
    """A localhost endpoint serving `account` (`seeded_account`); call
    `shutdown()` and `server_close()` when done."""
    by = {s: {r["name"]: r for r in rows} for s, rows in account.items()}

    def rows(service: str, kind: str = "") -> list:
        return [r for r in account.get(service, []) if r["kind"] == kind]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, status: int = 200, ctype: str = "application/xml"):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, status: int = 200):
            self._send(json.dumps(obj).encode(), status, "application/x-amz-json-1.1")

        # -- JSON protocol (X-Amz-Target) ----------------------------------
        def do_POST(self):  # noqa: N802
            # the target's operation name routes; the body carries the ids
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            op = self.headers.get("X-Amz-Target", "").rsplit(".", 1)[-1]
            handler = getattr(self, f"_op_{op}", None)
            if handler is None:
                return self._json({"__type": "UnknownOperationException"}, 400)
            return self._json(handler(body))

        def _op_DescribeTrails(self, body):  # noqa: N802
            return {"trailList": [
                {"Name": r["name"], "IsMultiRegionTrail": not r["fail"],
                 "LogFileValidationEnabled": not r["fail"],
                 **({} if r["fail"] else {"KmsKeyId": f"arn:aws:kms:{REGION}:{ACCOUNT}:key/t"})}
                for r in rows("cloudtrail")]}

        def _op_ListKeys(self, body):  # noqa: N802
            page, nxt = _page([r["name"] for r in rows("kms")], body.get("Marker"))
            out = {"Keys": [{"KeyId": k} for k in page], "Truncated": nxt is not None}
            if nxt:
                out["NextMarker"] = nxt
            return out

        def _op_DescribeKey(self, body):  # noqa: N802
            return {"KeyMetadata": {"KeyId": body.get("KeyId", ""), "KeyManager": "CUSTOMER",
                                    "KeySpec": "SYMMETRIC_DEFAULT"}}

        def _op_GetKeyRotationStatus(self, body):  # noqa: N802
            return {"KeyRotationEnabled": not by["kms"][body.get("KeyId", "")]["fail"]}

        def _op_DescribeRepositories(self, body):  # noqa: N802
            return {"repositories": [
                {"repositoryName": r["name"],
                 "imageScanningConfiguration": {"scanOnPush": not r["fail"]},
                 "imageTagMutability": "MUTABLE" if r["fail"] else "IMMUTABLE",
                 "encryptionConfiguration": {"encryptionType": "AES256" if r["fail"] else "KMS"}}
                for r in rows("ecr")]}

        def _op_ListTables(self, body):  # noqa: N802
            return {"TableNames": [r["name"] for r in rows("dynamodb")]}

        def _op_DescribeTable(self, body):  # noqa: N802
            r = by["dynamodb"][body.get("TableName", "")]
            sse = ({"Status": "DISABLED"} if r["fail"] else
                   {"Status": "ENABLED",
                    "KMSMasterKeyArn": f"arn:aws:kms:{REGION}:{ACCOUNT}:key/d"})
            return {"Table": {"TableName": r["name"], "SSEDescription": sse}}

        def _op_DescribeContinuousBackups(self, body):  # noqa: N802
            r = by["dynamodb"][body.get("TableName", "")]
            status = "DISABLED" if r["fail"] else "ENABLED"
            return {"ContinuousBackupsDescription": {
                "PointInTimeRecoveryDescription": {"PointInTimeRecoveryStatus": status}}}

        def _op_ListStreams(self, body):  # noqa: N802
            return {"StreamNames": [r["name"] for r in rows("kinesis")], "HasMoreStreams": False}

        def _op_DescribeStreamSummary(self, body):  # noqa: N802
            r = by["kinesis"][body.get("StreamName", "")]
            return {"StreamDescriptionSummary": {"EncryptionType": "NONE" if r["fail"] else "KMS"}}

        def _op_DescribeLogGroups(self, body):  # noqa: N802
            return {"logGroups": [
                {"logGroupName": r["name"],
                 **({} if r["fail"] else {"kmsKeyId": f"arn:aws:kms:{REGION}:{ACCOUNT}:key/l"})}
                for r in rows("logs")]}

        def _op_ListClusters(self, body):  # noqa: N802
            return {"clusterArns": [f"arn:aws:ecs:{REGION}:{ACCOUNT}:cluster/{r['name']}"
                                    for r in rows("ecs")]}

        def _op_DescribeClusters(self, body):  # noqa: N802
            out = []
            for arn in body.get("clusters") or []:
                r = by["ecs"][arn.rsplit("/", 1)[-1]]
                out.append({"clusterName": r["name"], "settings": [
                    {"name": "containerInsights",
                     "value": "disabled" if r["fail"] else "enabled"}]})
            return {"clusters": out, "failures": []}

        # -- Query XML, REST JSON and S3 (GET) ------------------------------
        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            path, q = url.path, {k: v[0] for k, v in parse_qs(url.query).items()}
            action = q.get("Action")
            if path == "/" and action:
                handler = getattr(self, f"_q_{action}", None)
                if handler is None:
                    return self._send(b"", 400)
                return self._send(handler(q))
            if path.startswith("/clusters"):
                return self._eks(path)
            if path == "/2015-02-01/file-systems":
                return self._json({"FileSystems": [
                    {"FileSystemId": r["name"], "Encrypted": not r["fail"]}
                    for r in rows("efs")]})
            if path == "/2015-03-31/functions/":
                return self._json({"Functions": [
                    {"FunctionName": r["name"],
                     "TracingConfig": {"Mode": "PassThrough" if r["fail"] else "Active"}}
                    for r in rows("lambda")]})
            if path.startswith("/2020-05-31/distribution"):
                return self._cloudfront(path)
            return self._s3(path, url.query)

        def _q_DescribeInstances(self, q):  # noqa: N802
            items = "".join(
                f"<item><instanceId>{r['name']}</instanceId>"
                + ("<ipAddress>54.0.0.1</ipAddress>" if r["fail"] else "")
                + "<metadataOptions><httpTokens>"
                + ("optional" if r["fail"] else "required")
                + "</httpTokens></metadataOptions></item>"
                for r in rows("ec2", "instance"))
            return _xml("DescribeInstancesResponse",
                        f"<reservationSet><item><instancesSet>{items}</instancesSet></item>"
                        "</reservationSet>")

        def _q_DescribeVolumes(self, q):  # noqa: N802
            items = "".join(f"<item><volumeId>{r['name']}</volumeId><encrypted>"
                            f"{'false' if r['fail'] else 'true'}</encrypted></item>"
                            for r in rows("ec2", "volume"))
            return _xml("DescribeVolumesResponse", f"<volumeSet>{items}</volumeSet>")

        def _q_DescribeSecurityGroups(self, q):  # noqa: N802
            items = "".join(
                f"<item><groupId>{r['name']}</groupId><ipPermissions><item><ipRanges><item>"
                f"<cidrIp>{'0.0.0.0/0' if r['fail'] else '10.0.0.0/8'}</cidrIp>"
                "</item></ipRanges></item></ipPermissions></item>"
                for r in rows("ec2", "sg"))
            return _xml("DescribeSecurityGroupsResponse",
                        f"<securityGroupInfo>{items}</securityGroupInfo>")

        def _q_DescribeDBInstances(self, q):  # noqa: N802
            items = "".join(
                f"<DBInstance><DBInstanceIdentifier>{r['name']}</DBInstanceIdentifier>"
                f"<StorageEncrypted>{'false' if r['fail'] else 'true'}</StorageEncrypted>"
                f"<PubliclyAccessible>{'true' if r['fail'] else 'false'}</PubliclyAccessible>"
                "</DBInstance>" for r in rows("rds"))
            return _xml("DescribeDBInstancesResponse",
                        f"<DescribeDBInstancesResult><DBInstances>{items}</DBInstances>"
                        "</DescribeDBInstancesResult>")

        def _q_GetAccountPasswordPolicy(self, q):  # noqa: N802
            (r,) = rows("iam")
            return _xml("GetAccountPasswordPolicyResponse",
                        "<GetAccountPasswordPolicyResult><PasswordPolicy>"
                        f"<MinimumPasswordLength>{8 if r['fail'] else 16}</MinimumPasswordLength>"
                        "<RequireSymbols>true</RequireSymbols>"
                        "<RequireNumbers>true</RequireNumbers>"
                        "<MaxPasswordAge>90</MaxPasswordAge>"
                        "</PasswordPolicy></GetAccountPasswordPolicyResult>")

        def _q_ListTopics(self, q):  # noqa: N802
            page, nxt = _page([r["name"] for r in rows("sns")], q.get("NextToken"))
            members = "".join(f"<member><TopicArn>arn:aws:sns:{REGION}:{ACCOUNT}:{n}"
                              "</TopicArn></member>" for n in page)
            token = f"<NextToken>{nxt}</NextToken>" if nxt else ""
            return _xml("ListTopicsResponse",
                        f"<ListTopicsResult><Topics>{members}</Topics>{token}</ListTopicsResult>")

        def _q_GetTopicAttributes(self, q):  # noqa: N802
            r = by["sns"][q["TopicArn"].rsplit(":", 1)[-1]]
            key = ("" if r["fail"] else
                   f"<entry><key>KmsMasterKeyId</key><value>alias/{r['name']}</value></entry>")
            return _xml("GetTopicAttributesResponse",
                        "<GetTopicAttributesResult><Attributes>"
                        f"<entry><key>DisplayName</key><value>{r['name']}</value></entry>{key}"
                        "</Attributes></GetTopicAttributesResult>")

        def _q_ListQueues(self, q):  # noqa: N802
            page, nxt = _page([r["name"] for r in rows("sqs")], q.get("NextToken"))
            urls = "".join(f"<QueueUrl>https://sqs.{REGION}.amazonaws.com/{ACCOUNT}/{n}"
                           "</QueueUrl>" for n in page)
            token = f"<NextToken>{nxt}</NextToken>" if nxt else ""
            return _xml("ListQueuesResponse", f"<ListQueuesResult>{urls}{token}</ListQueuesResult>")

        def _q_GetQueueAttributes(self, q):  # noqa: N802
            r = by["sqs"][unquote(q["QueueUrl"]).rsplit("/", 1)[-1]]
            return _xml("GetQueueAttributesResponse",
                        "<GetQueueAttributesResult><Attribute><Name>SqsManagedSseEnabled</Name>"
                        f"<Value>{'false' if r['fail'] else 'true'}</Value></Attribute>"
                        "</GetQueueAttributesResult>")

        def _q_DescribeClusters(self, q):  # noqa: N802
            items = "".join(f"<Cluster><ClusterIdentifier>{r['name']}</ClusterIdentifier>"
                            f"<Encrypted>{'false' if r['fail'] else 'true'}</Encrypted></Cluster>"
                            for r in rows("redshift"))
            return _xml("DescribeClustersResponse",
                        f"<DescribeClustersResult><Clusters>{items}</Clusters>"
                        "</DescribeClustersResult>")

        def _eks(self, path: str):
            if path == "/clusters":
                return self._json({"clusters": [r["name"] for r in rows("eks")]})
            r = by["eks"].get(path.rsplit("/", 1)[-1])
            if r is None:
                return self._json({"message": "not found"}, 404)
            types = ["api", "audit", "authenticator", "controllerManager", "scheduler"]
            return self._json({"cluster": {
                "name": r["name"],
                "resourcesVpcConfig": {"endpointPublicAccess": r["fail"],
                                       "publicAccessCidrs": ["0.0.0.0/0"] if r["fail"]
                                       else ["10.0.0.0/8"]},
                "logging": {"clusterLogging": [{"types": types, "enabled": not r["fail"]}]}}})

        def _cloudfront(self, path: str):
            if path == "/2020-05-31/distribution":
                items = "".join(f"<DistributionSummary><Id>{r['name']}</Id></DistributionSummary>"
                                for r in rows("cloudfront"))
                return self._send(_xml("DistributionList",
                                       f"<IsTruncated>false</IsTruncated><Items>{items}</Items>"))
            r = by["cloudfront"].get(path.split("/")[3])
            if r is None:
                return self._send(b"", 404)
            if r["fail"]:
                body = ("<DefaultCacheBehavior><ViewerProtocolPolicy>allow-all"
                        "</ViewerProtocolPolicy></DefaultCacheBehavior>"
                        "<ViewerCertificate><MinimumProtocolVersion>TLSv1</MinimumProtocolVersion>"
                        "<CloudFrontDefaultCertificate>false</CloudFrontDefaultCertificate>"
                        "</ViewerCertificate><Logging><Enabled>false</Enabled></Logging>")
            else:
                body = ("<DefaultCacheBehavior><ViewerProtocolPolicy>redirect-to-https"
                        "</ViewerProtocolPolicy></DefaultCacheBehavior>"
                        "<ViewerCertificate><MinimumProtocolVersion>TLSv1.2_2021"
                        "</MinimumProtocolVersion><CloudFrontDefaultCertificate>false"
                        "</CloudFrontDefaultCertificate></ViewerCertificate>"
                        "<Logging><Enabled>true</Enabled><Bucket>logs.s3.amazonaws.com</Bucket>"
                        "</Logging>")
            return self._send(_xml("DistributionConfig", body))

        def _s3(self, path: str, query: str):
            if path == "/":
                names = "".join(f"<Bucket><Name>{r['name']}</Name></Bucket>" for r in rows("s3"))
                return self._send(_xml("ListAllMyBucketsResult", f"<Buckets>{names}</Buckets>"))
            r = by["s3"].get(path.strip("/"))
            if r is None:
                return self._send(b"", 404)
            if query == "acl":
                grantee = ("<URI>http://acs.amazonaws.com/groups/global/AllUsers</URI>"
                           if r["fail"] else "<ID>owner</ID>")
                return self._send(_xml("AccessControlPolicy",
                                       f"<AccessControlList><Grant><Grantee>{grantee}</Grantee>"
                                       "<Permission>READ</Permission></Grant>"
                                       "</AccessControlList>"))
            if query == "encryption":
                if r["fail"]:
                    return self._send(b"", 404)
                return self._send(_xml("ServerSideEncryptionConfiguration",
                                       "<Rule><ApplyServerSideEncryptionByDefault>"
                                       "<SSEAlgorithm>aws:kms</SSEAlgorithm>"
                                       "</ApplyServerSideEncryptionByDefault></Rule>"))
            if query == "versioning":
                return self._send(_xml("VersioningConfiguration",
                                       "" if r["fail"] else "<Status>Enabled</Status>"))
            return self._send(b"", 404)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def planted_check(account: dict, failures) -> dict:
    """`failures`: (check id, message) pairs of a scan.  Returns {service:
    {"found", "missed", "passing_named"}}: the planted failures named by
    their checks, those not named, and the passing resources a planted
    check named."""
    out = {}
    for service, rows in account.items():
        found = missed = 0
        named_passing = []
        for r in rows:
            checks = EC2_KIND_CHECKS[r["kind"]] if service == "ec2" else PLANTED[service]
            named = {cid for cid, msg in failures
                     if cid in checks and f'"{r["name"]}"' in msg}
            if r["fail"]:
                found += len(named)
                missed += len(checks) - len(named)
            elif named:
                named_passing.append(r["name"])
        out[service] = {"found": found, "missed": missed, "passing_named": named_passing}
    return out
