"""S3 cache backend (pkg/fanal/cache/s3.go).

Cache documents live as S3 objects ``<prefix>/artifact/<id>`` and
``<prefix>/blob/<id>``.  Requests are signed with AWS Signature V4 over
stdlib HTTP — no SDK ships here; the protocol surface the cache needs
(GET/PUT/DELETE/HEAD object) is small and fully specified.

Configuration comes from the backend URL ``s3://bucket/prefix`` plus the
conventional environment: AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY/
AWS_SESSION_TOKEN, AWS_REGION, and AWS_ENDPOINT_URL for S3-compatible
stores (minio/localstack), which is also how the tests drive a fake
endpoint.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterable

from trivy_tpu_torch.atypes import ArtifactInfo, BlobInfo
from trivy_tpu_torch.cache.store import ArtifactCache


class S3Error(RuntimeError):
    pass


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    """SigV4-signed object operations."""

    def __init__(
        self,
        bucket: str,
        region: str = "",
        endpoint: str = "",
        access_key: str = "",
        secret_key: str = "",
        session_token: str = "",
        service: str = "s3",
        timeout: float = 60.0,
    ):
        self.bucket = bucket
        self.service = service
        self.timeout = timeout
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.endpoint = (
            endpoint
            or os.environ.get("AWS_ENDPOINT_URL", "")
            or f"https://s3.{self.region}.amazonaws.com"
        ).rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", ""
        )
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN", ""
        )

    def _request(
        self,
        method: str,
        key: str,
        body: bytes = b"",
        query: str = "",
        headers_extra: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        if key.startswith("/"):
            path = key  # pre-built path (service APIs)
        else:
            path = f"/{self.bucket}/{urllib.parse.quote(key)}"
        url = self.endpoint + path + (f"?{query}" if query else "")
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(body).hexdigest()

        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        # Extra headers participate in signing (SigV4 requires any present
        # x-amz-* header to be signed; JSON-protocol APIs route on
        # x-amz-target).
        for k, v in (headers_extra or {}).items():
            headers[k.lower()] = v
        signed_headers = ";".join(sorted(headers))
        canonical_query = "&".join(
            sorted(
                part if "=" in part else f"{part}="
                for part in query.split("&")
                if part
            )
        )
        canonical = "\n".join(
            [
                method,
                path,
                canonical_query,
                "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        k = _sign(f"AWS4{self.secret_key}".encode(), datestamp)
        k = _sign(k, self.region)
        k = _sign(k, self.service)
        k = _sign(k, "aws4_request")
        signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )

        req = urllib.request.Request(
            url, data=body if method in ("PUT", "POST") else None,
            headers=headers, method=method,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except urllib.error.URLError as e:
            raise S3Error(f"s3: {method} {key}: {e.reason}") from e

    def put_object(self, key: str, body: bytes) -> None:
        status, payload = self._request("PUT", key, body)
        if status not in (200, 201):
            raise S3Error(f"s3: PUT {key}: HTTP {status}: {payload[:200]!r}")

    def get_object(self, key: str) -> bytes | None:
        status, payload = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise S3Error(f"s3: GET {key}: HTTP {status}")
        return payload

    def head_object(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        return status == 200

    def delete_object(self, key: str) -> None:
        self._request("DELETE", key)


class S3Cache(ArtifactCache):
    """s3.go S3Cache: cache documents as JSON objects."""

    def __init__(self, url: str, **client_kw):
        u = urllib.parse.urlparse(url)
        if u.scheme != "s3" or not u.netloc:
            raise S3Error(f"unsupported s3 URL {url!r}")
        self.prefix = u.path.strip("/") or "fanal"
        self.client = S3Client(bucket=u.netloc, **client_kw)

    def _key(self, bucket: str, item_id: str) -> str:
        return f"{self.prefix}/{bucket}/{item_id}"

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self.client.put_object(
            self._key("artifact", artifact_id),
            json.dumps(info.to_json()).encode(),
        )

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self.client.put_object(
            self._key("blob", blob_id), json.dumps(info.to_json()).encode()
        )

    @staticmethod
    def _decode(raw: bytes | None) -> dict | None:
        if not raw:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None  # corrupt object = cache miss, like the redis path

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        doc = self._decode(
            self.client.get_object(self._key("artifact", artifact_id))
        )
        return ArtifactInfo.from_json(doc) if doc else None

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        doc = self._decode(
            self.client.get_object(self._key("blob", blob_id))
        )
        return BlobInfo.from_json(doc) if doc else None

    def exists(self, blob_id: str) -> bool:
        return self.client.head_object(self._key("blob", blob_id))

    def missing_blobs(
        self, artifact_id: str, blob_ids: Iterable[str]
    ) -> tuple[bool, list[str]]:
        missing = [
            bid
            for bid in blob_ids
            if not self.client.head_object(self._key("blob", bid))
        ]
        missing_artifact = not self.client.head_object(
            self._key("artifact", artifact_id)
        )
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        for bid in blob_ids:
            self.client.delete_object(self._key("blob", bid))

    def clear(self) -> None:
        # Bucket listing/deletion is an operator action in the reference
        # too (s3.go implements Clear as a no-op for shared buckets).
        pass

    def close(self) -> None:
        pass
