"""EBS direct-API snapshot reader (`vm ebs:snap-...` / `vm ami:...`).

Role parity with the reference's pkg/fanal/artifact/vm/ebs.go:21 and
ami.go:16 (go-ebs-file): the snapshot is presented as a seekable
zero-filling file-like over the volume's byte space, fetching 512KB
blocks on demand through the SigV4-signed EBS direct APIs
(ListSnapshotBlocks / GetSnapshotBlock) with a small LRU.  An `ami:`
target first resolves the image's root EBS snapshot via EC2
DescribeImages.

AWS_ENDPOINT_URL redirects both services (how the tests drive a fake
endpoint); region/credentials come from the standard env vars.

Copied from `trivy_tpu/vm/ebs.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import urllib.parse

from trivy_tpu_torch.cloud.aws import AwsError, _AwsApi, _find, _findall


class EbsError(RuntimeError):
    pass


class EbsSnapshot:
    """Seekable file-like over one EBS snapshot."""

    def __init__(self, snapshot_id: str, region: str = "", cache_blocks: int = 32):
        self.snapshot_id = snapshot_id
        api = _AwsApi(bucket="", region=region, service="ebs")
        api.endpoint = api.endpoint.replace("s3.", "ebs.", 1)
        import os

        override = os.environ.get("AWS_ENDPOINT_URL", "")
        if override:
            api.endpoint = override.rstrip("/")
        self._api = api
        self._cache_max = cache_blocks
        self._cache: dict[int, bytes] = {}
        self._tokens: dict[int, str] = {}
        self.block_size = 0
        self.size = 0
        self._pos = 0
        self._list_blocks()

    def _list_blocks(self) -> None:
        token = ""
        while True:
            q = "maxResults=1000" + (
                f"&pageToken={urllib.parse.quote(token)}" if token else ""
            )
            status, payload = self._api._request(
                "GET", f"/snapshots/{self.snapshot_id}/blocks", query=q
            )
            if status != 200:
                raise EbsError(
                    f"ListSnapshotBlocks {self.snapshot_id}: HTTP {status} "
                    f"{payload[:200]!r}"
                )
            import json

            doc = json.loads(payload or b"{}")
            self.block_size = int(doc.get("BlockSize") or 524288)
            # VolumeSize is GiB in this API
            self.size = int(doc.get("VolumeSize") or 0) << 30
            for b in doc.get("Blocks") or []:
                self._tokens[int(b["BlockIndex"])] = b.get("BlockToken", "")
            token = doc.get("NextPageToken") or ""
            if not token:
                break
        if not self.size and self._tokens:
            self.size = (max(self._tokens) + 1) * self.block_size

    def _block(self, idx: int) -> bytes:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        token = self._tokens.get(idx)
        if token is None:
            data = b"\x00" * self.block_size  # sparse hole
        else:
            status, payload = self._api._request(
                "GET",
                f"/snapshots/{self.snapshot_id}/blocks/{idx}",
                query=f"blockToken={urllib.parse.quote(token)}",
            )
            if status != 200:
                raise EbsError(
                    f"GetSnapshotBlock {self.snapshot_id}/{idx}: "
                    f"HTTP {status}"
                )
            data = payload.ljust(self.block_size, b"\x00")
        if len(self._cache) >= self._cache_max:
            self._cache.pop(next(iter(self._cache)))
        self._cache[idx] = data
        return data

    # file-like surface ------------------------------------------------

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self.size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self._cache.clear()

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.size - self._pos
        n = max(0, min(n, self.size - self._pos))
        out = bytearray()
        pos = self._pos
        while n > 0:
            bi, off = divmod(pos, self.block_size)
            chunk = self._block(bi)[off : off + n]
            out += chunk
            pos += len(chunk)
            n -= len(chunk)
        self._pos = pos
        return bytes(out)


def resolve_ami(ami_id: str, region: str = "") -> str:
    """ami-... -> its root device's EBS snapshot id (EC2 DescribeImages)."""
    api = _AwsApi(bucket="", region=region, service="ec2")
    api.endpoint = api.endpoint.replace("s3.", "ec2.", 1)
    import os

    override = os.environ.get("AWS_ENDPOINT_URL", "")
    if override:
        api.endpoint = override.rstrip("/")
    try:
        root = api.call(
            "GET",
            "/?Action=DescribeImages&Version=2016-11-15"
            f"&ImageId.1={urllib.parse.quote(ami_id)}",
        )
    except AwsError as e:
        raise EbsError(f"DescribeImages {ami_id}: {e}") from e
    if root is None:
        raise EbsError(f"DescribeImages {ami_id}: empty reply")
    for mapping in _findall(root, "item"):
        snap = _find(mapping, "snapshotId")
        if snap is not None and (snap.text or "").startswith("snap-"):
            return snap.text.strip()
    raise EbsError(f"{ami_id}: no EBS-backed root snapshot found")


def open_vm_target(target: str, region: str = ""):
    """vm-command target dispatch: 'ebs:snap-...' / 'ami:ami-...' open an
    EBS snapshot stream; anything else is a local file path (raw or VMDK,
    decided by the caller)."""
    if target.startswith("ebs:"):
        return EbsSnapshot(target[4:], region=region)
    if target.startswith("ami:"):
        snap = resolve_ami(target[4:], region=region)
        return EbsSnapshot(snap, region=region)
    return None
