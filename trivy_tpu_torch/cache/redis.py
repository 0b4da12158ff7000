"""Redis cache backend (pkg/fanal/cache/redis.go).

Speaks RESP (the Redis serialization protocol) directly over a stdlib
socket — no client library ships in this environment, and the cache needs
only GET/SET/DEL/EXISTS/SCAN/PING.  Key layout matches the reference:
``fanal::artifact::<id>`` and ``fanal::blob::<id>`` (redis.go key scheme),
values are the same JSON documents the FS cache writes.

TLS (rediss://) wraps the socket with ssl; AUTH comes from the URL
userinfo.  The backend selects with ``--cache-backend redis://host:port``.
"""

from __future__ import annotations

import json
import socket
import ssl
import urllib.parse
from typing import Iterable

from trivy_tpu_torch.atypes import ArtifactInfo, BlobInfo
from trivy_tpu_torch.cache.store import ArtifactCache

ARTIFACT_PREFIX = "fanal::artifact::"
BLOB_PREFIX = "fanal::blob::"


class RedisError(RuntimeError):
    pass


class RespClient:
    """Minimal RESP2 client: one connection, request/response."""

    def __init__(self, url: str, timeout: float = 30.0):
        u = urllib.parse.urlparse(url)
        if u.scheme not in ("redis", "rediss"):
            raise RedisError(f"unsupported redis URL {url!r}")
        host = u.hostname or "localhost"
        port = u.port or 6379
        self._sock = socket.create_connection((host, port), timeout=timeout)
        if u.scheme == "rediss":
            ctx = ssl.create_default_context()
            self._sock = ctx.wrap_socket(self._sock, server_hostname=host)
        self._buf = b""
        if u.password:
            password = urllib.parse.unquote(u.password)
            if u.username:
                self.command(
                    "AUTH", urllib.parse.unquote(u.username), password
                )
            else:
                self.command("AUTH", password)
        db = (u.path or "/").lstrip("/")
        if db:
            self.command("SELECT", db)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # -- wire format -------------------------------------------------------

    @staticmethod
    def _encode(parts: tuple[str | bytes, ...]) -> bytes:
        out = [b"*%d\r\n" % len(parts)]
        for p in parts:
            b = p if isinstance(p, bytes) else str(p).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def command(self, *parts: str | bytes):
        self._sock.sendall(self._encode(parts))
        return self._read_reply()

    def pipeline(self, commands: list[tuple[str | bytes, ...]]) -> list:
        """Send N commands in one write, then read N replies — one
        network round trip instead of N (the MissingBlobs diff probes
        every layer of an image with EXISTS)."""
        if not commands:
            return []
        self._sock.sendall(b"".join(self._encode(c) for c in commands))
        return [self._read_reply() for _ in commands]

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("redis: connection closed")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("redis: connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"redis: bad reply {line!r}")


class RedisCache(ArtifactCache):
    """redis.go RedisCache over the RESP client."""

    def __init__(self, url: str, ttl_seconds: int = 0, timeout: float = 30.0):
        self._client = RespClient(url, timeout=timeout)
        self._ttl = ttl_seconds
        self._client.command("PING")

    def _set(self, key: str, value: dict) -> None:
        data = json.dumps(value)
        if self._ttl > 0:
            self._client.command("SET", key, data, "EX", str(self._ttl))
        else:
            self._client.command("SET", key, data)

    def _get(self, key: str) -> dict | None:
        raw = self._client.command("GET", key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self._set(ARTIFACT_PREFIX + artifact_id, info.to_json())

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self._set(BLOB_PREFIX + blob_id, info.to_json())

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        doc = self._get(ARTIFACT_PREFIX + artifact_id)
        return ArtifactInfo.from_json(doc) if doc else None

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        doc = self._get(BLOB_PREFIX + blob_id)
        return BlobInfo.from_json(doc) if doc else None

    def exists(self, blob_id: str) -> bool:
        return bool(self._client.command("EXISTS", BLOB_PREFIX + blob_id))

    def missing_blobs(
        self, artifact_id: str, blob_ids: Iterable[str]
    ) -> tuple[bool, list[str]]:
        # One pipelined round trip: N blob EXISTS + the artifact EXISTS.
        ids = list(blob_ids)
        replies = self._client.pipeline(
            [("EXISTS", BLOB_PREFIX + bid) for bid in ids]
            + [("EXISTS", ARTIFACT_PREFIX + artifact_id)]
        )
        missing = [bid for bid, present in zip(ids, replies) if not present]
        return not replies[-1], missing

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        ids = [BLOB_PREFIX + b for b in blob_ids]
        if ids:
            self._client.command("DEL", *ids)

    def clear(self) -> None:
        cursor = "0"
        while True:
            reply = self._client.command(
                "SCAN", cursor, "MATCH", "fanal::*", "COUNT", "512"
            )
            cursor = (
                reply[0].decode()
                if isinstance(reply[0], bytes)
                else str(reply[0])
            )
            keys = reply[1] or []
            if keys:
                self._client.command("DEL", *keys)
            if cursor == "0":
                break

    def close(self) -> None:
        self._client.close()
