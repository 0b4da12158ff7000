"""RPC client: remote scan driver + remote cache + remote secret engine.

Mirrors pkg/rpc/client/client.go (Scanner with custom headers) and
pkg/cache/remote.go (RemoteCache), with retry/exponential backoff like
pkg/rpc/retry.go.  The retry loop speaks the server's backpressure
protocol: 429/503 responses (the serve scheduler's admission rejections)
are retried with jittered exponential backoff floored by the server's
Retry-After hint; other 4xx are deterministic and never retried.

Retries are additionally metered by a process-wide sliding-window
*retry budget* (~10% of recent request volume, floored so low-traffic
processes can still retry): when the server is hard-down, per-call
backoff alone still multiplies offered load by the attempt cap, and a
fleet of clients doing that simultaneously is a retry storm.  A dry
budget fails the call immediately with the last underlying error.

Transport: one keep-alive HTTP/1.1 connection per (client, thread),
reused across calls — the fleet router multiplies request count across
member endpoints, and a fresh TCP handshake per request is pure connect
tax.  A reused socket the server closed while idle gets one transparent
reconnect-and-resend; anything that fails mid-exchange poisons the
framing and drops the socket, so the next attempt starts clean.

Copied from `trivy_tpu/rpc/client.py` (the port imports nothing from the
JAX package): `RpcClient` over the JSON and protobuf wires
(`rpc/protowire.py`), its retry budget, `RemoteDriver`,
`RemoteSecretEngine` (one endpoint, or a `fleet.FleetRouter`) and
`RemoteCache`.
"""

from __future__ import annotations

import base64
import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.parse
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

from trivy_tpu_torch import faults
from trivy_tpu_torch.atypes import ArtifactInfo, BlobInfo, _secret_from_json
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.rpc.convert import blob_to_json, os_from_json, result_from_json
from trivy_tpu_torch.rpc.server import TOKEN_HEADER
from trivy_tpu_torch.scanner.service import Driver, ScanOptions

MAX_RETRIES = 4
BACKOFF_BASE_S = 0.2
BACKOFF_CAP_S = 8.0

RETRY_BUDGET_WINDOW_S = 60.0
RETRY_BUDGET_RATIO = 0.1
RETRY_BUDGET_MIN = 3


class RpcError(RuntimeError):
    pass


class RetryBudget:
    """Sliding-window retry budget shared by every client in the process.

    Retries in the last `window_s` seconds are capped at
    ``max(min_floor, ratio * requests_in_window)`` — i.e. steady traffic
    earns retry headroom proportional to its volume, while an outage
    degrades to a bounded trickle instead of ``attempts × load``.  The
    floor keeps a quiet process (one CLI scan) able to ride out a 429.
    """

    def __init__(
        self,
        window_s: float = RETRY_BUDGET_WINDOW_S,
        ratio: float = RETRY_BUDGET_RATIO,
        min_floor: int = RETRY_BUDGET_MIN,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self.window_s = window_s
        self.ratio = ratio
        self.min_floor = min_floor
        self._clock = clock
        self._requests: deque[float] = deque()  # owner: _lock
        self._retries: deque[float] = deque()  # owner: _lock
        self.retries_total = 0  # owner: _lock (monotonic)
        self.exhausted_total = 0  # owner: _lock (monotonic)

    def _prune(self, now: float) -> None:  # graftlint: holds(_lock)
        cutoff = now - self.window_s
        while self._requests and self._requests[0] < cutoff:
            self._requests.popleft()
        while self._retries and self._retries[0] < cutoff:
            self._retries.popleft()

    def note_request(self) -> None:
        """Count one logical call() toward the window's request volume."""
        with self._lock:
            now = self._clock()
            self._prune(now)
            self._requests.append(now)

    def try_retry(self) -> bool:
        """Spend one retry if the window allows it; False = budget dry
        (the caller must fail fast with its last underlying error)."""
        with self._lock:
            now = self._clock()
            self._prune(now)
            cap = max(self.min_floor, int(self.ratio * len(self._requests)))
            if len(self._retries) >= cap:
                self.exhausted_total += 1
                return False
            self._retries.append(now)
            self.retries_total += 1
            return True

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            self._prune(now)
            return {
                "window_s": self.window_s,
                "requests_in_window": len(self._requests),
                "retries_in_window": len(self._retries),
                "client_retries_total": self.retries_total,
                "client_retry_budget_exhausted_total": self.exhausted_total,
            }


# The process-wide budget (a retry storm is a per-process phenomenon —
# every RpcClient instance feeds the same socket pool and server).
_BUDGET = RetryBudget()


def retry_budget() -> RetryBudget:
    return _BUDGET


def client_retries_total() -> int:
    return _BUDGET.snapshot()["client_retries_total"]


def client_retry_budget_exhausted_total() -> int:
    return _BUDGET.snapshot()["client_retry_budget_exhausted_total"]


def reset_retry_budget(budget: RetryBudget | None = None) -> None:
    """Swap in a fresh (or custom-clocked) budget — tests only."""
    global _BUDGET
    _BUDGET = budget if budget is not None else RetryBudget()


def _parse_retry_after(value: str | None) -> float | None:
    """Seconds form of Retry-After (the only form the server emits)."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def _backoff_s(attempt: int, retry_after: float | None) -> float:
    """Jittered exponential backoff (retry.go semantics): full jitter in
    [0.5x, 1.5x) of the capped exponential step, floored by the server's
    Retry-After hint so a 429's advice is never undercut."""
    delay = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2**attempt))
    delay *= 0.5 + random.random()
    if retry_after is not None:
        delay = max(delay, retry_after)
    return delay


@dataclass
class RpcClient:
    addr: str  # host:port
    token: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    # "json" (default) or "protobuf": the two Twirp wire formats.  The
    # protobuf wire is byte-compatible with the reference's Go client
    # (rpc/{scanner,cache}/service.proto field numbers).
    wire: str = "json"
    max_retries: int = MAX_RETRIES
    timeout_s: float = 300.0  # per-attempt socket timeout
    # Response headers of the last successful call (trace correlation:
    # the server echoes X-Trivy-Trace-Id here).
    last_response_headers: dict[str, str] = field(default_factory=dict)
    # Classification of the last call() failure, for policies layered on
    # top (the fleet router picks its spill rung from these): the HTTP
    # status, None for connection-level failures, 0 for no failure.
    last_error_status: int | None = 0
    last_error_retry_after: float | None = None
    # New TCP connections this client opened — the keep-alive regression
    # observable (sequential calls must not grow it).
    connects_total: int = 0
    _local: threading.local = field(
        default_factory=threading.local, repr=False, compare=False
    )
    sleep = staticmethod(time.sleep)  # test seam

    def _base_url(self) -> str:
        # Accept both bare "host:port" and full "http(s)://host:port" forms
        # (the reference's --server flag takes a URL).
        base = self.addr.rstrip("/")
        if not base.startswith(("http://", "https://")):
            base = f"http://{base}"
        return base

    def _connect(self, scheme: str, netloc: str) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(netloc, timeout=self.timeout_s)
        self.connects_total += 1
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Drop this thread's keep-alive socket (other threads' sockets
        die with their threads)."""
        self._drop_connection()

    def _transport(
        self, url: str, body: bytes, headers: dict[str, str]
    ) -> tuple[int, dict[str, str], bytes]:
        """POST over this thread's persistent connection; returns
        (status, headers, body).  The one transparent resend covers the
        keep-alive race — a reused socket the server closed between
        requests — and only that: a fresh connection's failure, or any
        error after bytes started flowing, propagates to the retry loop.
        """
        parts = urllib.parse.urlsplit(url)
        conn = getattr(self._local, "conn", None)
        fresh = conn is None
        if fresh:
            conn = self._connect(parts.scheme, parts.netloc)
            self._local.conn = conn
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        try:
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
            except (
                http.client.CannotSendRequest,
                http.client.RemoteDisconnected,
                ConnectionResetError,
                BrokenPipeError,
            ):
                self._drop_connection()
                if fresh:
                    raise
                conn = self._connect(parts.scheme, parts.netloc)
                self._local.conn = conn
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
            raw = resp.read()
        except BaseException:
            # Mid-exchange failure: the framing is unknown — reconnect
            # on the next attempt rather than desynchronize.
            self._drop_connection()
            raise
        if resp.will_close:
            self._drop_connection()
        return resp.status, dict(resp.getheaders()), raw

    def call(self, path: str, payload: dict) -> dict:
        url = f"{self._base_url()}{path}"
        if self.wire == "protobuf":
            from trivy_tpu_torch.rpc import protowire

            if not protowire.available():
                raise RpcError("protobuf wire unavailable (no protoc/runtime)")
            body = protowire.encode_request(path, payload)
            ctype = "application/protobuf"
        else:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        last: Exception | None = None
        attempts = max(1, self.max_retries)
        _BUDGET.note_request()
        self.last_error_status = 0
        self.last_error_retry_after = None
        for attempt in range(attempts):
            headers = {"Content-Type": ctype}
            if self.token:
                headers[TOKEN_HEADER] = self.token
            headers.update(self.headers)
            retry_after: float | None = None
            try:
                status, rhdrs, raw = self._transport(url, body, headers)
                if 200 <= status < 300:
                    # Chaos seam: client-side receive faults.  After the
                    # read, before the decode, so reset/truncate kinds
                    # land in exactly the retryable except clause below
                    # that their real counterparts would hit.
                    faults.fire("rpc.recv")
                    self.last_response_headers = rhdrs
                    self.last_error_status = 0
                    self.last_error_retry_after = None
                    if self.wire == "protobuf":
                        from trivy_tpu_torch.rpc import protowire

                        return protowire.decode_response(path, raw)
                    return json.loads(raw)
                if status in (429, 503):
                    # Backpressure (queue full / client cap / draining):
                    # retryable, honoring the server's Retry-After floor.
                    retry_after = _parse_retry_after(
                        next(
                            (
                                v
                                for k, v in rhdrs.items()
                                if k.lower() == "retry-after"
                            ),
                            None,
                        )
                    )
                    self.last_error_status = status
                    self.last_error_retry_after = retry_after
                    last = RpcError(f"{path}: HTTP {status}: {raw!r}")
                elif 400 <= status < 500:  # deterministic; non-retryable
                    self.last_error_status = status
                    self.last_error_retry_after = None
                    raise RpcError(f"{path}: HTTP {status}: {raw!r}")
                else:
                    self.last_error_status = status
                    self.last_error_retry_after = None
                    last = RpcError(f"{path}: HTTP {status}: {raw!r}")
            except (
                urllib.error.URLError,
                http.client.HTTPException,
                OSError,
                json.JSONDecodeError,
            ) as e:
                # Connection reset / refused / truncated body: retryable.
                last = e
                self.last_error_status = None
                self.last_error_retry_after = None
            if attempt + 1 < attempts:
                if not _BUDGET.try_retry():
                    raise RpcError(
                        f"{path}: retry budget exhausted: {last}"
                    ) from last
                self.sleep(_backoff_s(attempt, retry_after))
        raise RpcError(
            f"{path}: retries exhausted after {attempts} attempts: {last}"
        )

    def scan_secrets(
        self,
        items: list[tuple[str, bytes]],
        target: str = "",
        timeout_ms: int | None = None,
        client_id: str = "",
        ruleset_digest: str = "",
        explain: bool = False,
    ) -> dict:
        """POST raw (path, blob) items to the server's continuous batcher
        (Scanner/ScanSecrets).  JSON-only: contents travel base64.
        `ruleset_digest` routes the request onto that pushed ruleset's
        batching lane ("" = the server's default ruleset).  `explain` asks
        the server to echo the per-phase timing breakdown (queue wait,
        batch fill, engine phases) in the response's Explain field."""
        payload: dict = {
            "Target": target,
            "Files": [
                {"Path": p, "ContentB64": base64.b64encode(c).decode()}
                for p, c in items
            ],
        }
        if timeout_ms:
            payload["TimeoutMs"] = int(timeout_ms)
        if client_id:
            payload["ClientID"] = client_id
        if ruleset_digest:
            payload["RulesetDigest"] = ruleset_digest
        if explain:
            payload["Explain"] = True
        return self.call("/twirp/trivy.scanner.v1.Scanner/ScanSecrets", payload)

    def push_ruleset(
        self,
        rules_yaml: str = "",
        manifest_json: dict | None = None,
        npz: bytes | None = None,
        admit: bool = True,
    ) -> dict:
        """POST /admin/ruleset/push: install a ruleset (and optionally its
        client-side-compiled artifact) into the server's registry.  Rides
        call(), so quota/drain rejections (429/503) get the same jittered
        Retry-After-floored backoff as scans."""
        payload: dict = {"Admit": bool(admit)}
        if rules_yaml:
            payload["RulesYamlB64"] = base64.b64encode(
                rules_yaml.encode("utf-8")
            ).decode()
        if manifest_json is not None:
            payload["ManifestJson"] = manifest_json
        if npz is not None:
            payload["NpzB64"] = base64.b64encode(npz).decode()
        return self.call("/admin/ruleset/push", payload)


@dataclass
class RemoteDriver(Driver):
    """pkg/rpc/client Scanner: the Driver seam over the wire."""

    addr: str
    token: str = ""
    wire: str = "json"  # or "protobuf" (reference Go client wire)
    # Client --timeout forwarded so the SERVER arms the same deadline
    # (rpc/server.py _arm_deadline): a server-side scan is bounded even
    # when the client dies mid-request.  0 = unbounded (legacy).
    timeout_s: float = 0.0

    def scan(self, target, artifact_id, blob_ids, options: ScanOptions):
        client = RpcClient(self.addr, self.token, wire=self.wire)
        payload = {
            "Target": target,
            "ArtifactID": artifact_id,
            "BlobIDs": list(blob_ids),
            "Options": {
                "Scanners": list(options.scanners),
                "PkgTypes": list(options.pkg_types),
                "ListAllPackages": options.list_all_packages,
            },
        }
        if self.timeout_s and self.timeout_s > 0:
            payload["TimeoutMs"] = int(self.timeout_s * 1000)
        resp = client.call("/twirp/trivy.scanner.v1.Scanner/Scan", payload)
        results = [result_from_json(r) for r in (resp.get("Results") or [])]
        return results, os_from_json(resp.get("OS"))


# Per-request Explain breakdowns from the current process's --explain
# scans, appended in completion order (newest last).  Module-level on
# purpose: the CLI's engine instance is buried inside the analyzer stack,
# and the command layer reads this after the artifact walk completes.
# Reset whenever an explain-enabled engine is constructed (one scan's
# breakdowns never bleed into the next).
LAST_EXPLAINS: list[dict] = []


def format_explain(exp: dict) -> str:
    """Pretty-print one ScanSecrets Explain breakdown (CLI --explain):
    where the request's wall time went, phase by phase."""
    if not exp:
        return "explain: server returned no breakdown"
    b = exp.get("batch") or {}
    head = (
        f"explain: trace={exp.get('trace_id') or '-'} "
        f"lane={b.get('lane', '-')} "
        f"batch={b.get('tickets', '?')} req"
        f" / {b.get('items', '?')} items"
        f" / {b.get('bytes', 0)} B"
    )
    if b.get("coalesced"):
        head += " (coalesced)"
    lines = [head]
    lines.append(
        f"  {'queue wait':<12} {float(exp.get('queue_wait_ms', 0.0)):>10.3f} ms"
    )
    for name, ms in (exp.get("phases_ms") or {}).items():
        lines.append(f"  {name:<12} {float(ms):>10.3f} ms")
    lines.append(
        f"  {'batch wall':<12} {float(exp.get('batch_wall_ms', 0.0)):>10.3f} ms"
    )
    return "\n".join(lines)


class RemoteSecretEngine:
    """The secret-engine seat over the wire (--secret-backend server).

    Drop-in for the analyzer's engine protocol (scan_batch/scan): raw
    (path, blob) items ship to the server's continuous batcher, where they
    coalesce with items from OTHER client processes into one device batch.
    This is the sidecar deployment the server docstring promises — many
    thin scanning clients, one TPU-owning engine process.

    No local ruleset is loaded, so the analyzer's client-side allow-path
    pre-skip is a no-op; the server engine applies the same gate inside
    scan_batch, and empty results are filtered identically — findings stay
    byte-identical to a local engine.
    """

    def __init__(
        self,
        addr: str,
        token: str = "",
        timeout_s: float = 0.0,
        client_id: str = "",
        ruleset_select: str = "",
        explain: bool = False,
        router=None,
    ):
        # The fleet seam (trivy_tpu_torch/fleet/): a FleetRouter is
        # RpcClient-compatible on the scan path (scan_secrets, .headers,
        # .last_response_headers) and replaces the single-endpoint
        # client — requests then follow digest-affine routing with
        # health-aware spillover instead of pinning to `addr`.
        self.client = router if router is not None else RpcClient(addr, token)
        self.timeout_s = timeout_s
        self.client_id = client_id
        # Digest of a pushed ruleset every batch should scan under ("" =
        # the server's default).  Per-tenant pinning: two clients with
        # different selections share the server but never a batch.
        self.ruleset_select = ruleset_select
        # Digest of the server-side ruleset that scanned the LAST batch
        # (response RulesetDigest field); "" until a scan completes.  Lets
        # thin clients log/compare which rule version produced findings
        # even though no ruleset is loaded locally.
        self.ruleset_digest = ""
        # Trace id of the last batch, as echoed in the server's
        # X-Trivy-Trace-Id response header: the key that joins this
        # client's spans with the server's batch/chunk spans.
        self.last_trace_id = ""
        # --explain: ship X-Trivy-Explain on every batch and collect the
        # per-phase breakdowns for the CLI to print after the scan.
        self.explain = explain
        self.last_explain: dict = {}
        if explain:
            self.client.headers["X-Trivy-Explain"] = "1"
            del LAST_EXPLAINS[:]

    def scan_batch(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        if not items:
            return []
        # This is where a trace is born: mint an id (or inherit the
        # enclosing span's), ship it in the request header so server-side
        # queue/batch/chunk spans join this client's tree.
        trace_id = ""
        if obs_trace.enabled():
            trace_id = obs_trace.current_trace_id() or obs_trace.new_trace_id()
            self.client.headers["X-Trivy-Trace-Id"] = trace_id
        with obs_trace.span(
            "rpc.scan_secrets",
            trace_id=trace_id or None,
            items=len(items),
            bytes=sum(len(c) for _, c in items),
        ):
            resp = self.client.scan_secrets(
                items,
                timeout_ms=int(self.timeout_s * 1000) if self.timeout_s else None,
                client_id=self.client_id,
                ruleset_digest=self.ruleset_select,
                explain=self.explain,
            )
        echoed = next(
            (
                v
                for k, v in self.client.last_response_headers.items()
                if k.lower() == "x-trivy-trace-id"
            ),
            "",
        )
        self.last_trace_id = echoed or trace_id
        self.ruleset_digest = str(resp.get("RulesetDigest") or "")
        if self.explain:
            self.last_explain = dict(resp.get("Explain") or {})
            LAST_EXPLAINS.append(self.last_explain)
        secrets = [
            _secret_from_json(d) for d in (resp.get("Secrets") or [])
        ]
        if len(secrets) != len(items):
            raise RpcError(
                f"ScanSecrets returned {len(secrets)} results for "
                f"{len(items)} items"
            )
        return secrets

    def scan(self, path: str, content: bytes) -> Secret:
        return self.scan_batch([(path, content)])[0]


class RemoteCache(ArtifactCache):
    """pkg/cache/remote.go: Put side goes to the server; Get side is absent on
    the client (the server owns the applier), mirroring NopCache-wrapping."""

    def __init__(self, addr: str, token: str = "", wire: str = "json"):
        self.client = RpcClient(addr, token, wire=wire)

    def put_artifact(self, artifact_id: str, info: ArtifactInfo) -> None:
        self.client.call(
            "/twirp/trivy.cache.v1.Cache/PutArtifact",
            {"ArtifactID": artifact_id, "ArtifactInfo": info.to_json()},
        )

    def put_blob(self, blob_id: str, info: BlobInfo) -> None:
        self.client.call(
            "/twirp/trivy.cache.v1.Cache/PutBlob",
            {"BlobID": blob_id, "BlobInfo": blob_to_json(info)},
        )

    def get_artifact(self, artifact_id: str) -> ArtifactInfo | None:
        return None  # client never reads artifacts back

    def get_blob(self, blob_id: str) -> BlobInfo | None:
        return None

    def missing_blobs(
        self, artifact_id: str, blob_ids: Iterable[str]
    ) -> tuple[bool, list[str]]:
        resp = self.client.call(
            "/twirp/trivy.cache.v1.Cache/MissingBlobs",
            {"ArtifactID": artifact_id, "BlobIDs": list(blob_ids)},
        )
        return bool(resp.get("MissingArtifact")), list(resp.get("MissingBlobIDs") or [])

    def delete_blobs(self, blob_ids: Iterable[str]) -> None:
        self.client.call(
            "/twirp/trivy.cache.v1.Cache/DeleteBlobs", {"BlobIDs": list(blob_ids)}
        )

    def clear(self) -> None:
        pass
