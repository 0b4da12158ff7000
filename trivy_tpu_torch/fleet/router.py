"""Client-side fleet routing: digest-affine member choice with failover.

`FleetRouter` is the policy that plugs into `RemoteSecretEngine` in
place of a single `RpcClient` (it quacks like one for the scan path:
`scan_secrets()`, `.headers`, `.last_response_headers`).  Per request:

1. hash the ruleset digest over the member table (fleet/ring.py) to get
   the digest's stable primary and ordered spillover list;
2. skip candidates the health table refuses (down/draining members —
   fleet/membership.py decides, and recovery probes ride real requests);
3. dispatch to the first admitted candidate with that member's
   keep-alive client; on 503 (drain), a long-Retry-After 429, or a
   connect failure, mark the member and spill to the next candidate;
4. attribute every attempt — member, reason, outcome, affinity
   hit/miss as reported by the server's X-Trivy-Fleet-* headers — to
   the bounded decision ring (fleet/decisions.py).

Spills and same-member 429 waits are metered by the process-wide
retry budget (rpc/client.py): a fleet-wide outage degrades to a bounded
trickle instead of members x attempts x load.  Deterministic 4xx errors
never spill — a 400/404 fails the same everywhere.
"""

from __future__ import annotations

import time
from typing import Callable

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.fleet import decisions, ring
from trivy_tpu_torch.fleet.membership import FleetMembership, Member
from trivy_tpu_torch.rpc.client import RpcClient, RpcError, retry_budget

# A 429 whose Retry-After exceeds this spills to the next candidate
# instead of waiting: the hint says this member is saturated for longer
# than a spillover round-trip costs.
SPILL_RETRY_AFTER_S = 1.0
# Same-member waits on a short-Retry-After 429 before treating it as a
# reject and spilling anyway.
MAX_SAME_MEMBER_RETRIES = 1

AFFINITY_HEADER = "X-Trivy-Fleet-Affinity"
MEMBER_HEADER = "X-Trivy-Fleet-Member"


class FleetExhaustedError(RpcError):
    """Every admitted member failed (or none were admitted)."""


class FleetRouter:
    """Digest-affine routing policy over a `FleetMembership` table."""

    def __init__(
        self,
        membership: FleetMembership,
        token: str = "",
        timeout_s: float = 300.0,
        client_factory: Callable[[str], RpcClient] | None = None,
        spill_retry_after_s: float = SPILL_RETRY_AFTER_S,
    ):
        self.membership = membership
        self.token = token
        self.timeout_s = timeout_s
        self.spill_retry_after_s = float(spill_retry_after_s)
        # RpcClient-compatible surface for RemoteSecretEngine: headers
        # ship on every dispatch; last_response_headers mirror the
        # member that actually answered.
        self.headers: dict[str, str] = {}
        self.last_response_headers: dict[str, str] = {}
        self.last_member = ""
        self.last_affinity = "unknown"
        self._client_factory = client_factory or self._default_client
        self._lock = lockcheck.make_lock("fleet.router")
        self._clients: dict[str, RpcClient] = {}  # owner: _lock
        self.sleep = time.sleep  # test seam (short-429 same-member waits)

    def _default_client(self, endpoint: str) -> RpcClient:
        # max_retries=1: the router IS the retry policy — spillover
        # replaces per-endpoint retries, so a sick member costs one
        # attempt, not a private backoff loop against a dead socket.
        return RpcClient(
            endpoint, self.token, max_retries=1, timeout_s=self.timeout_s
        )

    def client_for(self, member: Member) -> RpcClient:
        """The member's long-lived client (keep-alive socket reuse lives
        inside RpcClient; the router just avoids rebuilding clients)."""
        with self._lock:
            client = self._clients.get(member.endpoint)
            if client is None:
                client = self._client_factory(member.endpoint)
                self._clients[member.endpoint] = client
            return client

    def candidates(self, ruleset_digest: str) -> list[Member]:
        """The digest's rendezvous order over the full member table
        (health filters at dispatch time, not here — see membership)."""
        return ring.candidates(
            ruleset_digest or "default", self.membership.members()
        )

    # -- the scan path (RpcClient-compatible) ------------------------------

    def scan_secrets(
        self,
        items: list[tuple[str, bytes]],
        target: str = "",
        timeout_ms: int | None = None,
        client_id: str = "",
        ruleset_digest: str = "",
        explain: bool = False,
    ) -> dict:
        key = ruleset_digest or "default"
        order = self.candidates(ruleset_digest)
        budget = retry_budget()
        last_err: Exception | None = None
        reason = "primary"
        attempt = 0
        for member in order:
            if not self.membership.admit(member.name):
                decisions.record(
                    digest=key, member=member.name, reason=reason,
                    outcome="skip", attempt=attempt,
                )
                reason = "spill-health"
                continue
            client = self.client_for(member)
            waits = 0
            while True:
                if attempt > 0 and not budget.try_retry():
                    raise FleetExhaustedError(
                        f"fleet: retry budget exhausted routing "
                        f"digest {key}: {last_err}"
                    ) from last_err
                attempt += 1
                client.headers = dict(self.headers)
                try:
                    resp = client.scan_secrets(
                        items,
                        target=target,
                        timeout_ms=timeout_ms,
                        client_id=client_id,
                        ruleset_digest=ruleset_digest,
                        explain=explain,
                    )
                except RpcError as e:
                    status = client.last_error_status
                    retry_after = client.last_error_retry_after
                    if status == 503:
                        # Drain / closing scheduler: the member said so
                        # explicitly — honor its hint and spill.
                        self.membership.note_drain(member.name, retry_after)
                        decisions.record(
                            digest=key, member=member.name, reason=reason,
                            outcome="reject", attempt=attempt - 1,
                            error="HTTP 503",
                        )
                        last_err, reason = e, "spill-reject"
                        break
                    if status == 429:
                        # QoS pushback, not ill health.  Short hints are
                        # cheaper to wait out on the affine member (its
                        # pool is warm); long hints spill.
                        if (
                            (retry_after is None
                             or retry_after <= self.spill_retry_after_s)
                            and waits < MAX_SAME_MEMBER_RETRIES
                        ):
                            waits += 1
                            self.sleep(
                                retry_after
                                if retry_after is not None
                                else self.spill_retry_after_s
                            )
                            last_err = e
                            continue
                        decisions.record(
                            digest=key, member=member.name, reason=reason,
                            outcome="reject", attempt=attempt - 1,
                            error=f"HTTP 429 retry_after={retry_after}",
                        )
                        last_err, reason = e, "spill-reject"
                        break
                    if status is not None and 400 <= status < 500:
                        # Deterministic (bad request, unknown ruleset):
                        # spilling cannot fix it — fail fast.
                        decisions.record(
                            digest=key, member=member.name, reason=reason,
                            outcome="error", attempt=attempt - 1,
                            error=f"HTTP {status}",
                        )
                        raise
                    # Connect failure / reset / 5xx: count toward the
                    # member's down threshold and spill.
                    self.membership.note_failure(member.name)
                    decisions.record(
                        digest=key, member=member.name, reason=reason,
                        outcome="error", attempt=attempt - 1,
                        error=type(
                            e.__cause__ or e
                        ).__name__,
                    )
                    last_err, reason = e, "spill-error"
                    break
                # Success: restore health, mirror the answering member's
                # headers, attribute affinity.
                self.membership.note_success(member.name)
                self.last_response_headers = dict(
                    client.last_response_headers
                )
                served_by = self._header(MEMBER_HEADER) or member.name
                affinity = self._header(AFFINITY_HEADER) or "unknown"
                if affinity not in ("hit", "miss"):
                    affinity = "unknown"
                self.last_member = served_by
                self.last_affinity = affinity
                decisions.record(
                    digest=key, member=served_by, reason=reason,
                    outcome="ok", affinity=affinity, attempt=attempt - 1,
                )
                return resp
        raise FleetExhaustedError(
            f"fleet: no member served digest {key} "
            f"({len(order)} candidates): {last_err}"
        ) from last_err

    def _header(self, name: str) -> str:
        want = name.lower()
        return next(
            (
                v
                for k, v in self.last_response_headers.items()
                if k.lower() == want
            ),
            "",
        )

    # -- fleet-wide admin --------------------------------------------------

    def push_ruleset(
        self,
        rules_yaml: str = "",
        manifest_json: dict | None = None,
        npz: bytes | None = None,
        admit: bool = True,
    ) -> dict:
        """Install a ruleset on EVERY member (spillover correctness: any
        candidate may end up serving the digest, so each needs the
        artifact in its registry).  Returns the last successful response
        plus per-member status; raises only if no member accepted."""
        results: dict[str, str] = {}
        out: dict = {}
        for member in self.membership.members():
            client = self.client_for(member)
            client.headers = dict(self.headers)
            try:
                out = client.push_ruleset(
                    rules_yaml=rules_yaml,
                    manifest_json=manifest_json,
                    npz=npz,
                    admit=admit,
                )
                results[member.name] = "ok"
            except RpcError as e:
                results[member.name] = str(e)
        if "ok" not in results.values():
            raise FleetExhaustedError(f"fleet: push failed everywhere: {results}")
        out = dict(out)
        out["FleetPush"] = results
        return out

    def probe_all(self) -> dict[str, str]:
        return self.membership.probe_all()

    def report(self, limit: int = 32) -> dict:
        """The router's posture: member health + recent decisions +
        affinity economics (the client-side complement of the server's
        /debug/fleet)."""
        return {
            "members": self.membership.snapshot(),
            "decisions": decisions.records(limit),
            "tallies": {
                f"{member}/{reason}": n
                for (member, reason), n in sorted(decisions.tallies().items())
            },
            "affinity": decisions.affinity_tallies(),
            "affinity_hit_rate": decisions.affinity_hit_rate(),
        }

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
