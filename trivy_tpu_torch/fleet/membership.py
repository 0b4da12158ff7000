"""Fleet membership: static member table + per-host health state.

The member list is static configuration (a YAML file every fleet
participant shares — see `load_fleet_config`); what is *dynamic* is each
member's health, driven by two signals:

- **passive request outcomes**: the router marks a member that answered
  503 as draining (honoring its Retry-After), and counts connect
  failures / resets toward a failure threshold that marks it down;
- **active `/readyz` probes**: `probe()` GETs the member's readiness
  surface, so health converges even with no traffic in flight.

Recovery is probe-based, reusing the circuit-breaker shape
(engine/breaker.py): a down member sits out a cooldown, then exactly one
request (or active probe) is admitted to test it — success restores it,
failure restarts the cooldown.  States:

    up        healthy; failures counted in a sliding window
    draining  answered 503 (drain / backpressure); out of rotation
              until its Retry-After hint expires, then probe-eligible
    down      threshold connect failures; out until cooldown, then
              one probe
    probing   one request in flight deciding up vs down

Thread model: the router calls admit()/note_*() from request threads;
snapshot() is read by /debug/fleet and bench code — all state sits
under one membership lock.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable

from trivy_tpu_torch import lockcheck

DEFAULT_FAILURE_THRESHOLD = 3
DEFAULT_WINDOW_S = 30.0
DEFAULT_COOLDOWN_S = 5.0
DEFAULT_DRAIN_S = 5.0
PROBE_TIMEOUT_S = 2.0

STATE_CODES = {"up": 0, "probing": 1, "draining": 2, "down": 3}


@dataclass(frozen=True)
class Member:
    """One fleet participant: a routing name (the rendezvous hash key),
    where to reach it, and its share of the digest space."""

    name: str
    endpoint: str  # host:port or http(s)://host:port
    weight: float = 1.0


@dataclass(frozen=True)
class FleetConfig:
    members: tuple[Member, ...]
    # The member name THIS process answers as (server side; "" on pure
    # clients).  YAML `self:` or the server's --fleet-member flag.
    self_name: str = ""

    def member(self, name: str) -> Member | None:
        return next((m for m in self.members if m.name == name), None)


class FleetConfigError(ValueError):
    pass


def parse_fleet_config(doc: dict) -> FleetConfig:
    """Validate one parsed fleet YAML document.  Accepts either a
    top-level {members: [...], self: name} mapping or the same nested
    under a `fleet:` key (so the file can ride a larger config)."""
    if not isinstance(doc, dict):
        raise FleetConfigError("fleet config must be a mapping")
    if isinstance(doc.get("fleet"), dict):
        doc = doc["fleet"]
    raw = doc.get("members")
    if not isinstance(raw, list) or not raw:
        raise FleetConfigError("fleet config needs a non-empty members list")
    members: list[Member] = []
    seen: set[str] = set()
    for i, entry in enumerate(raw):
        if not isinstance(entry, dict):
            raise FleetConfigError(f"members[{i}] must be a mapping")
        name = str(entry.get("name") or "")
        endpoint = str(entry.get("endpoint") or "")
        if not name or not endpoint:
            raise FleetConfigError(
                f"members[{i}] needs both name and endpoint"
            )
        if name in seen:
            raise FleetConfigError(f"duplicate member name {name!r}")
        seen.add(name)
        try:
            weight = float(entry.get("weight", 1.0))
        except (TypeError, ValueError):
            raise FleetConfigError(
                f"members[{i}].weight must be a number"
            ) from None
        if weight < 0:
            raise FleetConfigError(f"members[{i}].weight must be >= 0")
        members.append(Member(name=name, endpoint=endpoint, weight=weight))
    self_name = str(doc.get("self") or "")
    if self_name and self_name not in seen:
        raise FleetConfigError(
            f"self {self_name!r} is not in the members list"
        )
    return FleetConfig(members=tuple(members), self_name=self_name)


def load_fleet_config(path: str) -> FleetConfig:
    """Read and validate a fleet YAML file (--fleet-config)."""
    import yaml

    with open(path, encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    return parse_fleet_config(doc or {})


class MemberHealth:
    """One member's availability state machine (the breaker shape with a
    drain rung).  Callers hold the membership lock; this class itself is
    lock-free on purpose — one lock for the whole table keeps admit()'s
    read-modify-write of several members atomic."""

    def __init__(
        self,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        window_s: float = DEFAULT_WINDOW_S,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.state = "up"
        self._failures: list[float] = []
        self._retry_at = 0.0  # when a down/draining member becomes probe-eligible
        self.marked_down_total = 0
        self.drains_total = 0
        self.recoveries_total = 0
        self.probes_total = 0

    def admit(self) -> bool:
        """May a request route to this member now?  A down/draining
        member whose cooldown/Retry-After elapsed converts to probing and
        admits exactly this one request; requests behind the probe are
        refused until it resolves."""
        if self.state == "up":
            return True
        if self.state == "probing":
            return False  # one probe at a time
        if self._clock() >= self._retry_at:
            self.state = "probing"
            self.probes_total += 1
            return True
        return False

    def note_success(self) -> None:
        if self.state != "up":
            self.recoveries_total += 1
        self.state = "up"
        del self._failures[:]

    def note_failure(self) -> None:
        """A connect failure / reset.  Probes fail hard (restart the
        cooldown); an up member tolerates threshold-1 failures in the
        window first."""
        now = self._clock()
        if self.state in ("probing", "draining"):
            self._mark_down(now)
            return
        if self.state == "down":
            self._retry_at = now + self.cooldown_s
            return
        self._failures.append(now)
        cutoff = now - self.window_s
        self._failures[:] = [t for t in self._failures if t >= cutoff]
        if len(self._failures) >= self.failure_threshold:
            self._mark_down(now)

    def note_drain(self, retry_after_s: float | None = None) -> None:
        """The member answered 503: it is draining (or hard-backpressured)
        and said when to come back.  Unlike note_failure this is a
        *protocol* signal — the host is alive and explicit — so it never
        counts toward the down threshold."""
        self.state = "draining"
        self.drains_total += 1
        wait = retry_after_s if retry_after_s is not None else DEFAULT_DRAIN_S
        self._retry_at = self._clock() + max(0.0, float(wait))

    def _mark_down(self, now: float) -> None:
        self.state = "down"
        self.marked_down_total += 1
        self._retry_at = now + self.cooldown_s
        del self._failures[:]

    def snapshot(self) -> dict:
        now = self._clock()
        return {
            "state": self.state,
            "state_code": STATE_CODES[self.state],
            "failures_in_window": len(self._failures),
            "failure_threshold": self.failure_threshold,
            "retry_in_s": (
                round(max(0.0, self._retry_at - now), 3)
                if self.state in ("down", "draining")
                else 0.0
            ),
            "marked_down_total": self.marked_down_total,
            "drains_total": self.drains_total,
            "recoveries_total": self.recoveries_total,
            "probes_total": self.probes_total,
        }


def probe_readyz(
    endpoint: str, timeout_s: float = PROBE_TIMEOUT_S
) -> tuple[bool | None, float | None]:
    """GET the member's /readyz.  Returns (ok, retry_after_s):
    (True, None) ready, (False, hint) explicit 503, (None, None)
    unreachable — three distinct outcomes because they feed different
    health transitions (success / drain / failure)."""
    base = endpoint.rstrip("/")
    if not base.startswith(("http://", "https://")):
        base = f"http://{base}"
    try:
        with urllib.request.urlopen(
            f"{base}/readyz", timeout=timeout_s
        ) as resp:
            resp.read()
            return True, None
    except urllib.error.HTTPError as e:
        try:
            e.read()
        finally:
            e.close()
        if e.code == 503:
            hint = e.headers.get("Retry-After")
            try:
                retry_after = max(0.0, float(hint)) if hint else None
            except ValueError:
                retry_after = None
            return False, retry_after
        return None, None
    except (urllib.error.URLError, OSError):
        return None, None


class FleetMembership:
    """The member table with live health, shared by router and server.

    `members()` hands the full static table to the rendezvous ring (the
    hash order must be membership-stable — health only decides whether a
    candidate is *admitted*, never its position, or every blip would
    reshuffle the digest space)."""

    def __init__(
        self,
        members: list[Member] | tuple[Member, ...],
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        window_s: float = DEFAULT_WINDOW_S,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        clock: Callable[[], float] = time.monotonic,
        prober: Callable[[str], tuple[bool | None, float | None]] | None = None,
    ):
        if not members:
            raise FleetConfigError("fleet membership needs at least one member")
        self._lock = lockcheck.make_lock("fleet.membership")
        self._members: tuple[Member, ...] = tuple(members)
        self._prober = prober or probe_readyz
        self._health: dict[str, MemberHealth] = {  # owner: _lock
            m.name: MemberHealth(
                failure_threshold=failure_threshold,
                window_s=window_s,
                cooldown_s=cooldown_s,
                clock=clock,
            )
            for m in self._members
        }

    @classmethod
    def from_config(cls, config: FleetConfig, **kw) -> "FleetMembership":
        return cls(list(config.members), **kw)

    def members(self) -> tuple[Member, ...]:
        return self._members

    def member(self, name: str) -> Member | None:
        return next((m for m in self._members if m.name == name), None)

    def state(self, name: str) -> str:
        with self._lock:
            return self._health[name].state

    def admit(self, name: str) -> bool:
        """Router-side gate: may a request go to this member right now?
        Claims the probe slot when the member is recovery-eligible."""
        with self._lock:
            return self._health[name].admit()

    def note_success(self, name: str) -> None:
        with self._lock:
            self._health[name].note_success()

    def note_failure(self, name: str) -> None:
        with self._lock:
            self._health[name].note_failure()

    def note_drain(self, name: str, retry_after_s: float | None = None) -> None:
        with self._lock:
            self._health[name].note_drain(retry_after_s)

    def probe(self, name: str) -> str:
        """Actively probe one member's /readyz and fold the outcome into
        its health; returns the post-probe state."""
        member = self.member(name)
        if member is None:
            raise KeyError(name)
        ok, retry_after = self._prober(member.endpoint)
        with self._lock:
            h = self._health[name]
            if ok is True:
                h.note_success()
            elif ok is False:
                h.note_drain(retry_after)
            else:
                h.note_failure()
            return h.state

    def probe_all(self) -> dict[str, str]:
        """Probe every member (serially — fleet tables are small); the
        convergence path when no traffic is flowing."""
        return {m.name: self.probe(m.name) for m in self._members}

    def snapshot(self) -> dict:
        """Per-member static config + live health, for /debug/fleet and
        the router's decision attribution."""
        with self._lock:
            return {
                m.name: {
                    "endpoint": m.endpoint,
                    "weight": m.weight,
                    **self._health[m.name].snapshot(),
                }
                for m in self._members
            }


# Beyond this cap the per-digest request tallies fold into "_other":
# digest keys come from pushed rulesets (operator-controlled), but a
# debug surface must stay bounded even under a pathological push loop.
MAX_TRACKED_DIGESTS = 256


class FleetSelf:
    """A server's fleet self-awareness: who am I, who are my peers, and
    what affinity has my traffic shown?

    Constructed from --fleet-config (+ --fleet-member); the scan path
    calls `note_scan()` per request with a residency hint, and the
    /debug/fleet surface renders `report()`.  A digest counts as an
    affinity *hit* when this host already held it (pool-resident /
    active default engine) or had scanned it before — i.e. the router
    sent warm traffic where warmth lives; first touches are misses."""

    def __init__(
        self,
        config: FleetConfig,
        self_name: str = "",
        membership: FleetMembership | None = None,
    ):
        name = self_name or config.self_name
        if not name:
            raise FleetConfigError(
                "server fleet config needs a self member (YAML `self:` "
                "or --fleet-member)"
            )
        if config.member(name) is None:
            raise FleetConfigError(
                f"fleet member {name!r} is not in the members list"
            )
        self.config = config
        self.name = name
        # Peer health from THIS host's perspective; populated only when
        # something probes (GET /debug/fleet?probe=1) — the surface must
        # stay cheap by default.
        self.membership = membership or FleetMembership.from_config(config)
        self._lock = lockcheck.make_lock("fleet.self")
        self._seen: set[str] = set()  # owner: _lock (digest keys scanned)
        self._affinity = {"hit": 0, "miss": 0}  # owner: _lock
        self._by_digest: dict[str, int] = {}  # owner: _lock

    def note_scan(self, digest: str, resident_hint: bool = False) -> str:
        """Record one ScanSecrets arrival for `digest` ("" = default);
        returns "hit" or "miss" for the response's affinity header."""
        key = digest or "default"
        with self._lock:
            hit = resident_hint or key in self._seen
            self._seen.add(key)
            outcome = "hit" if hit else "miss"
            self._affinity[outcome] += 1
            if (
                key in self._by_digest
                or len(self._by_digest) < MAX_TRACKED_DIGESTS
            ):
                self._by_digest[key] = self._by_digest.get(key, 0) + 1
            else:
                self._by_digest["_other"] = (
                    self._by_digest.get("_other", 0) + 1
                )
        return outcome

    def seen_digests(self) -> list[str]:
        with self._lock:
            return sorted(self._seen)

    def affinity(self) -> dict:
        with self._lock:
            hits, misses = self._affinity["hit"], self._affinity["miss"]
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else None,
        }

    def brief(self) -> dict:
        """The compact posture block for scheduler snapshots and flight
        captures: enough to answer "which member was this, how big is
        the fleet, was its traffic affine" without the full report."""
        with self._lock:
            requests = dict(self._by_digest)
        return {
            "member": self.name,
            "members": len(self.config.members),
            "affinity": self.affinity(),
            "requests_by_digest": requests,
        }

    def report(self, probe: bool = False) -> dict:
        """The /debug/fleet core: membership table (+ live peer health
        when `probe` actively checks each member's /readyz), this host's
        identity, resident-digest history, and affinity economics."""
        if probe:
            self.membership.probe_all()
        return {
            "self": self.name,
            "members": self.membership.snapshot(),
            "seen_digests": self.seen_digests(),
            "affinity": self.affinity(),
            "requests_by_digest": self.brief()["requests_by_digest"],
        }
