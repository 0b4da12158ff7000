"""Deterministic fault-injection plane: named seams, seeded triggers.

Copied from `trivy_tpu/faults.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.  The port's
engine fires `device.put`, `device.exec` and `device.fetch`; the other
seams are kept so specs written for the reference parse alike.

The runtime failure domains (per-batch DFA degradation, the device
circuit breaker, OOM shed-and-retry — see serve/scheduler.py) are only
trustworthy if their failure paths run in CI.  Real device faults are
rare and non-deterministic, so the hot paths carry named *seams* —
single call sites like ``faults.fire("device.exec")`` — and this module
decides, deterministically, whether a configured fault triggers there.

Spec grammar (``TRIVY_TPU_FAULTS`` env var, or :func:`configure`):

    spec  := entry ("," entry)*
    entry := seam ":" kind "@" rate ["x" max_fires]

    TRIVY_TPU_FAULTS="device.exec:oom@0.1,rpc.recv:reset@0.05,registry.load:corrupt@1"
    TRIVY_TPU_FAULTS="sched.dispatch:error@1x8"   # fire 8 times, then stop

``rate`` is a probability in [0, 1]; draws come from ONE seeded RNG
(``TRIVY_TPU_FAULTS_SEED``, default 0), so a given spec + seed + call
sequence reproduces the same fault schedule every run — a chaos failure
in CI replays locally.  ``x max_fires`` bounds total triggers, which is
how chaos tests make faults *stop* (the breaker's half-open probe must
see a healthy device to re-close).

Seams (grep for ``faults.fire`` / ``faults.decide``):

    device.put      engine/device.py     host->device transfer
    device.exec     engine/device.py     sieve kernel execution
    device.fetch    engine/device.py     device->host result fetch
    nfa.dispatch    engine/nfa_device.py verify-stream kernel dispatch
    nfa.fetch       engine/nfa_device.py verify-stream result fetch
    registry.load   registry/store.py    compiled-artifact load
    rpc.recv        rpc/client.py        client response read
    rpc.serve       rpc/server.py        server request handling
    sched.dispatch  serve/scheduler.py   batch dispatch (device boundary
                                         on host-only builds)
    cache.get       cache/tiered.py      tiered result-cache read (per tier)
    cache.put       cache/tiered.py      tiered result-cache write (per tier)
    watch.poll      watch/sources.py     event-source poll (registry tag
                                         list / feed tail)

Kinds: ``error`` (generic InjectedFault), ``oom`` (InjectedOom — its
message carries RESOURCE_EXHAUSTED so the scheduler's shed-and-retry
classifier treats it exactly like a real device OOM), ``corrupt``
(artifact/body corruption), ``reset`` (ConnectionResetError),
``truncate`` (json.JSONDecodeError, i.e. a truncated wire body), and
``latency`` (sleeps TRIVY_TPU_FAULTS_LATENCY_S, default 0.05s, without
raising).

Disabled is the only fast path that matters: with no spec configured the
module-level :data:`_PLANE` is a shared no-op (the memwatch NOOP_HANDLE
pattern — one attribute load + one trivial method call per seam
crossing, zero allocation).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from random import Random

SEAMS = (
    "device.put",
    "device.exec",
    "device.fetch",
    "nfa.dispatch",
    "nfa.fetch",
    "registry.load",
    "rpc.recv",
    "rpc.serve",
    "sched.dispatch",
    "cache.get",
    "cache.put",
    "watch.poll",
)

KINDS = ("error", "oom", "corrupt", "reset", "truncate", "latency")

DEFAULT_LATENCY_S = 0.05


class InjectedFault(RuntimeError):
    """A fault raised by the injection plane (never by real code paths)."""


class InjectedOom(InjectedFault):
    """Injected device OOM.  The message carries RESOURCE_EXHAUSTED so
    string-based classifiers (the scheduler's shed-and-retry path matches
    real XlaRuntimeError text) treat it like the genuine article."""


@dataclass
class FaultRule:
    """One parsed spec entry; ``fired`` counts triggers (mutated under
    the owning plane's lock)."""

    seam: str
    kind: str
    rate: float
    max_fires: int = 0  # 0 = unlimited
    fired: int = 0

    def spec(self) -> str:
        s = f"{self.seam}:{self.kind}@{self.rate:g}"
        if self.max_fires:
            s += f"x{self.max_fires}"
        return s


class _NoopPlane:
    """Shared disabled plane: one predicate on the hot path, no state."""

    __slots__ = ()
    enabled = False

    def decide(self, seam: str) -> None:
        return None

    def snapshot(self) -> dict:
        return {"enabled": False, "rules": [], "fired_total": 0}


NOOP_PLANE = _NoopPlane()


class FaultPlane:
    """An armed plane: rules + one seeded RNG shared across seams."""

    enabled = True

    def __init__(
        self,
        rules: list[FaultRule],
        seed: int = 0,
        latency_s: float = DEFAULT_LATENCY_S,
    ):
        self._lock = threading.Lock()
        self._rules = list(rules)
        self._rng = Random(seed)
        self.seed = seed
        self.latency_s = latency_s

    def decide(self, seam: str) -> str | None:
        """The kind that fires at this crossing of `seam`, or None.  One
        RNG draw per matching probabilistic rule keeps the schedule a
        pure function of (spec, seed, call sequence)."""
        with self._lock:
            for r in self._rules:
                if r.seam != seam:
                    continue
                if r.max_fires and r.fired >= r.max_fires:
                    continue
                if r.rate >= 1.0 or self._rng.random() < r.rate:
                    r.fired += 1
                    return r.kind
        return None

    def snapshot(self) -> dict:
        with self._lock:
            rules = [
                {"spec": r.spec(), "seam": r.seam, "kind": r.kind,
                 "rate": r.rate, "max_fires": r.max_fires, "fired": r.fired}
                for r in self._rules
            ]
        return {
            "enabled": True,
            "seed": self.seed,
            "rules": rules,
            "fired_total": sum(r["fired"] for r in rules),
        }


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse ``seam:kind@rate[xN],...``; unknown seams/kinds and
    out-of-range rates are hard errors (a typo'd chaos profile that
    silently injects nothing is worse than a crash at arm time)."""
    rules: list[FaultRule] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        try:
            seam, _, rest = entry.partition(":")
            kind, _, rate_s = rest.partition("@")
            max_fires = 0
            if "x" in rate_s:
                rate_s, _, max_s = rate_s.partition("x")
                max_fires = int(max_s)
            rate = float(rate_s) if rate_s else 1.0
        except ValueError as e:
            raise ValueError(f"bad fault spec entry {entry!r}: {e}") from e
        if seam not in SEAMS:
            raise ValueError(
                f"unknown fault seam {seam!r} (known: {', '.join(SEAMS)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: {', '.join(KINDS)})"
            )
        if not 0.0 <= rate <= 1.0 or max_fires < 0:
            raise ValueError(f"bad fault rate in {entry!r}")
        rules.append(FaultRule(seam=seam, kind=kind, rate=rate,
                               max_fires=max_fires))
    return rules


# The active plane.  Module-global on purpose (the seams are spread
# across engine/rpc/serve modules and must share one schedule); swapped
# atomically by configure()/clear() — readers take one snapshot load.
_PLANE: _NoopPlane | FaultPlane = NOOP_PLANE


def configure(spec: str, seed: int | None = None) -> None:
    """Arm the plane from a spec string ("" disarms)."""
    global _PLANE
    if not spec.strip():
        _PLANE = NOOP_PLANE
        return
    if seed is None:
        seed = int(os.environ.get("TRIVY_TPU_FAULTS_SEED", "0"))
    latency_s = float(
        os.environ.get("TRIVY_TPU_FAULTS_LATENCY_S", str(DEFAULT_LATENCY_S))
    )
    _PLANE = FaultPlane(parse_spec(spec), seed=seed, latency_s=latency_s)


def clear() -> None:
    """Disarm (tests; idempotent)."""
    global _PLANE
    _PLANE = NOOP_PLANE


def active() -> bool:
    return _PLANE.enabled


def snapshot() -> dict:
    """Debug/readyz view: armed rules and per-rule fire counts."""
    return _PLANE.snapshot()


def decide(seam: str) -> str | None:
    """Non-raising form: the kind that fires here, or None.  For call
    sites that must ACT the fault out themselves (the RPC server
    truncates its own response body) rather than raise."""
    return _PLANE.decide(seam)


def latency_s() -> float:
    """The armed plane's injected-latency duration (for decide() callers
    acting a `latency` kind out themselves)."""
    return getattr(_PLANE, "latency_s", DEFAULT_LATENCY_S)


def fire(seam: str) -> None:
    """The standard seam: decide, then act the fault out — raise for
    error/oom/corrupt/reset/truncate, sleep for latency.  Free when the
    plane is disarmed (shared no-op decide)."""
    plane = _PLANE
    if not plane.enabled:
        return
    kind = plane.decide(seam)
    if kind is None:
        return
    if kind == "latency":
        time.sleep(plane.latency_s)  # type: ignore[union-attr]
        return
    raise make_fault(seam, kind)


def make_fault(seam: str, kind: str) -> Exception:
    """The exception a (seam, kind) trigger raises — shaped like the real
    failure class so downstream handlers can't special-case injection."""
    if kind == "oom":
        return InjectedOom(
            f"RESOURCE_EXHAUSTED: injected device OOM (seam={seam})"
        )
    if kind == "reset":
        return ConnectionResetError(
            f"injected connection reset (seam={seam})"
        )
    if kind == "truncate":
        return json.JSONDecodeError(
            f"injected truncated body (seam={seam})", "", 0
        )
    if kind == "corrupt":
        return InjectedFault(f"injected corruption (seam={seam})")
    return InjectedFault(f"injected fault (seam={seam})")


def is_oom(e: BaseException) -> bool:
    """Device-memory-exhaustion classifier shared by the scheduler's
    shed-and-retry path: matches real XLA RESOURCE_EXHAUSTED errors (the
    status name travels in the message text) and injected OOMs alike."""
    return "RESOURCE_EXHAUSTED" in str(e) or isinstance(e, MemoryError)


# Arm from the environment at import: the chaos-smoke profiles set
# TRIVY_TPU_FAULTS before the process starts, and every module that hosts
# a seam imports this one.
configure(os.environ.get("TRIVY_TPU_FAULTS", ""))
