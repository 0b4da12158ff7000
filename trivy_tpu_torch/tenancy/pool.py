"""ResidentRulesetPool: LRU of compiled-ruleset engines, one per digest.

Multi-model serving, reshaped for rulesets: a compiled ruleset is device
state (NFA transition tensors, gram constants, pre-lowered step kernels),
so "which rulesets can we serve right now" is a *residency* question.  The
pool keeps up to `max_resident` engines (optionally bounded by estimated
device bytes) keyed by ruleset digest, evicting least-recently-used slots
when a new digest is admitted.

Each slot owns its own `RulesetManager` — the registry's epoch-swap machinery,
per ruleset.  Request threads build engines (via the injected loader, which
rides the registry's warm path) and *stage* them; only the scheduler's
engine-owner thread installs, at a batch boundary, via
`engine_for_dispatch`.  In-flight batches therefore always finish on the
engine they started with, and eviction is safe mid-batch: dropping a slot
only drops the pool's reference, while the dispatching batch keeps its own
until demux completes.

Lock discipline (the "pool eviction vs. scheduler dispatch" ABBA trap):
`_lock` guards only the slot table and counters.  The loader — which takes
engine-construction locks (link probe, registry manager) — always runs
*outside* `_lock`, and manager methods are never called under it.  The
scheduler never holds its own lock while calling into the pool, so the
order graph gains no edge in either direction.  The one lock taken under
`_lock` is obs/memwatch's ledger lock (a leaf: memwatch never calls out
while holding it), for measured-byte accounting.

Byte accounting: each slot's `nbytes` is the loader's manifest
*estimate*; `_slot_cost` prefers memwatch-*measured* bytes for the digest
when engine-level registrations exist, so both the `--max-resident-mb`
budget and the HBM soft-watermark eviction act on real usage.  The
estimate error is exported as
`trivy_tpu_pool_bytes_estimate_error_ratio`.

Copied from `trivy_tpu/tenancy/pool.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.obs import memwatch
from trivy_tpu_torch.registry.manager import RulesetManager


class UnknownRulesetError(RuntimeError):
    """The requested digest has no source in the server's registry (the
    client must `rules push` it first).  Deterministic: HTTP 404-class,
    never retried."""


def slot_key(digest: str, program: str = "secret") -> str:
    """Pool-slot identity for (program table, ruleset digest).

    The secret program keeps the bare digest — every existing loader,
    metric label, and memwatch attribution line stays byte-identical.
    Other program lanes prefix `<program>+` so one tenant's secret engine
    and its multi-program engine over the SAME ruleset digest occupy
    distinct slots (different merged rule axes, different device bytes).
    """
    if program == "secret":
        return digest
    return f"{program}+{digest}"


def split_slot_key(key: str) -> tuple[str, str]:
    """Inverse of slot_key: (program, digest).  Digests are hex/`sha256:`
    strings, so the first "+" is unambiguous."""
    if "+" in key:
        program, digest = key.split("+", 1)
        return program, digest
    return "secret", key


@dataclass
class PoolStats:
    """Monotonic counters (mutated under the pool lock; read freely)."""

    hits: int = 0  # ensure() found the digest resident
    misses: int = 0  # ensure() had to build/wait for a build
    admits: int = 0  # slots installed (first admit + re-admits)
    evictions: int = 0  # LRU slots dropped for budget
    warm_admits: int = 0  # admits satisfied by the registry warm path
    cold_admits: int = 0  # admits that compiled fresh
    owner_loads: int = 0  # dispatch-time re-admits after eviction


class _Slot:
    __slots__ = ("digest", "manager", "nbytes", "mw")

    def __init__(self, digest: str, manager: RulesetManager, nbytes: int,
                 mw=memwatch.NOOP_HANDLE):
        self.digest = digest
        self.manager = manager
        self.nbytes = nbytes  # manifest ESTIMATE from the loader
        self.mw = mw  # memwatch registration carrying the slot's bytes


class ResidentRulesetPool:
    """LRU of per-digest engines behind a loader callback.

    `loader(digest) -> (engine, nbytes, source)` rebuilds an engine for a
    registered digest ("warm"/"cold" says whether the registry's compiled
    artifact was reused) or raises UnknownRulesetError.  It is called on
    request threads (admission) and, rarely, on the engine-owner thread
    when a digest was evicted between admission and dispatch.
    """

    def __init__(
        self,
        loader,
        max_resident: int = 4,
        max_resident_bytes: int = 0,
        registry=None,
    ):
        self._loader = loader
        self.max_resident = max(1, int(max_resident))
        self.max_resident_bytes = max(0, int(max_resident_bytes))
        self._lock = lockcheck.make_lock("tenancy.pool")
        self._slots: OrderedDict[str, _Slot] = OrderedDict()  # owner: _lock
        # One in-flight build per digest: concurrent requesters for a
        # non-resident digest share a Future instead of racing the loader.
        self._building: dict[str, Future] = {}  # owner: _lock
        self.stats = PoolStats()  # counters; mutated under _lock
        if registry is not None:
            self._register_metrics(registry)

    # -- admission (request threads) --------------------------------------

    def ensure(
        self,
        digest: str,
        timeout_s: float = 300.0,
        program: str = "secret",
    ) -> None:
        """Make `digest` resident (or raise UnknownRulesetError).  The
        expensive build runs outside the pool lock; concurrent callers for
        the same digest block on the builder's Future.  `program` selects
        the program-table lane (slot_key): non-secret lanes reach the
        loader with the composite key — split_slot_key recovers the pair.
        """
        digest = slot_key(digest, program)
        with self._lock:
            slot = self._slots.get(digest)
            if slot is not None:
                self._slots.move_to_end(digest)
                self.stats.hits += 1
                return
            self.stats.misses += 1
            fut = self._building.get(digest)
            if fut is None:
                fut = Future()
                self._building[digest] = fut
                builder = True
            else:
                builder = False
        if not builder:
            fut.result(timeout=timeout_s)  # re-raises the builder's error
            return
        try:
            # Digest scope: device allocations the build registers with
            # memwatch (compiled NFA tensors, caches) carry this digest,
            # which is where _slot_cost's measured bytes come from.
            with memwatch.ruleset_digest(digest):
                engine, nbytes, source = self._loader(digest)
            self._admit(digest, engine, nbytes, source)
        except BaseException as e:
            with self._lock:
                self._building.pop(digest, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._building.pop(digest, None)
        fut.set_result(None)

    def _admit(self, digest: str, engine, nbytes: int, source: str) -> None:
        """Install a freshly-built engine as a slot, evicting LRU slots
        over budget.  The slot's manager stages the engine; the owner
        thread installs it (epoch bump) at its first dispatch."""
        manager = RulesetManager(lambda: engine)
        manager.stage(engine, digest)
        # The slot's own ledger entry carries the manifest estimate; once
        # engine-level registrations measure this digest for real,
        # _slot_cost zeroes it so attribution never double-counts.
        mw = memwatch.track(
            "ruleset-pool", int(nbytes), digest=digest, owner=manager
        )
        with self._lock:
            old = self._slots.pop(digest, None)
            self._slots[digest] = _Slot(digest, manager, int(nbytes), mw)
            self._slots.move_to_end(digest)
            self.stats.admits += 1
            if source == "warm":
                self.stats.warm_admits += 1
            else:
                self.stats.cold_admits += 1
            self._evict_over_budget_locked()
        if old is not None:
            old.mw.release()

    def _slot_cost(self, s: _Slot) -> int:
        """Bytes a slot is charged against budgets: memwatch-MEASURED
        bytes for the digest when engine-level registrations exist (the
        slot's own "ruleset-pool" estimate entry is zeroed so attribution
        never double-counts), the manifest estimate otherwise."""
        measured = memwatch.bytes_for_digest(
            s.digest, exclude=("ruleset-pool",)
        )
        if measured > 0:
            if s.mw.nbytes:
                s.mw.resize(0)
            return measured
        if s.mw.nbytes != s.nbytes:
            s.mw.resize(s.nbytes)
        return s.nbytes

    def _evict_over_budget_locked(self) -> None:  # graftlint: holds(_lock)
        # Never evict down past the newest slot: a single ruleset larger
        # than max_resident_bytes still serves (degraded to pool-of-one).
        # The byte budget holds against measured-preferring _slot_cost.
        while len(self._slots) > 1 and (
            len(self._slots) > self.max_resident
            or (
                self.max_resident_bytes
                and sum(self._slot_cost(s) for s in self._slots.values())
                > self.max_resident_bytes
            )
        ):
            _, s = self._slots.popitem(last=False)
            self.stats.evictions += 1
            s.mw.release()

    def evict_to_bytes(self, target_bytes: int) -> tuple[int, int]:
        """HBM soft-watermark actuator: drop LRU slots (never the newest)
        until accounted bytes fit under `target_bytes`; returns
        (evicted_slots, freed_bytes).  Costs are measured-preferring via
        _slot_cost, so the pressure loop acts on real usage — the freed
        engine's own ledger entries release when its last batch reference
        drops (memwatch owner finalizers)."""
        freed = 0
        evicted = 0
        with self._lock:
            while len(self._slots) > 1 and (
                sum(self._slot_cost(s) for s in self._slots.values())
                > max(0, int(target_bytes))
            ):
                _, s = self._slots.popitem(last=False)
                freed += self._slot_cost(s)
                evicted += 1
                self.stats.evictions += 1
                s.mw.release()
        return evicted, freed

    # -- dispatch (engine-owner thread) -----------------------------------

    def engine_for_dispatch(
        self, digest: str, program: str = "secret"
    ) -> tuple[object, str, int]:
        """Resolve (engine, digest, epoch) for a batch.  Installs anything
        the slot's manager has staged — this IS the batch boundary.  If the
        digest was evicted after admission (budget pressure from other
        tenants), re-admit it here via the loader's warm path.  `program`
        selects the slot lane exactly as in ensure()."""
        digest = slot_key(digest, program)
        with self._lock:
            slot = self._slots.get(digest)
            if slot is not None:
                self._slots.move_to_end(digest)
        if slot is None:
            with memwatch.ruleset_digest(digest):
                engine, nbytes, source = self._loader(digest)
            self._admit(digest, engine, nbytes, source)
            with self._lock:
                slot = self._slots[digest]
                self.stats.owner_loads += 1
        engine, dig = slot.manager.engine()
        return engine, dig, slot.manager.epoch

    # -- observability (any thread) ---------------------------------------

    def residents(self) -> list[tuple[str, int, int]]:
        """(digest, epoch, nbytes) per resident slot, LRU-first.  Manager
        locks are taken after the pool lock is released (no nesting)."""
        with self._lock:
            slots = list(self._slots.values())
        return [(s.digest, s.manager.epoch, s.nbytes) for s in slots]

    def resident_count(self) -> int:
        with self._lock:
            return len(self._slots)

    def resident_bytes(self) -> int:
        """Manifest-estimate bytes over resident slots (the historical
        surface; budgets use accounted_bytes)."""
        with self._lock:
            return sum(s.nbytes for s in self._slots.values())

    def accounted_bytes(self) -> int:
        """Budget-relevant resident bytes: memwatch-measured per digest
        when available, manifest estimate otherwise."""
        with self._lock:
            return sum(self._slot_cost(s) for s in self._slots.values())

    def estimate_reconciliation(self) -> tuple[int, int]:
        """(estimate_sum, measured_sum) over resident slots whose digest
        has memwatch-measured bytes; (0, 0) when nothing is measured.
        Feeds trivy_tpu_pool_bytes_estimate_error_ratio."""
        with self._lock:
            slots = list(self._slots.values())
        est = meas = 0
        for s in slots:
            m = memwatch.bytes_for_digest(
                s.digest, exclude=("ruleset-pool",)
            )
            if m > 0:
                est += s.nbytes
                meas += m
        return est, meas

    def _register_metrics(self, registry) -> None:
        self._m_resident = registry.gauge(
            "trivy_tpu_tenancy_resident_rulesets",
            "compiled rulesets currently device-resident in the pool",
        )
        self._m_resident_bytes = registry.gauge(
            "trivy_tpu_tenancy_resident_bytes",
            "estimated device bytes held by resident ruleset slots",
        )
        self._m_hits = registry.counter(
            "trivy_tpu_tenancy_pool_hits_total",
            "admissions that found their ruleset already resident",
        )
        self._m_misses = registry.counter(
            "trivy_tpu_tenancy_pool_misses_total",
            "admissions that had to build or wait for a build",
        )
        self._m_admits = registry.counter(
            "trivy_tpu_tenancy_pool_admits_total",
            "ruleset slots installed, by registry source",
            labelnames=("source",),
        )
        for source in ("warm", "cold"):
            self._m_admits.labels(source=source)
        self._m_evictions = registry.counter(
            "trivy_tpu_tenancy_pool_evictions_total",
            "LRU slots dropped to stay under the residency budget",
        )
        # Live occupancy under the pool_* prefix the capacity dashboards
        # key on (the tenancy_* pair above predates the naming split and
        # stays for compatibility).
        self._m_slots_used = registry.gauge(
            "trivy_tpu_pool_slots_used",
            "resident-ruleset slots currently occupied",
        )
        self._m_pool_bytes = registry.gauge(
            "trivy_tpu_pool_resident_bytes",
            "estimated device bytes pinned by occupied pool slots",
        )
        self._m_est_err = registry.gauge(
            "trivy_tpu_pool_bytes_estimate_error_ratio",
            "(measured - estimate) / estimate over resident slots with "
            "memwatch-measured bytes (0 = estimates exact or unmeasured)",
        )
        registry.add_collect_hook(self._collect)

    def _collect(self) -> None:
        """Scrape-time mirror of pool state; reads counters without the
        lock (ints, monotonic — a torn read is a stale sample at worst)."""
        self._m_resident.set(self.resident_count())
        self._m_resident_bytes.set(self.resident_bytes())
        # Floor-clamped like the server's inflight gauge: a scrape racing
        # teardown must never expose a negative occupancy sample.
        self._m_slots_used.set(max(0, self.resident_count()))
        self._m_pool_bytes.set(max(0, self.resident_bytes()))
        self._m_hits.set_total(self.stats.hits)
        self._m_misses.set_total(self.stats.misses)
        self._m_admits.labels(source="warm").set_total(self.stats.warm_admits)
        self._m_admits.labels(source="cold").set_total(self.stats.cold_admits)
        self._m_evictions.set_total(self.stats.evictions)
        est, meas = self.estimate_reconciliation()
        self._m_est_err.set((meas - est) / est if est > 0 else 0.0)
