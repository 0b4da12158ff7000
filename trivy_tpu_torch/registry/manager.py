"""RulesetManager: epoch-versioned active/staged engine pair for serve.

Zero-downtime rule updates ride the scheduler's ownership model: exactly one
engine-owner thread ever RUNS an engine, so a swap only needs to happen
between two `_dispatch` calls — a batch boundary.  Any thread (an admin
handler, a SIGHUP thread) may build a replacement engine and `stage()` it;
the owner thread picks it up at the next `engine()` call.  In-flight tickets
therefore always finish on the engine that started them, and every batch is
attributed to exactly one (digest, epoch) pair.

The expensive part — compiling or warm-loading the new ruleset — happens on
the staging thread, never the owner thread: the batcher keeps dispatching on
the old engine while the replacement builds.

Copied from `trivy_tpu/registry/manager.py` (the port imports nothing from
the JAX package).  An engine built on one thread and run on another needs
no synchronization in torch: no thread sets a stream of its own while it
builds, so the build's device work (table uploads, warmup launches) and
the owner thread's launches all go to the device's default stream, in
order.  The one side stream, the chunk pipeline's row stager, carries
only a scan's row copies, and the scan's launches wait on each copy's
event (`engine/pipeline.py` `wait_staged`).  The same holds for the
engines the tenancy pool builds on request threads.
"""

from __future__ import annotations

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.registry.digest import engine_digest


class RulesetManager:
    def __init__(self, engine_factory):
        self._factory = engine_factory
        self._lock = lockcheck.make_lock("registry.manager")
        # engine() binds this role to its first calling thread; under
        # TRIVY_TPU_LOCKCHECK=1 a second thread calling engine() on the
        # same manager raises (the "only the owner thread swaps epochs"
        # contract, enforced instead of commented).
        self._owner = lockcheck.owner_role("ruleset.manager.owner")
        self._active = None  # owner: engine-owner
        self._active_digest = ""  # owner: _lock
        self._staged: tuple[object, str] | None = None  # owner: _lock
        # bumps on every install, including the first
        self._epoch = 0  # owner: _lock
        # installs that REPLACED a live engine
        self._reloads = 0  # owner: _lock

    # -- staging (any thread) -------------------------------------------

    def build_staged(self, factory=None) -> str:
        """Build a replacement engine ON THE CALLING THREAD and stage it
        for the owner thread's next batch boundary; returns its digest.
        A second stage before the swap simply wins (last writer)."""
        engine = (factory or self._factory)()
        digest = engine_digest(engine)
        with self._lock:
            self._staged = (engine, digest)
        return digest

    def stage(self, engine, digest: str = "") -> str:
        """Stage an already-built engine (tests, pre-warmed artifacts)."""
        digest = digest or engine_digest(engine)
        with self._lock:
            self._staged = (engine, digest)
        return digest

    # -- the owner thread -----------------------------------------------

    def engine(self) -> tuple[object, str]:  # graftlint: owner(engine-owner)
        """Called by the engine-owner thread at each batch boundary: swap
        in anything staged, lazily build the first engine, and return
        (engine, digest) for this batch.  Only this method ever installs,
        so the active engine never changes mid-batch."""
        self._owner.assert_here()
        with self._lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            if self._active is not None:
                with self._lock:
                    self._reloads += 1
            self._install(*staged)
        if self._active is None:
            engine = self._factory()
            self._install(engine, engine_digest(engine))
        return self._active, self._active_digest

    def _install(self, engine, digest: str) -> None:  # graftlint: owner(engine-owner)
        self._active = engine
        with self._lock:
            self._active_digest = digest
            self._epoch += 1

    # -- observability (any thread) -------------------------------------

    @property
    def active(self):
        """The currently installed engine, or None before the first batch.
        Never builds (unlike `engine()`): metrics scrapes must not trigger
        a lazy compile on the HTTP thread."""
        return self._active

    @property
    def active_digest(self) -> str:
        with self._lock:
            return self._active_digest

    @property
    def staged_digest(self) -> str:
        """The digest staged for the next batch boundary ("" when none)."""
        with self._lock:
            return self._staged[1] if self._staged is not None else ""

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def reloads(self) -> int:
        with self._lock:
            return self._reloads
