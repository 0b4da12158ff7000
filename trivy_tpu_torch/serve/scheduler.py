"""Continuous cross-request batching scheduler (the Orca/vLLM serving shape).

The thread-per-request server sizes device batches by whatever one client
sent: a request with three files runs a three-file `scan_batch` while the
engine idles between requests.  This module inverts the ownership — ONE
engine-owner thread owns the secret engines, and concurrent requests enqueue
their (path, blob) items as tickets into a bounded admission queue.  The
owner thread coalesces tickets into device batches under a fill-or-timeout
window (the first ticket opens the window; the batch dispatches when either
`max_batch_bytes` fills or `batch_window_ms` elapses), feeds the combined
item list through the existing `HybridSecretEngine.scan_batch` /
`ChunkPipeline` path, and demultiplexes per-item results back onto
per-ticket futures.  Findings are byte-identical to the unbatched path:
`scan_batch` results are per-item and batch-composition-independent (the
chunk/dedupe parity the engine tests pin down).

Multi-tenancy keys the queue by RULESET DIGEST: each digest gets its own
lane (deque + fill window), so same-digest tickets from *different* clients
coalesce into shared device batches while different-digest tickets never
mix (a batch runs on exactly one engine).  The default lane ("") is the
server's configured ruleset, backed by the scheduler's own RulesetManager;
digest lanes resolve their engine through the ResidentRulesetPool
(trivy_tpu/tenancy/), whose per-slot managers reuse the same epoch-swap
machinery.  Dispatch picks among ready lanes by smooth weighted
round-robin, so a hot tenant saturating its lane cannot starve the rest —
starvation is bounded by the number of active lanes, not by traffic share.

Admission control is where backpressure lives, not in the engine:

  - per-tenant token buckets    -> QuotaExceededError    (HTTP 429)
  - bounded queue depth         -> QueueFullError        (HTTP 429)
  - per-client in-flight caps   -> ClientOverloadedError (HTTP 429)
  - draining/closed             -> SchedulerClosedError  (HTTP 503)
  - card engine, breaker open   -> BreakerOpenError      (HTTP 503)

Quota rejections carry the bucket's exact refill time as Retry-After;
tenant quotas (requests/s, bytes/s, inflight) come from the TenantAdmission
controller and can be overridden per tenant.  Tickets carry their request's
absolute deadline: tickets that expire while queued are cancelled before
dispatch (their future raises ScanTimeoutError), and a dispatching batch
arms the engine-owner thread's deadline (trivy_tpu/deadline.py) to the
LATEST ticket deadline — if that fires mid-batch, every ticket's deadline
has already passed, so failing the whole batch is sound.

Graceful drain: `drain()` stops admission (new submits raise
SchedulerClosedError) and lets the owner thread finish everything already
queued; `close()` additionally aborts anything still stuck so no waiter
hangs on a wedged engine.

Copied from `trivy_tpu/serve/scheduler.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
One change of behaviour: for an engine on a CUDA device the failure-domain
ladder keeps only its device rungs — no batch of a card engine is moved to
the host path, and while the breaker is open such batches are shed with
503 (`BreakerOpenError`).  CPU engines keep the reference's host rung.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass

from trivy_tpu_torch import deadline as _deadline
from trivy_tpu_torch import faults, lockcheck
from trivy_tpu_torch.cache.results import content_digest
from trivy_tpu_torch.deadline import ScanTimeoutError
from trivy_tpu_torch.engine.breaker import CircuitBreaker
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.obs import gatelog, memwatch
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.obs.tenantmetrics import TenantMetrics
from trivy_tpu_torch.registry.manager import RulesetManager
from trivy_tpu_torch.tenancy.pool import ResidentRulesetPool, UnknownRulesetError
from trivy_tpu_torch.tenancy.qos import TenantAdmission, TenantQuota


class SecretBatch(list):
    """A ticket's result list, tagged with the (digest, epoch) of the
    engine that scanned it.  A list subclass so every existing consumer —
    slicing, equality, `[s for s in secrets]` — is untouched; the serve
    layer reads the attribution off the side."""

    ruleset_digest: str = ""
    ruleset_epoch: int = 0
    # Per-phase timing breakdown, attached only when the ticket asked for
    # it (X-Trivy-Explain); None costs nothing on the common path.
    explain: dict | None = None


class AdmissionError(RuntimeError):
    """Base for admission rejections; carries the Retry-After hint."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QueueFullError(AdmissionError):
    """Admission queue at max_queue_depth (HTTP 429)."""


class ClientOverloadedError(AdmissionError):
    """Client at its in-flight ticket cap (HTTP 429)."""


class QuotaExceededError(AdmissionError):
    """Tenant over its token-bucket quota (HTTP 429); Retry-After is the
    bucket's exact refill time, not a fixed hint."""


class SchedulerClosedError(AdmissionError):
    """Scheduler draining or shut down (HTTP 503)."""


class HbmPressureError(AdmissionError):
    """Device memory above the hard watermark — new admissions shed with
    429 + Retry-After until pressure recedes (obs/memwatch.py)."""


class BreakerOpenError(AdmissionError):
    """The device breaker is open over an engine on a card: the batch is
    shed with 503 + Retry-After (the breaker's cooldown), never moved to
    the host, until a half-open probe re-closes the breaker."""


def _on_card(engine) -> bool:
    """Does the engine run on a CUDA device?  Such an engine's ladder
    keeps only its device rungs: a card's work never falls back to the
    host path."""
    return getattr(getattr(engine, "device", None), "type", None) == "cuda"


@dataclass
class ServeConfig:
    """Knobs, CLI-exposed as `server --batch-window-ms` etc. (env vars
    TRIVY_TPU_BATCH_WINDOW_MS and friends via the cli env binding)."""

    batch_window_ms: float = 4.0  # fill-or-timeout window (per lane)
    max_batch_bytes: int = 8 << 20  # dispatch early once this fills
    max_queue_depth: int = 256  # tickets across all lanes; beyond -> 429
    max_inflight_per_client: int = 8  # queued+dispatching per client
    retry_after_s: float = 1.0  # backpressure hint on 429/503
    # -- tenancy (trivy_tpu/tenancy/) ------------------------------------
    max_resident_rulesets: int = 4  # compiled-engine LRU slots
    max_resident_bytes: int = 0  # estimated device bytes cap (0 = off)
    tenant_rps: float = 0.0  # default per-tenant requests/s (0 = off)
    tenant_burst: float = 0.0  # request bucket depth (0 = max(rps, 1))
    tenant_bytes_per_s: float = 0.0  # default per-tenant bytes/s (0 = off)
    tenant_bytes_burst: float = 0.0  # byte bucket depth (0 = 1s of rate)
    # -- per-tenant observability (obs/tenantmetrics.py) -----------------
    max_tenant_series: int = 16  # top-K tenants with own metric series
    # -- device-memory watermarks (obs/memwatch.py), % of bytes_limit ----
    hbm_soft_pct: float = 85.0  # soft: LRU-evict pool toward target (0=off)
    hbm_hard_pct: float = 95.0  # hard: shed new admissions with 429 (0=off)
    # -- device circuit breaker (engine/breaker.py) ----------------------
    breaker_threshold: int = 3  # device failures in window before opening
    breaker_window_s: float = 30.0  # failure-counting sliding window
    breaker_cooldown_s: float = 5.0  # open -> half-open probe timer

    def default_quota(self) -> TenantQuota:
        return TenantQuota(
            rps=self.tenant_rps,
            burst=self.tenant_burst,
            bytes_per_s=self.tenant_bytes_per_s,
            bytes_burst=self.tenant_bytes_burst,
        )


# SieveStats seconds accumulators diffed per batch into the
# serve_batch_phase_seconds histogram (label = attr minus the "_s").
_PHASE_ATTRS = (
    "pack_s", "encode_s", "sieve_s", "candidate_s", "verify_s", "confirm_s",
)


@dataclass
class Ticket:
    """One request's admission into the batcher."""

    items: list  # [(path, bytes)]
    client_id: str
    deadline_at: float | None  # absolute time.monotonic(), None = unbounded
    future: Future
    nbytes: int
    enqueued_at: float
    trace_id: str = ""  # X-Trivy-Trace-Id from the request, "" = untraced
    ruleset_digest: str = ""  # lane key; "" = the default ruleset
    explain: bool = False  # attach the per-phase breakdown to the result
    # Result-cache partial hit: original index -> cached Secret.  When
    # set, `items` holds only the misses and `total_items` the original
    # request length; demux re-interleaves positionally at dispatch.
    cache_hits: dict | None = None
    total_items: int = 0  # 0 = len(items) (no cache probe ran)


class _Lane:
    """One ruleset digest's admission queue + fill window + WRR state.
    All fields are owned by the scheduler lock (the lane is an interior
    struct, never handed out)."""

    __slots__ = ("digest", "q", "nbytes", "opened_at", "weight",
                 "current_weight")

    def __init__(self, digest: str, weight: float = 1.0):
        self.digest = digest
        self.q: deque[Ticket] = deque()
        self.nbytes = 0  # queued payload bytes
        self.opened_at = 0.0  # window start: first enqueue into empty lane
        self.weight = weight
        self.current_weight = 0.0  # smooth-WRR accumulator


@dataclass
class SchedulerStats:
    """Counters the /metrics endpoint exposes (all monotonic except the
    live gauges read off the scheduler itself)."""

    admitted: int = 0
    rejected_full: int = 0
    rejected_client: int = 0
    rejected_closed: int = 0
    rejected_quota: int = 0  # tenant token bucket said no
    rejected_hbm: int = 0  # device memory above the hard watermark
    hbm_evicted_slots: int = 0  # pool slots shed by soft-pressure eviction
    hbm_transitions: int = 0  # ok/soft/hard state changes observed
    expired: int = 0  # cancelled before dispatch
    batches: int = 0
    multi_request_batches: int = 0  # batches coalescing >= 2 tickets
    cross_tenant_batches: int = 0  # batches coalescing >= 2 distinct clients
    coalesced_requests: int = 0  # sum of tickets per batch
    items: int = 0
    bytes: int = 0
    fill_ratio_sum: float = 0.0  # sum over batches of bytes/max_batch_bytes
    wait_s_sum: float = 0.0  # enqueue -> dispatch, summed over tickets
    errors: int = 0  # batches failed by an engine exception
    breaker_rejected: int = 0  # card batches shed with 503 while the breaker is open
    degraded_batches: int = 0  # re-run byte-identical on a lower rung
    shed_retries: int = 0  # RESOURCE_EXHAUSTED evict-split-retry cycles
    shed_evicted_slots: int = 0  # pool slots shed by OOM recovery
    cache_hits: int = 0  # items served from the result cache
    cache_misses: int = 0  # items that had to ride a device batch
    cache_resolved: int = 0  # requests resolved wholly from cache (no ticket)


class BatchScheduler:
    """Single engine-owner thread + per-digest admission lanes.

    `engine_factory` is called lazily on the owner thread at first dispatch
    (building a HybridSecretEngine measures the device link — server startup
    and non-secret traffic must not pay that).  Engines only ever run on
    the owner thread, so engines need no internal locking.

    `ruleset_loader` (optional) enables per-request ruleset selection: a
    `loader(digest) -> (engine, nbytes, source)` callback backing a
    ResidentRulesetPool.  Without it, submits carrying a digest are
    rejected with UnknownRulesetError.
    """

    def __init__(
        self,
        engine_factory,
        config: ServeConfig | None = None,
        registry: obs_metrics.Registry | None = None,
        ruleset_loader=None,
        result_cache=None,
    ):
        self.config = config or ServeConfig()
        self._engine_factory = engine_factory
        # Fleet result cache (cache/results.py): per-blob verdicts keyed
        # by (content digest, ruleset digest, schema).  Submit probes it
        # before ticketing — full hits demux straight to futures with
        # zero device dispatches, partial hits ride the batch with only
        # their misses.  None = caching off (the seed behavior).
        self.result_cache = result_cache
        # The manager owns the DEFAULT lane's active/staged engine pair;
        # only _dispatch (owner thread) installs, so swaps land exactly at
        # batch boundaries and in-flight batches finish on the engine they
        # started with.  Digest lanes get the same machinery per pool slot.
        self.manager = RulesetManager(engine_factory)
        self._lock = lockcheck.make_lock("serve.scheduler")
        self._not_empty = lockcheck.make_condition(self._lock)
        # The engine-owner role: only _dispatch (the serve-batcher thread)
        # runs engines; under TRIVY_TPU_LOCKCHECK=1 this is asserted live.
        self._owner = lockcheck.owner_role("serve.batcher")
        # digest -> lane; "" (always present) is the default ruleset.
        self._lanes: dict[str, _Lane] = {"": _Lane("")}  # owner: _lock
        self._inflight: dict[str, int] = {}  # owner: _lock
        self._admitting = True  # owner: _lock
        self._thread: threading.Thread | None = None  # owner: _lock
        # SchedulerStats stays the programmatic surface (bench.py and the
        # serve tests read it); the registry is the exposition surface.
        # Both are written at event time — dual-write, one source of truth
        # per consumer.
        self.stats = SchedulerStats()
        self.registry = registry if registry is not None else obs_metrics.Registry()
        # Tenancy: QoS always on (zero rates = admit everything, so the
        # controller costs one lock + two dict probes per submit); the
        # resident pool only with a loader.
        self.qos = TenantAdmission(default=self.config.default_quota())
        self.pool: ResidentRulesetPool | None = (
            ResidentRulesetPool(
                ruleset_loader,
                max_resident=self.config.max_resident_rulesets,
                max_resident_bytes=self.config.max_resident_bytes,
                registry=self.registry,
            )
            if ruleset_loader is not None
            else None
        )
        # Tenant/digest-labelled families behind the cardinality governor
        # (obs/tenantmetrics.py): always on — the governor is O(1) per
        # event and K=0 degrades to the "_other" rollup only.
        self.tenant_metrics = TenantMetrics(
            self.registry, max_tenant_series=self.config.max_tenant_series
        )
        # Breach incident capture (obs/flight.py): the server attaches its
        # recorder so deadline expiries captured here land in the same ring
        # as RPC-side breaches.  None = recording off (standalone use).
        self.flight = None
        # Fleet posture callable (trivy_tpu/fleet/ FleetSelf.brief): the
        # server attaches it on fleeted hosts so snapshot() states which
        # member this scheduler serves as.  None = unfleeted.
        self.fleet = None
        # HBM pressure state machine (ok/soft/hard), advanced by submit-
        # side watermark checks against memwatch.pressure().  owner: _lock
        self._hbm_state = "ok"
        # Latest program-table attribution (engine.programs_snapshot at a
        # batch boundary); None until a multi-program engine dispatches.
        # Written on the owner thread, read by snapshot()/debug surfaces.
        self._last_programs = None
        # Where batches go while the breaker is open, for its audit trail:
        # "dfa" (a CPU engine's host rung) or "shed" (a card engine's 503).
        # Written on the owner thread at each dispatch.
        self._off_device = "dfa"
        # Device circuit breaker: repeated device-engine failures flip
        # batch routing off the device (the host DFA path for a CPU
        # engine, a 503 shed for a card engine) until a timed probe
        # proves the device healthy again.  Transitions are audited through the
        # gate decision log (reason "breaker") and promoted into the
        # flight ring — the same trail a construction-time gate decision
        # leaves.  All record_*/allow calls run on the owner thread.
        self.breaker = CircuitBreaker(
            failure_threshold=self.config.breaker_threshold,
            window_s=self.config.breaker_window_s,
            cooldown_s=self.config.breaker_cooldown_s,
            on_transition=self._on_breaker_transition,
        )
        self._register_metrics()

    def _register_metrics(self) -> None:
        r = self.registry
        self._m_queue_depth = r.gauge(
            "trivy_tpu_serve_queue_depth",
            "tickets waiting for dispatch (all lanes)",
        )
        self._m_lanes = r.gauge(
            "trivy_tpu_serve_lanes",
            "digest lanes known to the scheduler (1 = default only)",
        )
        self._m_inflight = r.gauge(
            "trivy_tpu_serve_inflight_tickets",
            "tickets admitted and unresolved",
        )
        self._m_tickets = r.counter(
            "trivy_tpu_serve_tickets_total", "admitted tickets"
        )
        self._m_rejected = r.counter(
            "trivy_tpu_serve_rejected_total",
            "admission rejections by reason",
            labelnames=("reason",),
        )
        # Pre-create the reason children so every rejection lane scrapes
        # as 0 before its first event (dashboards alert on rate(), which
        # needs the series to exist).
        for reason in ("queue_full", "client_cap", "closed", "quota", "hbm"):
            self._m_rejected.labels(reason=reason)
        self._m_expired = r.counter(
            "trivy_tpu_serve_expired_total",
            "tickets cancelled at their deadline before dispatch",
        )
        self._m_cache_items = r.counter(
            "trivy_tpu_serve_cache_items_total",
            "result-cache probe outcomes for submitted items",
            labelnames=("outcome",),
        )
        for outcome in ("hit", "miss"):
            self._m_cache_items.labels(outcome=outcome)
        self._m_cache_resolved = r.counter(
            "trivy_tpu_serve_cache_resolved_total",
            "requests resolved wholly from the result cache (no batch)",
        )
        self._m_batches = r.counter(
            "trivy_tpu_serve_batches_total", "dispatched device batches"
        )
        self._m_multi = r.counter(
            "trivy_tpu_serve_multi_request_batches_total",
            "batches coalescing two or more requests",
        )
        self._m_cross_tenant = r.counter(
            "trivy_tpu_serve_cross_tenant_batches_total",
            "batches coalescing two or more distinct clients",
        )
        self._m_coalesced = r.counter(
            "trivy_tpu_serve_coalesced_requests_total",
            "requests summed over dispatched batches",
        )
        self._m_items = r.counter(
            "trivy_tpu_serve_batch_items_total",
            "items summed over dispatched batches",
        )
        self._m_bytes_total = r.counter(
            "trivy_tpu_serve_batch_bytes_total",
            "payload bytes summed over dispatched batches",
        )
        self._m_fill = r.histogram(
            "trivy_tpu_serve_batch_fill_ratio",
            "per-batch bytes/max_batch_bytes at dispatch",
            buckets=obs_metrics.RATIO_BUCKETS,
        )
        self._m_wait = r.histogram(
            "trivy_tpu_serve_ticket_wait_seconds",
            "enqueue-to-dispatch wait per ticket",
        )
        self._m_batch_bytes = r.histogram(
            "trivy_tpu_serve_batch_bytes",
            "payload bytes per dispatched batch",
            buckets=obs_metrics.BYTES_BUCKETS,
        )
        self._m_phase = r.histogram(
            "trivy_tpu_serve_batch_phase_seconds",
            "engine seconds per batch by pipeline phase",
            labelnames=("phase",),
        )
        self._m_errors = r.counter(
            "trivy_tpu_serve_batch_errors_total",
            "batches failed by an engine exception",
        )
        self._m_degraded = r.counter(
            "trivy_tpu_serve_batch_degraded_total",
            "batches re-run byte-identical on a lower rung after a device "
            "failure (or on the host DFA while a CPU engine's breaker is open)",
        )
        self._m_breaker_rejected = r.counter(
            "trivy_tpu_serve_breaker_rejected_total",
            "card batches shed with 503 while the device breaker is open",
        )
        self._m_shed = r.counter(
            "trivy_tpu_serve_oom_shed_total",
            "RESOURCE_EXHAUSTED shed-and-retry cycles (evict residents, "
            "split the batch, retry once)",
        )
        self._m_breaker_state = r.gauge(
            "trivy_tpu_device_breaker_state",
            "device circuit breaker state (0=closed, 1=half-open, 2=open)",
        )
        self._m_breaker_opens = r.counter(
            "trivy_tpu_device_breaker_opens_total",
            "closed/half-open -> open transitions",
        )
        self._m_breaker_recloses = r.counter(
            "trivy_tpu_device_breaker_recloses_total",
            "half-open -> closed transitions (probe batch succeeded)",
        )
        self._m_epoch = r.gauge(
            "trivy_tpu_serve_ruleset_epoch",
            "engine installs since start (0 = no engine yet)",
        )
        self._m_reloads = r.counter(
            "trivy_tpu_serve_ruleset_reloads_total",
            "live engine replacements (hot reloads)",
        )
        self._engine_gauges: dict[str, obs_metrics.Gauge] = {}
        r.add_collect_hook(self._collect)

    # -- admission (request threads) ------------------------------------

    def submit(
        self,
        items: list[tuple[str, bytes]],
        client_id: str = "",
        timeout_s: float | None = None,
        trace_id: str = "",
        ruleset_digest: str = "",
        explain: bool = False,
    ) -> Future:
        """Enqueue one request's items; returns a Future resolving to the
        per-item list[Secret].  Raises AdmissionError subclasses instead of
        queuing when backpressure applies.  `ruleset_digest` selects the
        lane ("" = the server's default ruleset); unknown digests raise
        UnknownRulesetError before anything is queued."""
        cfg = self.config
        now = time.monotonic()
        ticket = Ticket(
            items=list(items),
            client_id=client_id or "-",
            deadline_at=(now + timeout_s)
            if timeout_s is not None and timeout_s > 0
            else None,
            future=Future(),
            nbytes=sum(len(c) for _, c in items),
            enqueued_at=now,
            trace_id=trace_id,
            ruleset_digest=ruleset_digest,
            explain=explain,
        )
        # QoS first (cheapest, and the only per-tenant *rate* control —
        # everything below protects the server, this protects tenants
        # from each other).  Sequential with the scheduler lock, never
        # nested, so the lock-order graph gains no qos<->scheduler edge.
        wait_s, reason = self.qos.try_admit(
            ticket.client_id, ticket.nbytes, now
        )
        if wait_s > 0:
            self.stats.rejected_quota += 1
            self._m_rejected.labels(reason="quota").inc()
            self.tenant_metrics.reject(ticket.client_id, "quota")
            raise QuotaExceededError(
                f"client {ticket.client_id!r} over its {reason} quota",
                wait_s,
            )
        inflight_cap = cfg.max_inflight_per_client
        override = self.qos.max_inflight(ticket.client_id)
        if override is not None:
            inflight_cap = override
        # Device-memory watermarks next, BEFORE pool.ensure can load yet
        # another ruleset into scarce HBM: soft pressure evicts LRU pool
        # slots toward target, hard pressure sheds this admission with a
        # 429 through the same AdmissionError path the quotas use.
        self._check_hbm(ticket)
        # Residency next: make the requested ruleset's engine resident
        # (LRU admit, warm path when the registry has the artifact) BEFORE
        # the ticket can enter a lane — a lane must never hold tickets for
        # an unknown digest.  Builds run outside every scheduler lock.
        if ruleset_digest:
            if self.pool is None:
                raise UnknownRulesetError(
                    "per-request ruleset selection requires the server's "
                    "ruleset registry (start with --rules-cache-dir)"
                )
            self.pool.ensure(ruleset_digest)
        # Result-cache probe, AFTER QoS/HBM/residency so rate limits and
        # lane validation still apply to warm traffic.  Full hits demux
        # straight to the future — no ticket, no lane, no device batch.
        # Partial hits shrink the ticket to its misses before any queue
        # accounting sees it; demux re-interleaves at dispatch.  The key
        # digest must be knowable WITHOUT building an engine: digest lanes
        # carry it, the default lane reads the digest its next batch runs
        # under: a staged reload's, else the manager's active digest (""
        # until the first cold dispatch installs one — cold behavior).
        # The reference probes the active digest even with a reload
        # staged, so warm traffic keeps the old verdicts and never
        # dispatches the batch that would swap the new ruleset in.
        if self.result_cache is not None and ticket.items:
            key_digest = (
                ruleset_digest
                or self.manager.staged_digest
                or self.manager.active_digest
            )
            if key_digest:
                hits, misses = self._probe_result_cache(
                    ticket.items, key_digest
                )
                self.stats.cache_hits += len(hits)
                self.stats.cache_misses += len(misses)
                if hits:
                    self._m_cache_items.labels(outcome="hit").inc(len(hits))
                if misses:
                    self._m_cache_items.labels(outcome="miss").inc(
                        len(misses)
                    )
                if not misses:
                    return self._resolve_from_cache(ticket, hits, key_digest)
                if hits:
                    ticket.cache_hits = hits
                    ticket.total_items = len(ticket.items)
                    ticket.items = misses
                    ticket.nbytes = sum(len(c) for _, c in misses)
        with self._not_empty:
            if not self._admitting:
                self.stats.rejected_closed += 1
                self._m_rejected.labels(reason="closed").inc()
                self.tenant_metrics.reject(ticket.client_id, "closed")
                raise SchedulerClosedError(
                    "scheduler draining", cfg.retry_after_s
                )
            if (
                sum(len(l.q) for l in self._lanes.values())
                >= cfg.max_queue_depth
            ):
                self.stats.rejected_full += 1
                self._m_rejected.labels(reason="queue_full").inc()
                self.tenant_metrics.reject(ticket.client_id, "queue_full")
                raise QueueFullError(
                    f"admission queue full ({cfg.max_queue_depth} tickets)",
                    cfg.retry_after_s,
                )
            if self._inflight.get(ticket.client_id, 0) >= inflight_cap:
                self.stats.rejected_client += 1
                self._m_rejected.labels(reason="client_cap").inc()
                self.tenant_metrics.reject(ticket.client_id, "client_cap")
                raise ClientOverloadedError(
                    f"client {ticket.client_id!r} at in-flight cap "
                    f"({inflight_cap})",
                    cfg.retry_after_s,
                )
            self._inflight[ticket.client_id] = (
                self._inflight.get(ticket.client_id, 0) + 1
            )
            lane = self._lanes.get(ruleset_digest)
            if lane is None:
                lane = self._lanes[ruleset_digest] = _Lane(ruleset_digest)
            if not lane.q:
                lane.opened_at = now  # first ticket opens the fill window
            lane.q.append(ticket)
            lane.nbytes += ticket.nbytes
            self.stats.admitted += 1
            self._m_tickets.inc()
            self.tenant_metrics.admit(ticket.client_id, ruleset_digest)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="serve-batcher", daemon=True
                )
                self._thread.start()
            self._not_empty.notify()
        return ticket.future

    def _probe_result_cache(
        self, items: list[tuple[str, bytes]], key_digest: str
    ) -> tuple[dict, list[tuple[str, bytes]]]:
        """Per-item result-cache lookup (request thread — tier timeouts
        and the degrade ladder live inside the TieredCache, so a remote
        outage costs latency here, never an exception).  Returns
        (original index -> rehydrated Secret, miss items in order)."""
        hits: dict[int, object] = {}
        misses: list[tuple[str, bytes]] = []
        for i, (path, data) in enumerate(items):
            sec = self.result_cache.get(
                content_digest(data), key_digest, path
            )
            if sec is not None:
                hits[i] = sec
            else:
                misses.append((path, data))
        return hits, misses

    def _resolve_from_cache(
        self, ticket: Ticket, hits: dict, key_digest: str
    ) -> Future:
        """Resolve a fully-warm request on the submit thread: the demux a
        cold batch would have done, minus the device.  The ticket never
        entered a lane, so no inflight/queue accounting to unwind."""
        out = SecretBatch([hits[i] for i in range(len(hits))])
        out.ruleset_digest = key_digest
        out.ruleset_epoch = self._epoch_for(ticket.ruleset_digest)
        if ticket.explain:
            out.explain = {
                "trace_id": ticket.trace_id,
                "queue_wait_ms": 0.0,
                "batch_wall_ms": 0.0,
                "phases_ms": {},
                "cache": {
                    "hits": len(hits),
                    "misses": 0,
                    "ruleset_digest": key_digest,
                    "resolved_from_cache": True,
                },
            }
        self.stats.cache_resolved += 1
        self._m_cache_resolved.inc()
        try:
            ticket.future.set_result(out)
        except InvalidStateError:
            pass  # caller-side cancellation raced us
        return ticket.future

    def _epoch_for(self, lane_digest: str) -> int:
        """The epoch a dispatch on this lane would report (default lane:
        the manager's; digest lanes: the resident slot's; 0 if evicted
        between ensure and here — the verdict is digest-keyed, so epoch
        is attribution, not correctness)."""
        if not lane_digest:
            return self.manager.epoch
        if self.pool is not None:
            for d, epoch, _ in self.pool.residents():
                if d == lane_digest:
                    return epoch
        return 0

    def _check_hbm(self, ticket: Ticket) -> None:
        """Advance the HBM pressure state machine and act on it.

        Runs on request threads before any scheduler lock is held for the
        ticket.  Soft (>= hbm_soft_pct of the device limit): evict LRU
        resident-pool slots down to the byte target that would bring the
        fraction back under the soft line, using measured bytes.  Hard
        (>= hbm_hard_pct): reject with 429 + Retry-After.  Every state
        transition is promoted into the flight ring with reason
        "hbm-pressure" — the capture embeds the memory snapshot, so the
        incident names who held HBM when the watermark tripped.  No-op
        when both watermarks are 0, memwatch is off, or no byte limit is
        known (CPU without an injected budget)."""
        cfg = self.config
        if (cfg.hbm_soft_pct <= 0 and cfg.hbm_hard_pct <= 0) or (
            not memwatch.enabled()
        ):
            return
        p = memwatch.pressure()
        if p["source"] == "none":
            return
        pct = p["fraction"] * 100.0
        state = "ok"
        if cfg.hbm_hard_pct > 0 and pct >= cfg.hbm_hard_pct:
            state = "hard"
        elif cfg.hbm_soft_pct > 0 and pct >= cfg.hbm_soft_pct:
            state = "soft"
        with self._lock:
            prev = self._hbm_state
            self._hbm_state = state
            if state != prev:
                self.stats.hbm_transitions += 1
        if state != prev and self.flight is not None:
            # Outside every scheduler lock: capture re-takes them via
            # snapshot_fn (same rule as the _expire capture).
            self.flight.capture(
                trace_id=ticket.trace_id,
                method="hbm-watch",
                tenant=ticket.client_id,
                code=429 if state == "hard" else 200,
                elapsed_s=0.0,
                reason="hbm-pressure",
            )
        if state in ("soft", "hard") and (
            self.pool is not None and p["bytes_limit"] > 0
        ):
            # Evict toward the byte target that puts the device back at
            # the soft line; freeing is bounded by what the pool holds.
            soft = cfg.hbm_soft_pct or cfg.hbm_hard_pct
            excess = int((pct - soft) / 100.0 * p["bytes_limit"])
            target = max(0, self.pool.accounted_bytes() - excess)
            evicted, _freed = self.pool.evict_to_bytes(target)
            self.stats.hbm_evicted_slots += evicted
        if state == "hard":
            self.stats.rejected_hbm += 1
            self._m_rejected.labels(reason="hbm").inc()
            self.tenant_metrics.reject(ticket.client_id, "hbm")
            raise HbmPressureError(
                f"device memory at {pct:.1f}% of limit "
                f"(hard watermark {cfg.hbm_hard_pct:.0f}%)",
                cfg.retry_after_s,
            )

    def hbm_state(self) -> str:
        """Current watermark band: "ok", "soft", or "hard"."""
        with self._lock:
            return self._hbm_state

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(l.q) for l in self._lanes.values())

    def inflight_tickets(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def lane_count(self) -> int:
        with self._lock:
            return len(self._lanes)

    # -- lifecycle -------------------------------------------------------

    def drain(self, timeout: float | None = None) -> None:
        """Stop admitting (submits raise SchedulerClosedError), let the
        owner thread finish everything queued, then join it."""
        with self._not_empty:
            self._admitting = False
            self._not_empty.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)

    def close(self, timeout: float = 5.0) -> None:
        """drain(), then abort anything still queued (a wedged engine must
        not leave request threads hung on their futures)."""
        self.drain(timeout)
        stuck: list[Ticket] = []
        with self._not_empty:
            for lane in self._lanes.values():
                stuck.extend(lane.q)
                lane.q.clear()
                lane.nbytes = 0
        for t in stuck:
            self._fail_ticket(t, SchedulerClosedError("scheduler shut down"))

    # -- engine-owner thread ---------------------------------------------

    def _release(self, ticket: Ticket) -> None:
        with self._lock:
            n = self._inflight.get(ticket.client_id, 0) - 1
            if n <= 0:
                self._inflight.pop(ticket.client_id, None)
            else:
                self._inflight[ticket.client_id] = n

    def _fail_ticket(self, ticket: Ticket, exc: BaseException) -> None:
        """Fail one ticket's future, tolerating a future that resolved
        concurrently (an expiry racing the dispatch): a second
        set_exception raises InvalidStateError INSIDE the engine-owner
        thread, which would kill batching for every tenant."""
        try:
            ticket.future.set_exception(exc)
        except InvalidStateError:
            pass  # already resolved (deadline expiry won the race)
        self._release(ticket)

    def _resolve_ticket(self, ticket: Ticket, result) -> None:
        """set_result with the same already-resolved guard."""
        try:
            ticket.future.set_result(result)
        except InvalidStateError:
            pass  # already resolved (deadline expiry won the race)
        self._release(ticket)

    def _scan_with_domains(self, engine, combined):  # graftlint: owner(serve-batcher)
        """The failure-domain ladder around one device batch.

        Routing: while the breaker is open (and not yet due a probe) the
        device is not even attempted.  An engine with a host path on the
        CPU re-runs byte-identical on the host DFA
        (`HybridSecretEngine.scan_batch_host`); an engine on a card has
        no host rung, so the batch is shed with BreakerOpenError (503 +
        Retry-After).  On a device exception: RESOURCE_EXHAUSTED first
        tries shed-and-retry (evict resident rulesets through the pool's
        LRU path, split the batch in half, one retry); a megakernel
        engine then steps down ONE rung to the staged fused pipeline
        (`scan_batch_staged_sieve` — the one-dispatch fusion out of the
        loop, fused residency still in); a fused-verify engine steps
        down to the legacy device stream (`scan_batch_device_legacy` —
        fused kernels out of the loop, device still in).  A batch that
        still fails degrades to the host path on the CPU, and fails on
        a card.  Every outcome feeds the breaker, so repeated failures
        open it and a half-open probe's success re-closes it.

        Returns (results, path) with path one of "device" (healthy),
        "shed" (device succeeded after OOM recovery), "degraded" (a
        lower rung absorbed a failure), "breaker" (host run, device
        skipped; CPU engines only).  ScanTimeoutError is not a device
        failure — the deadline fired — and propagates untouched."""
        card = _on_card(engine)
        self._off_device = "shed" if card else "dfa"
        host_fn = None if card else getattr(engine, "scan_batch_host", None)
        if (host_fn is not None or card) and not self.breaker.allow():
            if card:
                raise BreakerOpenError(
                    "device breaker open: batch shed until the probe",
                    retry_after_s=self.config.breaker_cooldown_s,
                )
            return host_fn(combined), "breaker"
        try:
            faults.fire("sched.dispatch")
            results = engine.scan_batch(combined)
        except ScanTimeoutError:
            raise
        except Exception as e:
            if faults.is_oom(e):
                results = self._shed_and_retry(engine, combined)
                if results is not None:
                    self.breaker.record_success()
                    return results, "shed"
            self.breaker.record_failure()
            mega_fn = getattr(engine, "scan_batch_staged_sieve", None)
            if mega_fn is not None and getattr(
                engine, "megakernel_active", False
            ):
                try:
                    return mega_fn(combined), "degraded"
                except ScanTimeoutError:
                    raise
                except Exception:
                    self.breaker.record_failure()
            legacy_fn = getattr(engine, "scan_batch_device_legacy", None)
            if legacy_fn is not None and getattr(engine, "verify", "") == "fused":
                try:
                    return legacy_fn(combined), "degraded"
                except ScanTimeoutError:
                    raise
                except Exception:
                    self.breaker.record_failure()
            if host_fn is None:
                raise  # a card engine, or no host path: the batch fails
            return host_fn(combined), "degraded"
        self.breaker.record_success()
        return results, "device"

    def _shed_and_retry(self, engine, combined):  # graftlint: owner(serve-batcher)
        """RESOURCE_EXHAUSTED recovery: free device memory by LRU-evicting
        resident rulesets (the pool/memwatch path — eviction is
        what actually returns HBM), then retry the batch in two halves so
        the retry's peak footprint is roughly halved.  Returns stitched
        results, or None to step down the ladder instead.  One retry
        total: an OOM that survives eviction AND halving is a capacity
        problem a lower rung absorbs better than a retry storm."""
        self.stats.shed_retries += 1
        self._m_shed.inc()
        if self.pool is not None:
            target = self.pool.accounted_bytes() // 2
            evicted, _freed = self.pool.evict_to_bytes(target)
            self.stats.shed_evicted_slots += evicted
        halves = (
            [combined[: len(combined) // 2], combined[len(combined) // 2 :]]
            if len(combined) > 1
            else [combined]
        )
        out: list = []
        try:
            for half in halves:
                out.extend(engine.scan_batch(half))
        except ScanTimeoutError:
            raise
        except Exception:  # graftlint: swallow(caller records + steps down the ladder)
            return None
        return out

    def _expire(self, ticket: Ticket) -> None:
        self.stats.expired += 1
        self._m_expired.inc()
        self._fail_ticket(
            ticket,
            ScanTimeoutError("request deadline expired before dispatch"),
        )
        if self.flight is not None:
            # A deadline expiry IS the breach the flight recorder exists
            # for: capture here, at expiry time, so the scheduler snapshot
            # shows the queue state that starved the ticket (the handler's
            # 408 lands ~30s later, after the state has moved on).  Runs
            # outside every scheduler lock (capture re-takes them via
            # snapshot_fn).
            self.flight.capture(
                trace_id=ticket.trace_id,
                method="scan_secrets",
                tenant=ticket.client_id,
                code=408,
                elapsed_s=max(0.0, time.monotonic() - ticket.enqueued_at),
                reason="deadline",
            )

    def _on_breaker_transition(self, old: str, new: str, why: str) -> None:
        """Breaker state change: audit it everywhere an operator looks.
        Runs synchronously on the owner thread (record_failure/allow call
        it), outside every scheduler lock — the flight capture re-takes
        them via snapshot_fn, which now embeds the breaker snapshot."""
        gatelog.record(
            requested="device",
            backend="device" if new == "closed" else self._off_device,
            reason="breaker",
            error=f"{old}->{new}: {why}",
        )
        if self.flight is not None:
            self.flight.capture(
                trace_id="",
                method="breaker",
                tenant="",
                code=503 if new == "open" else 200,
                elapsed_s=0.0,
                reason="breaker",
            )

    def _pick_lane(self, ready: list[_Lane]) -> _Lane:  # graftlint: holds(_lock)
        """Smooth weighted round-robin (the nginx upstream algorithm) over
        the dispatch-ready lanes: every lane's accumulator grows by its
        weight each round, the max dispatches and pays back the total —
        interleaving is proportional and starvation is impossible while a
        lane stays ready."""
        total = 0.0
        best: _Lane | None = None
        for lane in ready:
            lane.current_weight += lane.weight
            total += lane.weight
            if best is None or lane.current_weight > best.current_weight:
                best = lane
        assert best is not None
        best.current_weight -= total
        return best

    def _next_batch(self) -> tuple[list[Ticket], int, str] | None:
        """Block until a lane is dispatch-ready (bytes filled or window
        elapsed), then take its tickets up to max_batch_bytes.  Returns
        None when draining and every lane is empty."""
        cfg = self.config
        window_s = max(cfg.batch_window_ms, 0.0) / 1000.0
        while True:
            expired: list[Ticket] = []
            batch: list[Ticket] | None = None
            nbytes = 0
            lane_digest = ""
            done = False
            with self._not_empty:
                now = time.monotonic()
                # Fill-or-timeout sizes to mesh capacity: an N-device
                # partition plan wants N shards' worth of rows per
                # dispatch, so both the readiness threshold and the
                # take cap scale by the device count (1 off-mesh).
                cap_bytes = cfg.max_batch_bytes * mesh_topology.capacity_hint()
                # Sweep expired tickets out of every lane first, so a
                # doomed ticket never boards a batch and never holds a
                # lane's window open.  Futures resolve after the lock
                # drops (_expire re-takes it via _release).
                for lane in self._lanes.values():
                    if not lane.q:
                        continue
                    keep: deque[Ticket] = deque()
                    for t in lane.q:
                        if t.deadline_at is not None and now > t.deadline_at:
                            expired.append(t)
                            lane.nbytes -= t.nbytes
                        else:
                            keep.append(t)
                    lane.q = keep
                ready = [
                    lane
                    for lane in self._lanes.values()
                    if lane.q
                    and (
                        lane.nbytes >= cap_bytes
                        or now >= lane.opened_at + window_s
                    )
                ]
                if ready:
                    lane = self._pick_lane(ready)
                    batch = []
                    while lane.q and (
                        not batch or nbytes < cap_bytes
                    ):
                        t = lane.q.popleft()
                        batch.append(t)
                        nbytes += t.nbytes
                        lane.nbytes -= t.nbytes
                    # Remainder (byte-capped take) gets a fresh window.
                    lane.opened_at = now
                    lane_digest = lane.digest
                elif not expired:
                    if not self._admitting and not any(
                        lane.q for lane in self._lanes.values()
                    ):
                        done = True
                    else:
                        waits = [
                            lane.opened_at + window_s - now
                            for lane in self._lanes.values()
                            if lane.q
                        ]
                        self._not_empty.wait(
                            timeout=max(min(waits), 0.001) if waits else 0.1
                        )
            for t in expired:
                self._expire(t)
            if batch:
                return batch, nbytes, lane_digest
            if done:
                return None

    def _run(self) -> None:
        while True:
            nxt = self._next_batch()
            if nxt is None:
                return
            batch, nbytes, lane_digest = nxt
            self._dispatch(batch, nbytes, lane_digest)

    def _dispatch(self, batch: list[Ticket], nbytes: int, lane_digest: str = "") -> None:  # graftlint: owner(serve-batcher)
        self._owner.assert_here()
        t0 = time.monotonic()
        combined: list[tuple[str, bytes]] = []
        spans: list[tuple[int, int]] = []
        waits: list[float] = []
        for t in batch:
            spans.append((len(combined), len(combined) + len(t.items)))
            combined.extend(t.items)
            wait = max(0.0, t0 - t.enqueued_at)
            waits.append(wait)
            self.stats.wait_s_sum += wait
            self._m_wait.observe(wait)
            self.tenant_metrics.wait(t.client_id, wait)
            # The wait interval is only known now, at dispatch — record it
            # retroactively so the trace tree shows queue time per ticket.
            obs_trace.add_span(
                "queue.wait",
                start=time.perf_counter() - wait,
                dur=wait,
                trace_id=t.trace_id,
                client=t.client_id,
                items=len(t.items),
            )
        fill = min(1.0, nbytes / max(self.config.max_batch_bytes, 1))
        self.stats.batches += 1
        self._m_batches.inc()
        self.stats.coalesced_requests += len(batch)
        self._m_coalesced.inc(len(batch))
        if len(batch) >= 2:
            self.stats.multi_request_batches += 1
            self._m_multi.inc()
        if len({t.client_id for t in batch}) >= 2:
            # The multi-tenant headline: distinct clients sharing one
            # device batch (BENCH_TENANT's shared-batch speedup source).
            self.stats.cross_tenant_batches += 1
            self._m_cross_tenant.inc()
        self.stats.items += len(combined)
        self._m_items.inc(len(combined))
        self.stats.bytes += nbytes
        self._m_bytes_total.inc(nbytes)
        self.stats.fill_ratio_sum += fill
        self._m_fill.observe(fill)
        self._m_batch_bytes.observe(float(nbytes))
        # Engine deadline: the latest ticket deadline, and only when every
        # ticket has one — if it fires, every deadline in the batch has
        # passed, so failing the whole batch with ScanTimeoutError is sound.
        deadlines = [t.deadline_at for t in batch]
        if all(d is not None for d in deadlines):
            _deadline.set_deadline_at(max(deadlines))
        else:
            _deadline.clear()
        # The batch span adopts the first traced ticket's id so a remote
        # client's tree contains the batch it rode in; the other tickets'
        # ids land in attrs for cross-referencing.
        lead = next((t.trace_id for t in batch if t.trace_id), "")
        try:
            # Batch boundary: any staged ruleset swaps in HERE, before any
            # of this batch's bytes touch an engine.  Digest lanes resolve
            # through the pool (re-admitting via the registry warm path if
            # evicted since admission); the default lane through the
            # scheduler's own manager.
            if lane_digest:
                engine, digest, epoch = self.pool.engine_for_dispatch(
                    lane_digest
                )
            else:
                engine, digest = self.manager.engine()
                epoch = self.manager.epoch
            estats = getattr(engine, "stats", None)
            phases_before = (
                {a: float(getattr(estats, a, 0.0)) for a in _PHASE_ATTRS}
                if estats is not None
                else None
            )
            with obs_trace.span(
                "batch",
                trace_id=lead or None,
                tickets=len(batch),
                items=len(combined),
                bytes=nbytes,
                trace_ids=[t.trace_id for t in batch if t.trace_id],
            ):
                # Digest scope for memwatch: lazy first-dispatch device
                # allocations (NFA tensor shipping, chunk-cache fills)
                # register under this lane's ruleset, which is what the
                # pool's measured-byte accounting reads back.
                with memwatch.ruleset_digest(lane_digest or digest):
                    results, engine_path = self._scan_with_domains(
                        engine, combined
                    )
            if engine_path in ("degraded", "breaker"):
                self.stats.degraded_batches += 1
                self._m_degraded.inc()
            phase_deltas: dict[str, float] = {}
            if phases_before is not None:
                # SieveStats accumulates across scan_batch calls; the
                # per-batch contribution is the before/after delta.
                for attr, before in phases_before.items():
                    delta = float(getattr(estats, attr, 0.0)) - before
                    if delta > 0:
                        phase = attr[:-2]
                        phase_deltas[phase] = delta
                        self._m_phase.labels(phase=phase).observe(delta)
                        self.tenant_metrics.phase(lane_digest, phase, delta)
        except ScanTimeoutError:
            for t in batch:
                self._fail_ticket(
                    t, ScanTimeoutError("scan deadline exceeded in batch")
                )
            return
        except BreakerOpenError as e:
            # A card engine behind an open breaker: the batch is shed
            # (503 + Retry-After), not an engine failure.
            self.stats.breaker_rejected += 1
            self._m_breaker_rejected.inc()
            for t in batch:
                self._fail_ticket(t, e)
            return
        except Exception as e:
            # Terminal batch failure: the device failed AND the degraded
            # host re-run failed (or the engine has no host path).  Fail
            # this batch's tickets; the owner thread survives to serve
            # the next one.
            self.stats.errors += 1
            self._m_errors.inc()
            for t in batch:
                self._fail_ticket(t, e)
            return
        except BaseException as e:
            # KeyboardInterrupt/SystemExit must unwind the owner thread,
            # but never with request threads left hanging on futures that
            # would otherwise resolve on no one's schedule.
            err = SchedulerClosedError(
                f"scheduler interrupted by {type(e).__name__}"
            )
            for t in batch:
                self._fail_ticket(t, err)
            raise
        finally:
            _deadline.clear()
        batch_wall = time.monotonic() - t0
        if self.result_cache is not None and digest:
            # Remember every scanned item's verdict under the digest that
            # ACTUALLY scanned it (which the dispatch boundary just
            # resolved — a staged swap between probe and dispatch keys
            # the new entries correctly).  Tier errors degrade inside the
            # cache; they never fail a batch that already scanned.
            for (_, data), sec in zip(combined, results):
                self.result_cache.put(content_digest(data), digest, sec)
        # Multi-program attribution: when this batch's engine demuxes a
        # program table, snapshot per-program counters at the batch
        # boundary — explain rides it below, /debug/programs reads the
        # latest one (plain assignment; read under _lock elsewhere).
        if getattr(engine, "program_table", None) is not None:
            self._last_programs = engine.programs_snapshot()
        for t, (lo, hi), wait in zip(batch, spans, waits):
            scanned = results[lo:hi]
            if t.cache_hits:
                # Partial hit: re-interleave cached verdicts with the
                # scanned misses at their original request positions.
                it = iter(scanned)
                out = SecretBatch(
                    t.cache_hits[i] if i in t.cache_hits else next(it)
                    for i in range(t.total_items)
                )
            else:
                out = SecretBatch(scanned)
            out.ruleset_digest = digest
            out.ruleset_epoch = epoch
            if t.explain:
                # Built from the same timing the span tree carries (queue
                # wait + SieveStats phase deltas), so explain costs the
                # asking ticket a dict and everyone else nothing.
                out.explain = {
                    "trace_id": t.trace_id,
                    "queue_wait_ms": round(wait * 1e3, 3),
                    "batch_wall_ms": round(batch_wall * 1e3, 3),
                    "phases_ms": {
                        k: round(v * 1e3, 3) for k, v in phase_deltas.items()
                    },
                    # the hybrid gate's routing verdict for this engine
                    # (why verify ran on dfa/device), when it has one
                    "gate": getattr(engine, "gate_decision", None),
                    # device-memory posture at dispatch: pressure fraction
                    # + ledger totals (obs/memwatch.py) and the admission
                    # state machine's current watermark band
                    "memory": {
                        **memwatch.explain_block(),
                        "state": self._hbm_state,
                    },
                    # result-cache outcome for this ticket: how many of
                    # its items rode in warm vs. paid for device time
                    "cache": {
                        "hits": len(t.cache_hits or ()),
                        "misses": hi - lo,
                        "ruleset_digest": digest,
                        "resolved_from_cache": False,
                    },
                    "batch": {
                        "tickets": len(batch),
                        "items": len(combined),
                        "bytes": nbytes,
                        "coalesced": len(batch) >= 2,
                        "fill_ratio": round(fill, 4),
                        "lane": lane_digest or "default",
                        "ruleset_digest": digest,
                        "ruleset_epoch": epoch,
                        # which failure-domain path scanned this batch:
                        # device | shed | degraded | breaker
                        "engine_path": engine_path,
                    },
                }
                # Which programs shared this batch's device pass and what
                # each contributed (programs/base.py demux).  Absent on
                # secret-only engines — the key's presence IS the signal.
                if getattr(engine, "program_table", None) is not None:
                    out.explain["programs"] = self._last_programs
            self._resolve_ticket(t, out)

    # -- hot reload ------------------------------------------------------

    def reload(self, engine_factory=None) -> str:
        """Stage a replacement DEFAULT-lane engine (built on THIS thread —
        an admin handler or SIGHUP thread, never the owner thread) to swap
        in at the next batch boundary; returns the staged ruleset digest.
        Default factory = the scheduler's own, i.e. re-read the current
        config from disk.  Digest lanes don't reload — a changed custom
        ruleset IS a new digest (content addressing)."""
        return self.manager.build_staged(engine_factory)

    def active_ruleset_digest(self) -> str:
        return self.manager.active_digest

    def ruleset_epoch(self) -> int:
        return self.manager.epoch

    # -- observability ---------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time scheduler state for flight-recorder capture: lane
        depths, per-client inflight, pool residency, QoS bucket levels —
        the context that explains why a breached request waited.  Locks
        are taken strictly sequentially (scheduler, then pool, then qos),
        never nested, so capture adds no lock-order edges."""
        now = time.monotonic()
        with self._lock:
            lanes = {
                (lane.digest or "default"): {
                    "depth": len(lane.q),
                    "queued_bytes": lane.nbytes,
                    "window_open_ms": (
                        round((now - lane.opened_at) * 1e3, 1)
                        if lane.q
                        else None
                    ),
                    "weight": lane.weight,
                }
                for lane in self._lanes.values()
            }
            inflight = dict(self._inflight)
            admitting = self._admitting
            hbm_state = self._hbm_state
        out = {
            "lanes": lanes,
            "queue_depth": sum(l["depth"] for l in lanes.values()),
            "inflight_per_client": inflight,
            "admitting": admitting,
            "hbm_state": hbm_state,
            # Failure-domain posture: flight captures embed this snapshot,
            # so every incident shows whether the breaker had the device
            # out of rotation (and whether chaos faults were armed).
            "breaker": self.breaker.snapshot(),
            "degraded_batches": self.stats.degraded_batches,
            "shed_retries": self.stats.shed_retries,
            "breaker_rejected": self.stats.breaker_rejected,
            # Mesh posture: how many devices batches are sized for, and
            # what each one has actually absorbed (rows/bytes/batches per
            # device tag) — the skew here is the scaling-efficiency story.
            "mesh": {
                "devices": mesh_topology.capacity_hint(),
                "occupancy": mesh_topology.occupancy_snapshot(),
            },
        }
        if self._last_programs is not None:
            # Program-table posture: which programs share the device pass
            # and their cumulative demux counters (last batch boundary).
            out["programs"] = self._last_programs
        if faults.active():
            out["faults"] = faults.snapshot()
        if self.result_cache is not None:
            # Result-cache posture: per-tier degrade state + this
            # scheduler's hit economics (items warm vs. device-paid).
            out["cache"] = {
                "hits": self.stats.cache_hits,
                "misses": self.stats.cache_misses,
                "resolved_requests": self.stats.cache_resolved,
                "results": self.result_cache.snapshot(),
            }
        if self.pool is not None:
            out["pool"] = [
                {"digest": d, "epoch": e, "nbytes": n}
                for d, e, n in self.pool.residents()
            ]
        if self.fleet is not None:
            # Fleet posture: which member this host is, fleet size, and
            # its affinity economics — a flight capture on a fleeted
            # host then names the member without a /debug/fleet round
            # trip.  A failing posture callable must not poison
            # capture (snapshots run on breach paths).
            try:
                out["fleet"] = self.fleet()
            except Exception:  # graftlint: swallow(posture is best-effort on capture paths)
                pass
        out["qos"] = self.qos.snapshot(now)
        return out

    def readiness(self) -> dict:
        """The /readyz verdict and its component checks.  Ready means "a
        load balancer should send this host traffic": admitting (not
        draining/closed), breaker not open (open = every batch pays the
        degraded host path), and device memory below the hard watermark.
        `engine_warm` is reported but NOT gated on — engines build lazily
        on first dispatch, and a readiness probe that requires warmth
        would keep a pull-through host out of rotation forever."""
        with self._lock:
            admitting = self._admitting
            hbm_state = self._hbm_state
        breaker = self.breaker.snapshot()
        checks = {
            "admitting": admitting,
            "breaker": breaker["state"],
            "hbm_state": hbm_state,
            "engine_warm": self.manager.active is not None,
            "pool_residents": (
                len(self.pool.residents()) if self.pool is not None else 0
            ),
        }
        ready = (
            admitting and breaker["state"] != "open" and hbm_state != "hard"
        )
        out = {"ready": ready, "checks": checks}
        if not ready:
            # When to re-probe: an open breaker knows its cooldown
            # remainder exactly; the other not-ready reasons (HBM hard,
            # not admitting) have no clock, so advertise a short
            # constant.  /readyz turns this into a Retry-After header.
            if breaker["state"] == "open":
                out["retry_after_s"] = max(
                    1.0, float(breaker.get("cooldown_remaining_s") or 0.0)
                )
            else:
                out["retry_after_s"] = 5.0
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition for the serve subsystem.  When the server
        shares its registry with the scheduler this is the whole scrape
        body; standalone schedulers (tests, embedding) render their own."""
        return self.registry.render()

    def _collect(self) -> None:
        """Registry collect hook: mirror live state into gauges at scrape
        time.  Reads the manager's non-building `active` accessor — a
        metrics scrape must never trigger the lazy first-engine build —
        and tolerates engines without stats (the oracle backend)."""
        self._m_queue_depth.set(self.queue_depth())
        self._m_lanes.set(self.lane_count())
        self._m_inflight.set(self.inflight_tickets())
        self._m_epoch.set(self.manager.epoch)
        self._m_reloads.set_total(self.manager.reloads)
        bs = self.breaker.snapshot()
        self._m_breaker_state.set(bs["state_code"])
        self._m_breaker_opens.set_total(bs["opened_total"])
        self._m_breaker_recloses.set_total(bs["reclosed_total"])
        engine = self.manager.active
        stats = getattr(engine, "stats", None)
        if stats is None:
            return

        def gauge(name: str, help_text: str, value) -> None:
            g = self._engine_gauges.get(name)
            if g is None:
                g = self.registry.gauge(f"trivy_tpu_engine_{name}", help_text)
                self._engine_gauges[name] = g
            g.set(value)

        gauge(
            "resident_hits",
            "device-resident chunk cache hits (H2D transfers skipped)",
            int(getattr(stats, "resident_hits", 0)),
        )
        gauge(
            "h2d_overlap_seconds",
            "stage/execute overlap won by the chunk pipeline",
            float(getattr(stats, "h2d_overlap_s", 0.0)),
        )
        raw = int(getattr(stats, "bytes_on_link_raw", 0))
        coded = int(getattr(stats, "bytes_on_link_coded", 0))
        gauge(
            "link_bytes_raw",
            "pre-codec payload bytes that needed device staging",
            raw,
        )
        gauge(
            "link_bytes_coded",
            "post-codec bytes actually sent over the host-device link",
            coded,
        )
        if raw:
            gauge(
                "link_codec_ratio",
                "coded/raw H2D byte ratio (1.0 = codec disengaged)",
                coded / raw,
            )
        gauge(
            "d2h_bytes_raw",
            "pre-compaction result bytes the device produced",
            int(getattr(stats, "d2h_bytes_raw", 0)),
        )
        gauge(
            "d2h_bytes",
            "post-compaction bytes actually fetched from the device",
            int(getattr(stats, "d2h_bytes", 0)),
        )
