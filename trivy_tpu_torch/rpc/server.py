"""Scan server: Twirp-style HTTP/JSON endpoints.

Mirrors pkg/rpc/server/listen.go — a mux serving the scanner service, the
cache service, /healthz and /version, with optional token auth header.  The
division of labor matches the reference (§2.5): clients walk + analyze
locally, upload blobs via the cache service, and the server runs the applier
and detectors (and owns the TPU mesh in sidecar deployments).

Endpoints (POST, JSON bodies):
  /twirp/trivy.scanner.v1.Scanner/Scan
      {Target, ArtifactID, BlobIDs, Options{Scanners}, TimeoutMs?}
      -> {OS, Results}
  /twirp/trivy.scanner.v1.Scanner/ScanSecrets
      {Target?, Files:[{Path, ContentB64}], TimeoutMs?, ClientID?}
      -> {Results, Secrets}
  /twirp/trivy.cache.v1.Cache/PutArtifact   {ArtifactID, ArtifactInfo}
  /twirp/trivy.cache.v1.Cache/PutBlob       {BlobID, BlobInfo}
  /twirp/trivy.cache.v1.Cache/MissingBlobs  {ArtifactID, BlobIDs}
                                            -> {MissingArtifact, MissingBlobIDs}
  /twirp/trivy.cache.v1.Cache/DeleteBlobs   {BlobIDs}

ScanSecrets is the TPU-sidecar seat: requests carry raw (path, blob) items,
and the server's continuous cross-request batcher (trivy_tpu/serve/)
coalesces items from CONCURRENT requests into one device batch under a
fill-or-timeout window before they board the engine.  Backpressure is
admission-level: a full queue or an over-cap client gets HTTP 429 with
Retry-After, a draining server gets 503, and an expired request deadline
gets a clean 408 JSON error.

Copied from `trivy_tpu/rpc/server.py` (the port imports nothing from the
JAX package), over the port's engines: `ScanServer`, `serve` and
`start_background` take `device` (default "cuda"; tests pass "cpu") and
`mesh`, the default factory builds `make_secret_engine(device=, mesh=)`,
and `/admin/profile/start|stop` holds one `torch.profiler.profile` window
whose Chrome trace lands in the ProfileDir beside the host span ring.
The scanner service detects vulnerabilities over the local DB in
`db_dir` (else `<cache_dir>/db`), as the reference's does.  The fleet
plane (`fleet_config`, `fleet_member`), the watch plane (`watch_config`,
its scans through the scheduler onto the server's engines) and the
protobuf wire (`rpc/protowire.py`) are the reference's.
"""

from __future__ import annotations

import base64
import binascii
import hmac
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from trivy_tpu_torch import __version__, deadline, faults, lockcheck
from trivy_tpu_torch.atypes import ArtifactInfo, _secret_to_json
from trivy_tpu_torch.cache import build_cache
from trivy_tpu_torch.cache import stats as cache_stats
from trivy_tpu_torch.cache.results import ScanResultCache
from trivy_tpu_torch.cache.store import ArtifactCache, BlobNotFoundError
from trivy_tpu_torch.deadline import ScanTimeoutError
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.mesh import plan as mesh_plan
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.obs import flight as obs_flight
from trivy_tpu_torch.obs import gatelog
from trivy_tpu_torch.obs import memwatch as obs_memwatch
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import slo as obs_slo
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.rpc.convert import blob_from_json, os_to_json, result_to_json
from trivy_tpu_torch.scanner.service import (
    LocalDriver,
    ScanOptions,
    secrets_to_results,
)
from trivy_tpu_torch.serve import (
    AdmissionError,
    BatchScheduler,
    ServeConfig,
    UnknownRulesetError,
)

TOKEN_HEADER = "Trivy-Tpu-Token"

class _Metrics:
    """RPC request families on the server's shared registry.  Latency is a
    per-method HISTOGRAM (the totals-only rendering this replaces could
    not show tail latency, the number an admission queue tunes against),
    and inflight is floor-clamped on exit so a raising handler can never
    drive the gauge negative."""

    def __init__(self, registry: obs_metrics.Registry) -> None:
        self._requests = registry.counter(
            "trivy_tpu_requests_total",
            "RPC requests by method and code",
            labelnames=("method", "code"),
        )
        self._seconds = registry.histogram(
            "trivy_tpu_request_seconds",
            "handler latency by method",
            labelnames=("method",),
        )
        self._inflight = registry.gauge(
            "trivy_tpu_inflight_requests",
            "RPC requests currently being handled",
        )

    def observe(self, method: str, code: int, elapsed: float) -> None:
        self._requests.labels(method=method, code=str(code)).inc()
        self._seconds.labels(method=method).observe(elapsed)

    def enter(self) -> None:
        self._inflight.inc()

    def exit(self) -> None:
        self._inflight.dec(floor=0.0)


class ScanServer:
    """pkg/rpc/server Server: scanner + cache services over one cache, plus
    the continuous cross-request batcher for raw secret payloads."""

    def __init__(
        self, cache: ArtifactCache, token: str = "", db_dir: str = "",
        cache_dir: str = "", serve_config: ServeConfig | None = None,
        secret_engine_factory=None, secret_config: str = "",
        rules_cache_dir: str | None = None,
        pipeline_depth: int | None = None,
        resident_chunks: int | None = None,
        profile_dir: str = "",
        slo_config: str = "",
        flight_out: str = "",
        flight_out_max_mb: float = obs_flight.DEFAULT_OUT_MAX_MB,
        result_cache: ScanResultCache | None = None,
        fleet_config=None,
        fleet_member: str = "",
        watch_config=None,
        device: str = DEFAULT_DEVICE,
        mesh=None,
    ):
        from trivy_tpu_torch.scanner.vuln import init_vuln_scanner

        self.cache = cache
        self.token = token
        # Fleet result cache (cache/results.py): per-blob verdicts the
        # scheduler probes before ticketing — warm fleet traffic demuxes
        # straight to futures with zero device dispatches.  None = off
        # (the seed behavior; --cache-backend opts the daemon in).
        self.result_cache = result_cache
        # Where the engines run: the default factory and the pool loader
        # build on `device` over `mesh` (None: the topology's process
        # mesh, as every port engine resolves it).  Resolved here, so a
        # server asked for a card that is not there fails at start, not at
        # its first request.
        self.device = resolve_device(device)
        self.mesh = mesh
        # Fleet plane (trivy_tpu_torch/fleet/): this host's identity inside a
        # multi-host fleet.  `fleet_config` is a YAML path or an already
        # parsed FleetConfig; `fleet_member` names which member THIS
        # process answers as (overriding the YAML's `self:`, so one
        # shared file serves the whole fleet).  None/"" = not fleeted:
        # no fleet headers, /debug/fleet answers {"enabled": false}.
        self.fleet = None
        if fleet_config:
            from trivy_tpu_torch.fleet.membership import (
                FleetConfig,
                FleetSelf,
                load_fleet_config,
            )

            cfg = (
                fleet_config
                if isinstance(fleet_config, FleetConfig)
                else load_fleet_config(str(fleet_config))
            )
            self.fleet = FleetSelf(cfg, self_name=fleet_member)
        # One registry per server: _Metrics' request families and the
        # scheduler's serve/engine families render as one /metrics body.
        self.registry = obs_metrics.Registry()
        self.metrics = _Metrics(self.registry)
        # Device-memory ledger on for the server's lifetime (idempotent,
        # process-global): engine/pool/cache allocations register from
        # here on, and the watermark admission checks can act.  Costs a
        # shared no-op handle per track() call site when off, nothing
        # extra per scanned byte.
        obs_memwatch.enable()
        self.driver = LocalDriver(
            cache, vuln_detector=init_vuln_scanner(db_dir, cache_dir)
        )
        self.serve_config = serve_config or ServeConfig()
        # Ruleset provenance: the secret-config path the default engine
        # factory (and SIGHUP restage) reads, and the registry cache dir a
        # warm start loads compiled artifacts from (None = registry off).
        self.secret_config = secret_config
        self.rules_cache_dir = rules_cache_dir
        # Link tuning the default factory forwards to every engine it
        # builds, including hot-reload replacements (None = engine default).
        self.pipeline_depth = pipeline_depth
        self.resident_chunks = resident_chunks
        self._config_digest: str | None = None
        self.scheduler = BatchScheduler(
            secret_engine_factory or self._build_engine,
            self.serve_config,
            registry=self.registry,
            # Per-request ruleset selection needs somewhere to load pushed
            # rulesets from; without a registry dir the pool stays off and
            # digest-carrying requests get a deterministic 404.
            ruleset_loader=(
                self._load_ruleset_engine if rules_cache_dir else None
            ),
            result_cache=result_cache,
        )
        # SLO tracking + breach capture: the tracker classifies every RPC
        # observation against its (default or --slo-config) objective;
        # breaches promote the request's span tree plus a scheduler
        # snapshot into the flight ring (GET /debug/flight, --flight-out).
        default_obj, per_method = (
            obs_slo.load_slo_config(slo_config)
            if slo_config
            else (obs_slo.Objective(), {})
        )
        self.slo = obs_slo.SloTracker(
            self.registry, default=default_obj, per_method=per_method
        )
        self.flight = obs_flight.FlightRecorder(
            snapshot_fn=self.scheduler.snapshot,
            out_path=flight_out,
            out_max_mb=flight_out_max_mb,
            # A breach capture embeds the recent hybrid-gate decisions, so
            # the incident record answers "why did verify run there".
            gate_fn=lambda: gatelog.records(limit=8),
            registry=self.registry,
            # ... and the device-memory snapshot, so hbm-pressure (and any
            # other) incidents name who held HBM at breach time.
            memory_fn=lambda: obs_memwatch.snapshot(top=5),
            # ... and the result-cache posture (tier degrade state + hit
            # economics), so a latency incident shows whether the fleet
            # cache was cold or a remote tier was eating its error budget.
            cache_fn=self.cache_report,
            # ... and the fleet posture (member identity, affinity
            # economics), so a breach on a fleeted host names which
            # member it was and whether its traffic was affine.
            fleet_fn=(
                self.fleet.brief if self.fleet is not None else None
            ),
        )
        # The scheduler captures deadline expiries itself (at expiry time,
        # when the snapshot still shows the queue that starved the ticket).
        self.scheduler.flight = self.flight
        # ... and its snapshot() gains a fleet block the same way the
        # flight recorder does (None = unfleeted, block omitted).
        if self.fleet is not None:
            self.scheduler.fleet = self.fleet.brief
        # Hybrid-gate decision audit + per-kernel device-phase sections:
        # both sources are process-level (engines are built on scheduler /
        # reload threads and own no registry), so collect hooks fold them
        # into this server's scrape at render time.
        self._m_gate_total = self.registry.counter(
            "trivy_tpu_hybrid_gate_decision_total",
            "hybrid-gate backend resolutions by outcome",
            ("backend", "reason"),
        )
        self._m_gate_margin = self.registry.gauge(
            "trivy_tpu_hybrid_gate_margin",
            "signed distance of the newest link-priced gate decision from "
            "its flip point (positive = device bar cleared)",
        )
        self._gate_exported: dict[tuple[str, str], int] = {}
        self.registry.add_collect_hook(self._collect_gate)
        # Cache-plane families, folded from the process-global tallies
        # (cache/stats.py) with the same delta-export discipline as the
        # gate hook — every tier in the chain reports through these two.
        self._m_cache_requests = self.registry.counter(
            "trivy_tpu_cache_requests_total",
            "cache lookups by tier and outcome",
            ("tier", "outcome"),
        )
        self._m_cache_evictions = self.registry.counter(
            "trivy_tpu_cache_evictions_total",
            "cache entries evicted by reason (self-heal, TTL, capacity)",
            ("reason",),
        )
        self._cache_req_exported: dict[tuple[str, str], int] = {}
        self._cache_evict_exported: dict[str, int] = {}
        self.registry.add_collect_hook(self._collect_cache)
        self._m_device_phase = self.registry.histogram(
            "trivy_tpu_device_phase_seconds",
            "fenced per-kernel device sections (tracing-enabled runs only)",
            ("kernel", "device"),
            buckets=obs_metrics.DEVICE_PHASE_BUCKETS,
        )
        self.registry.add_collect_hook(self._collect_device_phases)
        # Mesh posture: how many devices the partition plan spans (1 =
        # unmeshed).  Refreshed each scrape from the active engine's mesh
        # (a split of one card is a mesh the process topology never
        # built), else the topology, so a late-built engine's mesh shows
        # up without a server restart.
        self._m_mesh_devices = self.registry.gauge(
            "trivy_tpu_mesh_devices",
            "device count of the active mesh partition plan (1 = unmeshed)",
        )
        self.registry.add_collect_hook(
            lambda: self._m_mesh_devices.set(self.mesh_devices())
        )
        # Build/ruleset identity: one series per RESIDENT ruleset, rebuilt
        # from live state at each scrape (clear + re-set), so evicted
        # digests stop scraping instead of pinning stale 1s forever.
        self._m_build_info = self.registry.gauge(
            "trivy_tpu_build_info",
            "build and active-ruleset identity (value is always 1)",
            labelnames=("version", "ruleset_digest", "epoch"),
        )
        self.registry.add_collect_hook(self._collect_build_info)
        # Device-memory families (per-device per-component attributed
        # bytes, peak, pressure) rebuilt from the process-global ledger at
        # each scrape — same seat as the gate/device-phase hooks above.
        obs_memwatch.register_collectors(self.registry)
        # Fleet families (fleeted hosts only): the member-count gauge,
        # per-outcome affinity counters folded by delta from FleetSelf's
        # tallies, and the routing-decision counters from the process
        # decision ring (non-empty only when this process also runs a
        # FleetRouter — e.g. embedded clients and tests).
        if self.fleet is not None:
            self._m_fleet_members = self.registry.gauge(
                "trivy_tpu_fleet_members",
                "member count of the configured fleet",
            )
            self._m_fleet_affinity = self.registry.counter(
                "trivy_tpu_fleet_affinity_total",
                "scan requests on this host by digest-affinity outcome",
                ("outcome",),
            )
            self._m_fleet_route = self.registry.counter(
                "trivy_tpu_fleet_route_total",
                "fleet routing decisions by member and reason "
                "(this process's router, when it runs one)",
                ("member", "reason"),
            )
            self._fleet_aff_exported = {"hit": 0, "miss": 0}
            self._fleet_route_exported: dict[tuple[str, str], int] = {}
            self.registry.add_collect_hook(self._collect_fleet)
        # Continuous-scanning plane (trivy_tpu_torch/watch/): event sources +
        # delta planner + re-verification sweeper + verdict-delta stream.
        # `watch_config` is a YAML path or a parsed WatchConfig; requires
        # the result cache (novelty probes ARE the plane's economics).
        # None = off: /debug/watch answers {"enabled": false}.  The poll
        # loop does NOT start here — serve() owns that (in-process test
        # servers drive poll_once() directly).
        self.watch = None
        if watch_config:
            if self.result_cache is None:
                raise ValueError(
                    "watch config requires the result cache "
                    "(start with --cache-backend)"
                )
            from trivy_tpu_torch.watch import (
                WatchConfig,
                build_watch_service,
                load_watch_config,
            )

            wcfg = (
                watch_config
                if isinstance(watch_config, WatchConfig)
                else load_watch_config(str(watch_config))
            )
            self.watch = build_watch_service(
                wcfg,
                self.result_cache,
                scan_fn=self._watch_scan,
                ruleset_digest_fn=self.ruleset_digest,
                artifact_cache=self.cache,
                flight=self.flight,
                sweep_scan_fn=self._watch_sweep_scan,
            )
            self.watch.register_collectors(self.registry)
        self.draining = False  # SIGTERM: reject new work with 503
        # Live-profiling window (POST /admin/profile/start|stop): default
        # output dir from --profile-dir, overridable per start request.
        self.profile_dir = profile_dir
        self._profile_lock = lockcheck.make_lock("rpc.server.profile")
        self._profiler = None  # owner: _profile_lock
        self._profile_path = ""  # owner: _profile_lock
        self._profile_marks: list = []  # owner: _profile_lock

    def _engine_kw(self) -> dict:
        kw: dict = {"device": self.device, "mesh": self.mesh}
        if self.pipeline_depth is not None:
            kw["pipeline_depth"] = self.pipeline_depth
        if self.resident_chunks is not None:
            kw["resident_chunks"] = self.resident_chunks
        return kw

    def _build_engine(self):
        """Default engine factory: built lazily ON the engine-owner thread
        at first dispatch (a GpuHybridSecretEngine starts CUDA and builds
        its verify tables at construction — server startup and cache-only
        traffic must not pay it), and again on a staging thread at each hot reload.  Reads
        self.secret_config dynamically so an admin reload that moved the
        config path sticks for later SIGHUPs.  A build on the card that
        fails raises: no host engine stands in for it."""
        from trivy_tpu_torch.engine.hybrid import make_secret_engine
        from trivy_tpu_torch.rules.model import load_config

        cfg = load_config(self.secret_config) if self.secret_config else None
        return make_secret_engine(
            config=cfg, backend="auto",
            rules_cache_dir=self.rules_cache_dir, **self._engine_kw(),
        )

    def _load_ruleset_engine(self, digest: str):
        """ResidentRulesetPool loader: rebuild the engine for a registered
        digest.  The RuleSet source (confirm-side regexes, allow rules)
        comes from the registry's persisted ruleset.yaml — compiled tensors
        alone cannot reconstruct an engine — and the compiled artifact
        rides the warm path when present.  Raises UnknownRulesetError for
        digests nobody pushed.  Runs on request threads (admission) or the
        engine-owner thread (post-eviction re-admit), never under any
        scheduler/pool lock."""
        from trivy_tpu_torch.engine.hybrid import make_secret_engine
        from trivy_tpu_torch.registry import store as rstore

        ruleset = rstore.load_ruleset_source(self.rules_cache_dir, digest)
        if ruleset is None:
            raise UnknownRulesetError(
                f"ruleset {digest[:16]!r} not in this server's registry; "
                "push it first (trivy-tpu rules push)"
            )
        art = rstore.load_artifact(self.rules_cache_dir, digest)
        if art is not None:
            source = "warm"
        else:
            art, source = rstore.get_or_compile(
                ruleset, cache_dir=self.rules_cache_dir
            )
        engine = make_secret_engine(
            ruleset=ruleset, backend="auto", compiled=art, **self._engine_kw()
        )
        return engine, rstore.artifact_device_bytes(art), source

    # -- service methods ------------------------------------------------

    @staticmethod
    def _arm_deadline(req: dict) -> bool:
        """Server-side --timeout seat: the request's TimeoutMs arms the
        handler thread's deadline, so a server-side scan can no longer run
        unbounded (expiry surfaces as a 408 JSON error, not a hung
        connection)."""
        timeout_ms = req.get("TimeoutMs")
        if not timeout_ms:
            return False
        deadline.set_deadline(float(timeout_ms) / 1000.0)
        return True

    def scan(self, req: dict) -> dict:
        opts = req.get("Options") or {}
        options = ScanOptions(
            scanners=list(opts.get("Scanners") or ["secret"]),
            pkg_types=list(opts.get("PkgTypes") or ["os", "library"]),
            list_all_packages=bool(opts.get("ListAllPackages")),
        )
        armed = self._arm_deadline(req)
        try:
            results, detected_os = self.driver.scan(
                req.get("Target", ""),
                req.get("ArtifactID", ""),
                list(req.get("BlobIDs") or []),
                options,
            )
        finally:
            if armed:
                deadline.clear()
        return {
            "OS": os_to_json(detected_os),
            "Results": [result_to_json(r) for r in results],
        }

    def scan_secrets(self, req: dict) -> dict:
        """The batched raw-bytes path: decode items, submit one ticket to
        the scheduler, block on the demuxed future.  The handler thread
        only waits; the engine runs on the scheduler's owner thread where
        items from concurrent requests share one device batch."""
        items: list[tuple[str, bytes]] = []
        for f in req.get("Files") or []:
            try:
                content = base64.b64decode(f.get("ContentB64", "") or "")
            except (binascii.Error, ValueError) as e:
                raise ValueError(f"bad ContentB64: {e}") from e
            items.append((f.get("Path", ""), content))
        timeout_ms = req.get("TimeoutMs")
        timeout_s = float(timeout_ms) / 1000.0 if timeout_ms else None
        # Per-request ruleset selection: the RulesetDigest field (or the
        # X-Trivy-Ruleset-Select header the handler copied in) routes this
        # ticket onto that digest's lane.  Selecting the server's own
        # active ruleset collapses to the default lane, so "pin what the
        # server already runs" costs no extra residency slot.
        digest = str(
            req.get("RulesetDigest") or req.get("_ruleset_select") or ""
        )
        if digest and digest == self.ruleset_digest():
            digest = ""
        explain = bool(req.get("Explain") or req.get("_explain"))
        # Fleet affinity: sample residency BEFORE submitting (the scan
        # itself warms the digest — arrival order is what the router's
        # placement quality is measured by).
        fleet_hint = (
            self._fleet_resident_hint(digest)
            if self.fleet is not None
            else False
        )
        fut = self.scheduler.submit(
            items,
            client_id=str(req.get("ClientID") or req.get("_client") or ""),
            timeout_s=timeout_s,
            trace_id=str(req.get("_trace_id") or ""),
            ruleset_digest=digest,
            explain=explain,
        )
        # Deadline-armed requests never hang the connection: even a wedged
        # engine bounds the wait (the slack covers a dispatched batch that
        # finishes just past the ticket deadline).
        if timeout_s is not None:
            from concurrent.futures import TimeoutError as _FutTimeout

            try:
                secrets = fut.result(timeout=timeout_s + 30.0)
            except _FutTimeout:
                raise ScanTimeoutError(
                    "scan deadline exceeded waiting for batch"
                ) from None
        else:
            secrets = fut.result()
        out = {
            "Results": [
                result_to_json(r)
                for r in secrets_to_results(
                    [s for s in secrets if s.findings]
                )
            ],
            "Secrets": [_secret_to_json(s) for s in secrets],
            # The digest of the ruleset that actually scanned THIS batch
            # (a reload mid-flight attributes each response to the engine
            # that produced it, not whatever is active now).
            "RulesetDigest": getattr(secrets, "ruleset_digest", ""),
            "RulesetEpoch": getattr(secrets, "ruleset_epoch", 0),
        }
        if explain:
            # Per-phase breakdown the dispatch attached (same timing the
            # span tree carries); only the asking request pays the bytes.
            out["Explain"] = getattr(secrets, "explain", None) or {}
        if self.fleet is not None:
            # Attribute the completed scan and stash the outcome for the
            # handler's X-Trivy-Fleet-Affinity header (popped before the
            # body ships — underscore keys never reach the wire).
            out["_FleetAffinity"] = self.fleet.note_scan(
                digest, resident_hint=fleet_hint
            )
        return out

    # -- watch plane ------------------------------------------------------

    def _watch_scan(self, items: list[tuple[str, bytes]]) -> list:
        """The watch planner's scan seam: novel blobs ride the normal
        scheduler path (same batching, admission, result-cache puts as
        any client's ScanSecrets) under the default ruleset lane."""
        return self.scheduler.submit(items, client_id="watch").result(
            timeout=300.0
        )

    def _watch_sweep_scan(
        self, items: list[tuple[str, bytes]], ruleset_digest: str
    ) -> list:
        """The sweeper's scan seam: re-verdicts must run under the NEW
        ruleset's lane.  The server's own active digest collapses to the
        default lane (the scan_secrets convention: pinning what already
        runs costs no residency slot), and so does the digest a reload
        staged for that lane: the lane swaps it in at its next batch, and
        the pool could not load it (a reloaded secret-config is in no
        registry).  The reference sends the staged digest to the pool,
        which refuses it, so its sweeps after a reload fail."""
        digest = ruleset_digest
        if digest and digest in (
            self.ruleset_digest(), self.scheduler.manager.staged_digest
        ):
            digest = ""
        return self.scheduler.submit(
            items, client_id="watch", ruleset_digest=digest
        ).result(timeout=300.0)

    def watch_report(self) -> dict:
        """GET /debug/watch: the continuous-scanning plane's posture —
        per-source poll/dedupe stats and lag, planner hit economics,
        sweep progress, stream/webhook delivery counters.  A sane body
        when unwatched: enabled=false."""
        if self.watch is None:
            return {"enabled": False}
        return self.watch.snapshot()

    # -- ruleset registry -------------------------------------------------

    def reload_ruleset(self, req: dict) -> dict:
        """POST /admin/ruleset/reload: build a replacement engine on this
        handler thread (optionally from a new SecretConfigPath), stage it,
        and return the staged digest.  The swap itself happens at the next
        batch boundary on the scheduler's owner thread; in-flight requests
        finish on the old ruleset.  On a watching server, a digest change
        also schedules the re-verification sweep (the old digest's cached
        verdicts are now stale — exactly those, nothing else)."""
        path = (req or {}).get("SecretConfigPath", "")
        if path:
            self.secret_config = path
            self._config_digest = None
        old_digest = self.scheduler.active_ruleset_digest()
        digest = self.scheduler.reload()
        if self.watch is not None:
            self.watch.schedule_sweep(old_digest, digest)
        return {
            "RulesetDigest": digest,
            "Epoch": self.scheduler.ruleset_epoch(),
            "Staged": True,
        }

    # -- live profiling ---------------------------------------------------

    def profile_start(self, req: dict) -> dict:
        """POST /admin/profile/start: open a `torch.profiler` trace of the
        live serving window: CUDA kernels on a card (CUPTI sees every
        thread's launches) and the CPU ops of every thread, the
        scheduler's owner thread that runs the engine included, not only
        this handler's.  One window at a time; a failed start raises to
        this admin request and never touches a scan."""
        path = (req or {}).get("ProfileDir", "") or self.profile_dir
        if not path:
            raise ValueError(
                "no profile dir: pass ProfileDir or start the server "
                "with --profile-dir"
            )
        import torch

        with self._profile_lock:
            if self._profiler is not None:
                raise ValueError(
                    f"profiler already active ({self._profile_path})"
                )
            os.makedirs(path, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=activities,
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True
                ),
            )
            prof.start()
            self._profiler = prof
            self._profile_path = path
            self._profile_marks = [obs_trace.clock_mark()]
        return {"Profiling": True, "ProfileDir": path}

    def profile_stop(self, req: dict) -> dict:
        """POST /admin/profile/stop: close the profiler window, export its
        Chrome trace into the window's directory, and write the host span
        ring into that trace on its clock (`HostTrace` names the file when
        spans were written), so Perfetto shows host stages against the
        device timeline."""
        with self._profile_lock:
            if self._profiler is None:
                raise ValueError("profiler not active")
            prof, self._profiler = self._profiler, None
            marks = self._profile_marks + [obs_trace.clock_mark()]
            prof.stop()
            trace_path = os.path.join(
                self._profile_path,
                f"torch-trace-{os.getpid()}-{time.time_ns()}.json",
            )
            prof.export_chrome_trace(trace_path)
            host = obs_trace.merge_into_profile(trace_path, marks)
        return {
            "Profiling": False,
            "ProfileDir": self._profile_path,
            "DeviceTrace": trace_path,
            "HostTrace": host or "",
        }

    def ruleset_digest(self) -> str:
        """The digest scan surfaces advertise: the scheduler's active
        engine when one exists, else the digest the configured rules WILL
        have (pre-first-batch /metrics scrapes and Scan responses)."""
        d = self.scheduler.active_ruleset_digest()
        if d:
            return d
        if self._config_digest is None:
            from trivy_tpu_torch.registry.digest import (
                default_ruleset_digest,
                ruleset_digest,
            )

            if self.secret_config:
                from trivy_tpu_torch.rules.model import build_ruleset, load_config

                self._config_digest = ruleset_digest(
                    build_ruleset(load_config(self.secret_config))
                )
            else:
                self._config_digest = default_ruleset_digest()
        return self._config_digest

    def _collect_gate(self) -> None:
        """Registry collect hook: fold the process-level gate-audit
        tallies into this server's counter family.  gatelog counts are
        monotonic; the hook incs by delta against what it last exported,
        so many servers in one process (tests) each converge on the same
        totals without double counting within one registry."""
        for (backend, reason), total in gatelog.tallies().items():
            key = (backend, reason)
            delta = total - self._gate_exported.get(key, 0)
            if delta > 0:
                # backend/reason are bounded enums (gatelog docstring),
                # not request-controlled identities.
                self._m_gate_total.labels(  # graftlint: ignore[GL007]
                    backend=backend, reason=reason
                ).inc(delta)
                self._gate_exported[key] = total
        margin = gatelog.last_margin()
        if margin is not None:
            self._m_gate_margin.set(margin)

    def _collect_cache(self) -> None:
        """Registry collect hook: fold the process-global cache tallies
        (cache/stats.py) into this server's families by delta, so several
        in-process servers (tests) converge without double counting.
        tier/outcome/reason are bounded enums (stats.TIERS/OUTCOMES/
        EVICTION_REASONS), never request-controlled identities."""
        for (tier, outcome), total in cache_stats.request_tallies().items():
            key = (tier, outcome)
            delta = total - self._cache_req_exported.get(key, 0)
            if delta > 0:
                self._m_cache_requests.labels(  # graftlint: ignore[GL007]
                    tier=tier, outcome=outcome
                ).inc(delta)
                self._cache_req_exported[key] = total
        for reason, total in cache_stats.eviction_tallies().items():
            delta = total - self._cache_evict_exported.get(reason, 0)
            if delta > 0:
                self._m_cache_evictions.labels(  # graftlint: ignore[GL007]
                    reason=reason
                ).inc(delta)
                self._cache_evict_exported[reason] = total

    def cache_report(self) -> dict:
        """GET /debug/cache: the fleet result cache's full posture — the
        process-global request/eviction tallies, the tier chain's degrade
        state (error budgets, write-behind queue), and the scheduler's
        hit economics.  A sane body with caching off: the tallies still
        cover the artifact-cache plane ImageArtifact drives."""
        rep: dict = {
            "stats": cache_stats.snapshot(),
            "backend": type(self.cache).__name__,
            "result_cache_enabled": self.result_cache is not None,
        }
        tiers = getattr(self.cache, "snapshot", None)
        if callable(tiers):
            rep["tiers"] = tiers()
        if self.result_cache is not None:
            rep["results"] = self.result_cache.snapshot()
            rep["scheduler"] = {
                "hits": self.scheduler.stats.cache_hits,
                "misses": self.scheduler.stats.cache_misses,
                "resolved_requests": self.scheduler.stats.cache_resolved,
            }
        return rep

    def programs_report(self) -> dict:
        """GET /debug/programs: the scan-program table sharing the device
        pass and each program's cumulative demux counters, from the
        scheduler's last batch boundary.  A sane body on a secret-only
        server: enabled=false (the table only exists on multi-program
        engines)."""
        snap = getattr(self.scheduler, "_last_programs", None)
        if snap is None:
            # No multi-program batch yet — ask the active engine
            # directly so a freshly-started program server still reports
            # its table before the first dispatch.
            engine = getattr(self.scheduler, "engine", None)
            psnap = getattr(engine, "programs_snapshot", None)
            if psnap is not None and getattr(
                engine, "program_table", None
            ) is not None:
                snap = psnap()
        if snap is None:
            return {"enabled": False}
        rep = dict(snap)
        rep["enabled"] = True
        return rep

    def _collect_fleet(self) -> None:
        """Registry collect hook (fleeted hosts only): refresh the member
        gauge and fold FleetSelf's affinity tallies plus the process's
        routing-decision tallies into counters by delta.  All labels are
        bounded enums — outcome is hit/miss, member names come from the
        static fleet config, reasons from the decisions module's enum —
        so GL007's governor requirement does not apply."""
        from trivy_tpu_torch.fleet import decisions as fleet_decisions

        self._m_fleet_members.set(len(self.fleet.config.members))
        aff = self.fleet.affinity()
        for outcome, total in (("hit", aff["hits"]), ("miss", aff["misses"])):
            delta = total - self._fleet_aff_exported[outcome]
            if delta > 0:
                self._m_fleet_affinity.labels(  # graftlint: ignore[GL007]
                    outcome=outcome
                ).inc(delta)
                self._fleet_aff_exported[outcome] = total
        for (member, reason), total in fleet_decisions.tallies().items():
            key = (member, reason)
            delta = total - self._fleet_route_exported.get(key, 0)
            if delta > 0:
                self._m_fleet_route.labels(  # graftlint: ignore[GL007]
                    member=member, reason=reason
                ).inc(delta)
                self._fleet_route_exported[key] = total

    def fleet_report(self, probe: bool = False) -> dict:
        """GET /debug/fleet: this host's fleet posture — membership table
        with live peer health (actively refreshed when `probe`), this
        member's identity, its resident-digest history, and affinity
        economics.  A sane body on an unfleeted host: enabled=false."""
        if self.fleet is None:
            return {"enabled": False}
        rep = self.fleet.report(probe=probe)
        rep["enabled"] = True
        return rep

    def _fleet_resident_hint(self, digest: str) -> bool:
        """Was `digest`'s engine already warm on this host BEFORE the
        current request (pool-resident, or the active default engine for
        the default lane)?  Feeds FleetSelf.note_scan: a router that
        sends warm traffic where warmth lives scores affinity hits."""
        if digest:
            pool = self.scheduler.pool
            if pool is None:
                return False
            return any(d == digest for d, _, _ in pool.residents())
        # "" = the default lane: warm once the default engine exists.
        return bool(self.scheduler.active_ruleset_digest())

    def _collect_device_phases(self) -> None:
        """Registry collect hook: drain pending fenced per-kernel samples
        into trivy_tpu_device_phase_seconds{kernel,device}.  Samples only
        exist while tracing is enabled; the drain is destructive, so
        exactly one scraping server observes each sample.  Both labels
        are bounded by construction (the kernel enum, plus device tags
        from the topology and the one mesh[N] aggregate) — the governor
        pattern GL007 asks for."""
        for kernel, device, seconds in obs_metrics.drain_device_phases():
            self._m_device_phase.labels(  # graftlint: ignore[GL007]
                kernel=kernel, device=device
            ).observe(seconds)

    def _collect_build_info(self) -> None:
        """Registry collect hook: rebuild trivy_tpu_build_info from live
        state — the default ruleset plus one series per pool-resident
        digest.  clear() first so evicted residents stop scraping; cheap
        (ruleset_digest() is cached, residents() is a lock + list copy),
        and it never builds an engine."""
        fam = self._m_build_info
        fam.clear()
        # Digest labels here are bounded by construction — one series for
        # the active ruleset plus one per pool slot, and clear() above
        # resets the family every scrape — so GL007's governor requirement
        # does not apply.
        fam.labels(  # graftlint: ignore[GL007]
            version=__version__,
            ruleset_digest=self.ruleset_digest(),
            epoch=str(self.scheduler.ruleset_epoch()),
        ).set(1)
        pool = self.scheduler.pool
        if pool is not None:
            for digest, epoch, _nbytes in pool.residents():
                fam.labels(  # graftlint: ignore[GL007]
                    version=__version__,
                    ruleset_digest=digest,
                    epoch=str(epoch),
                ).set(1)

    def memory_report(self) -> dict:
        """The /debug/memory body: memwatch's snapshot (per-device raw +
        attributed breakdown, residual, top allocations, pressure) plus
        this server's watermarks, the admission state machine's band, and
        the resident pool's estimate-vs-measured reconciliation.  The
        per-component attributed sums equal the registered allocations
        exactly — tolerance 0 by construction; only the raw residual
        (backend in-use minus the ledger) is an estimate."""
        report = obs_memwatch.snapshot()
        report["watermarks"] = {
            "soft_pct": self.serve_config.hbm_soft_pct,
            "hard_pct": self.serve_config.hbm_hard_pct,
        }
        report["state"] = self.scheduler.hbm_state()
        pool = self.scheduler.pool
        if pool is not None:
            est, meas = pool.estimate_reconciliation()
            report["pool"] = {
                "resident_slots": pool.resident_count(),
                "estimate_bytes": pool.resident_bytes(),
                "accounted_bytes": pool.accounted_bytes(),
                "measured_bytes": meas,
                "estimate_error_ratio": (
                    (meas - est) / est if est > 0 else 0.0
                ),
            }
        return report

    def mesh_report(self) -> dict:
        """The /debug/mesh body: the mesh plane's full posture — topology
        (device tags, spec, platform), the partition-plan table (tensor
        family -> spec + replicated/sharded role), per-device occupancy
        (rows/bytes/batches each staging lane absorbed, plus the scaling
        efficiency that summarizes the skew), and each device's resident
        attributed bytes from the memory ledger.  Answers sane JSON on an
        unmeshed host too: enabled=false, devices=1, empty occupancy."""
        report = mesh_topology.describe(self._engine_mesh())
        report["plan"] = mesh_plan.plan_table()
        report["occupancy"] = mesh_topology.occupancy_snapshot()
        report["scaling_efficiency"] = mesh_topology.occupancy_efficiency()
        mem = obs_memwatch.snapshot()
        report["resident_bytes"] = {
            dev: info.get("attributed_bytes", 0)
            for dev, info in mem.get("devices", {}).items()
        }
        return report

    def _engine_mesh(self):
        """The active default engine's mesh, else the server's own; None
        lets the topology describe the process mesh."""
        mesh = getattr(self.scheduler.manager.active, "mesh", None)
        return mesh if mesh is not None else mesh_topology.as_mesh(self.mesh)

    def mesh_devices(self) -> int:
        """Lanes of the mesh the server's engines run over (1 unmeshed)."""
        mesh = self._engine_mesh()
        if mesh is not None:
            return mesh_topology.mesh_device_count(mesh)
        return mesh_topology.capacity_hint()

    def readiness(self) -> dict:
        """The /readyz body: the scheduler's component checks (admitting,
        breaker, HBM band, engine warmth, pool residency) plus this
        server's SIGTERM draining flag.  Distinct from /healthz on
        purpose — healthz answers "is the process alive" (a liveness
        probe must stay true while draining, or the orchestrator
        kill-loops a healthy drain), readyz answers "should a balancer
        send this host traffic"."""
        rep = self.scheduler.readiness()
        rep["checks"]["draining"] = self.draining
        rep["ready"] = bool(rep["ready"] and not self.draining)
        if self.draining:
            # Draining dominates the hint: the same 5s floor the POST
            # plane's 503 advertises (the drain window, not a breaker
            # cooldown, decides when to come back).
            rep["retry_after_s"] = max(
                float(rep.get("retry_after_s") or 0.0), 5.0
            )
        return rep

    def breaker_report(self) -> dict:
        """The /debug/breaker body: breaker state + counters, the
        failure-domain tallies, and the armed fault plane (if any) — the
        one-stop surface for "why is this host degraded"."""
        sched = self.scheduler
        return {
            "breaker": sched.breaker.snapshot(),
            "degraded_batches": sched.stats.degraded_batches,
            "shed_retries": sched.stats.shed_retries,
            "shed_evicted_slots": sched.stats.shed_evicted_slots,
            "breaker_rejected": sched.stats.breaker_rejected,
            "batch_errors": sched.stats.errors,
            "faults": faults.snapshot(),
        }

    def push_ruleset(self, req: dict) -> dict:
        """POST /admin/ruleset/push: install a ruleset into the server's
        registry by digest.  Client-side-compiled pushes carry the YAML
        source plus the compiled artifact (ManifestJson + NpzB64) and skip
        server compilation entirely after never-trust validation;
        YAML-only pushes compile here.  Admit=true (default) also makes
        the engine pool-resident so the tenant's first scan pays no build.
        """
        if not self.rules_cache_dir:
            raise ValueError(
                "rules push requires the server's ruleset registry "
                "(start with --rules-cache-dir)"
            )
        from trivy_tpu_torch.registry import store as rstore

        req = req or {}
        rules_yaml = ""
        if req.get("RulesYamlB64"):
            rules_yaml = base64.b64decode(req["RulesYamlB64"]).decode(
                "utf-8"
            )
        manifest = req.get("ManifestJson")
        if isinstance(manifest, str):
            manifest = json.loads(manifest)
        npz = (
            base64.b64decode(req["NpzB64"]) if req.get("NpzB64") else None
        )
        digest, source = rstore.install_ruleset(
            self.rules_cache_dir,
            rules_yaml=rules_yaml,
            manifest=manifest,
            npz=npz,
        )
        resident = False
        pool = self.scheduler.pool
        if req.get("Admit", True) and pool is not None:
            pool.ensure(digest)
            resident = True
        if self.watch is not None:
            # A pushed ruleset supersedes the currently active one for
            # the watch plane: re-verify the active digest's cached
            # verdicts under the pushed digest's lane.
            self.watch.schedule_sweep(
                self.scheduler.active_ruleset_digest(), digest
            )
        return {
            "RulesetDigest": digest,
            "Source": source,
            "Resident": resident,
        }

    def put_artifact(self, req: dict) -> dict:
        self.cache.put_artifact(
            req["ArtifactID"], ArtifactInfo.from_json(req.get("ArtifactInfo") or {})
        )
        return {}

    def put_blob(self, req: dict) -> dict:
        self.cache.put_blob(req["BlobID"], blob_from_json(req.get("BlobInfo") or {}))
        return {}

    def missing_blobs(self, req: dict) -> dict:
        missing_artifact, missing = self.cache.missing_blobs(
            req.get("ArtifactID", ""), list(req.get("BlobIDs") or [])
        )
        return {"MissingArtifact": missing_artifact, "MissingBlobIDs": missing}

    def delete_blobs(self, req: dict) -> dict:
        self.cache.delete_blobs(list(req.get("BlobIDs") or []))
        return {}


_ROUTES = {
    "/twirp/trivy.scanner.v1.Scanner/Scan": "scan",
    "/twirp/trivy.scanner.v1.Scanner/ScanSecrets": "scan_secrets",
    "/twirp/trivy.cache.v1.Cache/PutArtifact": "put_artifact",
    "/twirp/trivy.cache.v1.Cache/PutBlob": "put_blob",
    "/twirp/trivy.cache.v1.Cache/MissingBlobs": "missing_blobs",
    "/twirp/trivy.cache.v1.Cache/DeleteBlobs": "delete_blobs",
    # Admin plane (token-authed like every POST): stage a ruleset swap,
    # install a pushed ruleset, open/close a live torch.profiler window.
    "/admin/ruleset/reload": "reload_ruleset",
    "/admin/ruleset/push": "push_ruleset",
    "/admin/profile/start": "profile_start",
    "/admin/profile/stop": "profile_stop",
}


# Debug surfaces the GET side serves, with the one-line description the
# `/debug` index renders.  Every new surface registers here — the index
# handler and the route chain both read this table, and a regression test
# asserts each listed route actually answers.
DEBUG_SURFACES = {
    "/debug/traces": "span ring as Chrome-trace JSON "
    "(?limit=N, newest first)",
    "/debug/slo": "per-method SLO burn rates and remaining error budget",
    "/debug/flight": "breach-promoted incident ring "
    "(?limit=N, newest first)",
    "/debug/gate": "hybrid-gate decision audit: backend resolutions with "
    "cost-model inputs (?limit=N, newest first)",
    "/debug/memory": "device-memory ledger: per-device raw vs attributed "
    "bytes, watermarks, pressure state, pool estimate reconciliation",
    "/debug/breaker": "device circuit-breaker state + failure-domain "
    "tallies (degraded/shed batches) and the armed fault plane",
    "/debug/mesh": "mesh execution plane: topology, partition-plan table, "
    "per-device occupancy and resident bytes, scaling efficiency",
    "/debug/cache": "fleet result cache: per-tier request/eviction "
    "tallies, tier degrade state and write-behind queue, scheduler hit "
    "economics",
    "/debug/fleet": "fleet plane: membership table with per-member "
    "health, this host's identity and resident-digest set, affinity "
    "economics (?probe=1 actively probes peers' /readyz first)",
    "/debug/programs": "device scan programs: program table sharing the "
    "device pass, per-program demux counters (candidates/verdicts) at "
    "the last batch boundary",
    "/debug/watch": "continuous-scanning plane: per-source poll/dedupe "
    "stats and lag, delta-planner hit economics, re-verification sweep "
    "progress, verdict-delta stream and webhook delivery counters",
}


def _query_limit(query: str, default: int = 64) -> int:
    """?limit=N for the debug endpoints; bad values fall back to the
    default rather than 400 (these are operator conveniences)."""
    try:
        return max(1, int(parse_qs(query).get("limit", [default])[0]))
    except (TypeError, ValueError):
        return default


def _make_handler(server: ScanServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _send(
            self, code: int, payload: dict,
            headers: dict[str, str] | None = None,
        ) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if server.fleet is not None:
                # Every response from a fleeted host names which member
                # answered — the router's ground truth for attribution
                # (and a human's, when curling through a balancer).
                self.send_header(
                    "X-Trivy-Fleet-Member", server.fleet.name
                )
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            route = parsed.path
            if route == "/healthz":
                body = b"ok"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif route == "/readyz":
                # Readiness, distinct from liveness: 503 tells the load
                # balancer to rotate this host out (draining, breaker
                # open, HBM hard) while /healthz keeps answering 200 so
                # the orchestrator doesn't kill a clean drain.
                # A not-ready host says WHEN to re-probe: Retry-After
                # derives from the reason (breaker cooldown remaining,
                # drain window), so fleet peers and balancers back off
                # for the right duration instead of a guessed constant.
                rep = server.readiness()
                headers = None
                if not rep["ready"]:
                    headers = {
                        "Retry-After": str(
                            max(
                                1,
                                int(round(rep.get("retry_after_s") or 5.0)),
                            )
                        )
                    }
                self._send(200 if rep["ready"] else 503, rep, headers)
            elif route == "/version":
                self._send(200, {"Version": __version__})
            elif route == "/metrics":
                # One render path: build_info rides the registry's
                # collect hook like every other live-state family.
                body = server.registry.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif route == "/debug/traces":
                # Span ring as Chrome-trace JSON — load in Perfetto or
                # chrome://tracing.  Empty traceEvents when tracing is off.
                # Bounded: newest `limit` spans only (default 64) — a full
                # 8192-span ring must not become a multi-MB response.
                spans = obs_trace.snapshot()
                spans = spans[-_query_limit(parsed.query):]
                spans.reverse()  # newest first
                self._send(200, obs_trace.to_chrome(spans))
            elif route == "/debug/slo":
                # Per-method burn rates and remaining error budget (see
                # obs/slo.py for the window/budget math).
                self._send(200, server.slo.report())
            elif route == "/debug/flight":
                # Captured breach incidents, newest first, same ?limit=N
                # contract as /debug/traces.
                self._send(
                    200,
                    {
                        "captured": server.flight.captured,
                        "records": server.flight.records(
                            _query_limit(parsed.query)
                        ),
                    },
                )
            elif route == "/debug/gate":
                # Hybrid-gate decision audit: newest-first records with
                # the measured link terms and thresholds each decision
                # priced, plus the monotonic per-outcome tallies.
                self._send(
                    200,
                    {
                        "decisions": gatelog.records(
                            _query_limit(parsed.query)
                        ),
                        "tallies": {
                            f"{backend}/{reason}": n
                            for (backend, reason), n in sorted(
                                gatelog.tallies().items()
                            )
                        },
                    },
                )
            elif route == "/debug/memory":
                # Device-memory ledger: raw HBM truth vs attributed
                # truth, watermarks, and the pool's estimate error.
                self._send(200, server.memory_report())
            elif route == "/debug/breaker":
                # Failure-domain posture: breaker state machine,
                # degraded/shed tallies, armed chaos faults.
                self._send(200, server.breaker_report())
            elif route == "/debug/mesh":
                # Mesh plane posture: topology + plan table + per-device
                # occupancy/resident bytes (sane body when unmeshed).
                self._send(200, server.mesh_report())
            elif route == "/debug/cache":
                # Fleet result cache posture: tier chain health + hit
                # economics (sane body with caching off).
                self._send(200, server.cache_report())
            elif route == "/debug/fleet":
                # Fleet plane posture: membership + health, identity,
                # resident digests, affinity (sane body unfleeted).
                # ?probe=1 actively probes every peer's /readyz first —
                # opt-in, so the default scrape stays request-free.
                probe = parse_qs(parsed.query).get("probe", ["0"])[
                    0
                ].lower() in ("1", "true", "yes")
                self._send(200, server.fleet_report(probe=probe))
            elif route == "/debug/programs":
                # Program-table posture: which scan programs share the
                # device pass + demux counters (sane body when the
                # engine is secret-only: enabled=false).
                self._send(200, server.programs_report())
            elif route == "/debug/watch":
                # Continuous-scanning posture: sources, lag, planner hit
                # rates, sweep progress, stream delivery (sane body when
                # unwatched: enabled=false).
                self._send(200, server.watch_report())
            elif route in ("/debug", "/debug/"):
                # Index of every debug surface with its one-liner.
                self._send(200, {"surfaces": DEBUG_SURFACES})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            server.metrics.enter()
            try:
                self._do_POST()
            finally:
                server.metrics.exit()

        def _inject_fault(self, kind: str) -> bool:
            """Act out one injected rpc.serve fault.  True = the request
            was consumed (no further handling); latency returns False so
            the delayed request still completes normally."""
            import time as _time

            if kind == "latency":
                _time.sleep(faults.latency_s())
                return False
            if kind == "reset":
                # Drop the TCP conversation mid-request: the client sees
                # a connection reset / remote disconnect, the retryable
                # class its backoff loop exists for.
                self.close_connection = True
                self.connection.close()
                return True
            if kind == "truncate":
                # A syntactically valid HTTP response whose JSON body is
                # cut short — the client's json.loads raises, which its
                # retry loop treats as a truncated-body network fault.
                body = json.dumps({"error": "injected truncation-"}).encode()
                half = body[: len(body) // 2]
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(half)))
                self.end_headers()
                self.wfile.write(half)
                return True
            # error/oom/corrupt: a retryable server-side 5xx.
            self._send(500, {"error": f"injected fault ({kind})"})
            return True

        def _do_POST(self):
            import time as _time

            # Always drain the body first: HTTP/1.1 keep-alive connections
            # desynchronize if a response is sent with unread body bytes.
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            # Chaos seam: server-side wire faults (conn reset, truncated
            # response body, injected latency), acted out at the HTTP
            # layer so the client retry loop sees exactly what a real
            # network failure produces.  After the body drain on purpose
            # (keep-alive hygiene holds even under injection).
            kind = faults.decide("rpc.serve")
            if kind is not None and self._inject_fault(kind):
                return
            method = _ROUTES.get(self.path)
            start = _time.monotonic()
            # Cross-boundary trace propagation: adopt the client's id (a
            # sanitized copy — header bytes must not flow into traces or
            # logs verbatim) or mint one so the response header always
            # names the trace this request's spans carry.
            hdr = self.headers.get("X-Trivy-Trace-Id", "")
            trace_id = "".join(
                c for c in hdr if c.isalnum() or c in "-_"
            )[:64]
            if not trace_id and obs_trace.enabled():
                trace_id = obs_trace.new_trace_id()
            # Tenant attribution for breach capture; the scan_secrets
            # branch below fills it in once the body is parsed.
            info = {"tenant": ""}

            def observe(code: int) -> None:
                # Known method names only: raw request paths would let an
                # unauthenticated client inject label characters and grow
                # the counter map without bound.
                elapsed = _time.monotonic() - start
                server.metrics.observe(method or "unknown", code, elapsed)
                breaches = server.slo.observe(
                    method or "unknown", code, elapsed
                )
                if breaches or code == 429:
                    # Breach capture: latency over objective, error-budget
                    # classes (408/5xx), and QoS rejections (429 — no
                    # budget burn, but the tenant felt it) promote this
                    # request's spans + a scheduler snapshot.
                    server.flight.capture(
                        trace_id=trace_id,
                        method=method or "unknown",
                        tenant=info["tenant"],
                        code=code,
                        elapsed_s=elapsed,
                        reason="+".join(breaches) or "reject",
                    )

            def send(
                code: int, payload: dict,
                headers: dict[str, str] | None = None,
            ) -> None:
                observe(code)
                if trace_id:
                    headers = dict(headers or {})
                    headers.setdefault("X-Trivy-Trace-Id", trace_id)
                self._send(code, payload, headers)

            if server.token and not hmac.compare_digest(
                self.headers.get(TOKEN_HEADER, "").encode("utf-8", "replace"),
                server.token.encode("utf-8", "replace"),
            ):
                send(401, {"error": "invalid token"})
                return
            if method is None:
                send(404, {"error": f"no such rpc: {self.path}"})
                return
            if server.draining:
                # SIGTERM drain: stop admitting new work; in-flight batches
                # finish before the process exits.
                send(
                    503, {"error": "server draining"},
                    {"Retry-After": "5"},
                )
                return
            # Twirp wire negotiation: protobuf requests get protobuf
            # responses (the reference Go client's default); everything
            # else stays JSON.  Twirp errors are JSON in both modes.
            ctype = self.headers.get("Content-Type", "")
            proto_mode = ctype.split(";")[0].strip() in (
                "application/protobuf", "application/x-protobuf",
            )
            try:
                if proto_mode:
                    from trivy_tpu_torch.rpc import protowire

                    if method == "scan_secrets":
                        send(415, {"error": "ScanSecrets is JSON-only"})
                        return
                    if not protowire.available():
                        send(415, {"error": "protobuf wire unavailable"})
                        return
                    req = protowire.decode_request(method, raw)
                    with obs_trace.span(
                        f"rpc.{method}", trace_id=trace_id or None
                    ):
                        out = getattr(server, method)(req)
                    data = protowire.encode_response(method, out)
                    observe(200)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/protobuf")
                    if method == "scan":
                        self.send_header(
                            "X-Trivy-Ruleset", server.ruleset_digest()
                        )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                req = json.loads(raw or b"{}")
                if method == "scan_secrets":
                    if "_client" not in req:
                        # Per-client in-flight caps key on the explicit
                        # ClientID when sent, else the peer address.
                        req["_client"] = self.client_address[0]
                    req["_trace_id"] = trace_id
                    info["tenant"] = str(
                        req.get("ClientID") or req.get("_client") or ""
                    )
                    # X-Trivy-Explain: 1 (CLI --explain): echo the
                    # per-phase timing breakdown in the response.
                    if self.headers.get("X-Trivy-Explain", "") in (
                        "1", "true", "yes",
                    ):
                        req["_explain"] = True
                    # Header-based ruleset routing (proxies can set it
                    # without touching bodies); sanitized like the trace
                    # header — digests are hex, anything else can only
                    # 404, never reach a log or label verbatim.
                    sel = self.headers.get("X-Trivy-Ruleset-Select", "")
                    req["_ruleset_select"] = "".join(
                        c for c in sel if c.isalnum() or c in "-_"
                    )[:80]
                with obs_trace.span(
                    f"rpc.{method}", trace_id=trace_id or None
                ):
                    out = getattr(server, method)(req)
                if method in ("scan", "scan_secrets"):
                    # Every scan response states which ruleset produced it.
                    dig = out.get("RulesetDigest") or server.ruleset_digest()
                    hdrs = {"X-Trivy-Ruleset": dig}
                    # ... and, on a fleeted host, whether the digest was
                    # already warm here (the router's affinity signal).
                    affinity = out.pop("_FleetAffinity", "")
                    if affinity:
                        hdrs["X-Trivy-Fleet-Affinity"] = affinity
                    send(200, out, hdrs)
                else:
                    send(200, out)
            except AdmissionError as e:
                # Backpressure: full queue / over-cap client -> 429, a
                # draining scheduler or a card behind an open breaker ->
                # 503; both carry Retry-After so the client backoff has a
                # server-informed floor.
                from trivy_tpu_torch.serve import BreakerOpenError, SchedulerClosedError

                code = (
                    503
                    if isinstance(e, (SchedulerClosedError, BreakerOpenError))
                    else 429
                )
                send(
                    code, {"error": str(e)},
                    {"Retry-After": str(max(1, int(e.retry_after_s)))},
                )
            except UnknownRulesetError as e:
                # Deterministic: the digest is not in the registry and a
                # retry cannot fix that — the client must push first.
                send(404, {"error": str(e)})
            except ScanTimeoutError as e:
                send(408, {"error": str(e)})  # clean JSON, not a hang
            except BlobNotFoundError as e:
                send(422, {"error": str(e)})  # deterministic; don't retry
            except (KeyError, json.JSONDecodeError) as e:
                send(400, {"error": f"bad request: {e}"})
            except ValueError as e:
                # protobuf DecodeError subclasses ValueError: a malformed
                # body is the client's fault (Twirp: malformed = 400, not
                # a retryable 5xx).
                send(400, {"error": f"bad request: {e}"})
            except Exception as e:  # one bad request must not kill the server
                send(500, {"error": str(e)})

    return Handler


def make_http_server(
    addr: str,
    cache: ArtifactCache,
    token: str = "",
    db_dir: str = "",
    cache_dir: str = "",
    serve_config: ServeConfig | None = None,
    secret_engine_factory=None,
    secret_config: str = "",
    rules_cache_dir: str | None = None,
    pipeline_depth: int | None = None,
    resident_chunks: int | None = None,
    profile_dir: str = "",
    slo_config: str = "",
    flight_out: str = "",
    flight_out_max_mb: float = obs_flight.DEFAULT_OUT_MAX_MB,
    result_cache: ScanResultCache | None = None,
    fleet_config=None,
    fleet_member: str = "",
    watch_config=None,
    device: str = DEFAULT_DEVICE,
    mesh=None,
) -> ThreadingHTTPServer:
    host, _, port = addr.rpartition(":")
    scan_server = ScanServer(
        cache, token, db_dir, cache_dir,
        serve_config=serve_config,
        secret_engine_factory=secret_engine_factory,
        secret_config=secret_config,
        rules_cache_dir=rules_cache_dir,
        pipeline_depth=pipeline_depth,
        resident_chunks=resident_chunks,
        profile_dir=profile_dir,
        slo_config=slo_config,
        flight_out=flight_out,
        flight_out_max_mb=flight_out_max_mb,
        result_cache=result_cache,
        fleet_config=fleet_config,
        fleet_member=fleet_member,
        watch_config=watch_config,
        device=device,
        mesh=mesh,
    )
    httpd = ThreadingHTTPServer(
        (host or "localhost", int(port)), _make_handler(scan_server)
    )
    httpd.scan_server = scan_server  # tests/serve() reach the scheduler
    return httpd


def serve(
    addr: str,
    cache_dir: str = "",
    token: str = "",
    db_dir: str = "",
    serve_config: ServeConfig | None = None,
    secret_config: str = "",
    rules_cache_dir: str | None = None,
    pipeline_depth: int | None = None,
    resident_chunks: int | None = None,
    profile_dir: str = "",
    slo_config: str = "",
    flight_out: str = "",
    flight_out_max_mb: float = obs_flight.DEFAULT_OUT_MAX_MB,
    cache_backend: str = "",
    cache_ttl: int = 0,
    fleet_config: str = "",
    fleet_member: str = "",
    watch_config: str = "",
    device: str = DEFAULT_DEVICE,
) -> None:
    """pkg/rpc/server/listen.go ListenAndServe, with graceful SIGTERM
    drain: stop admitting (503 + Retry-After), finish the batches already
    queued in the scheduler, then exit.  SIGHUP hot-reloads the secret
    ruleset: the config re-reads and compiles on a side thread, then swaps
    in at the next batch boundary (zero dropped requests)."""
    import signal

    # Flight-recorder contract: every request is traced at ring-buffer
    # cost so a breach can promote its span tree.  Daemon-only — tests
    # and embedders opt in explicitly via obs_trace.enable() so that
    # in-process servers never flip tracing globally.
    obs_trace.enable()
    # The backend spec shares the CLI scan path's grammar ("" = FS when a
    # cache dir exists, else memory).  An EXPLICIT --cache-backend also
    # turns on the fleet result cache: the scheduler then probes per-blob
    # verdicts before ticketing, so warm fleet traffic never touches the
    # device.  Unset keeps the seed behavior (no result caching).
    cache = build_cache(cache_backend, cache_dir, cache_ttl)
    result_cache = ScanResultCache(cache) if cache_backend else None
    if watch_config and result_cache is None:
        raise ValueError(
            "--watch-config requires --cache-backend: the delta planner "
            "probes the result cache to prove blobs novel"
        )
    httpd = make_http_server(
        addr, cache, token, db_dir, cache_dir, serve_config=serve_config,
        secret_config=secret_config, rules_cache_dir=rules_cache_dir,
        pipeline_depth=pipeline_depth, resident_chunks=resident_chunks,
        profile_dir=profile_dir, slo_config=slo_config,
        flight_out=flight_out, flight_out_max_mb=flight_out_max_mb,
        result_cache=result_cache,
        fleet_config=fleet_config, fleet_member=fleet_member,
        watch_config=watch_config or None,
        device=device,
    )
    scan_server: ScanServer = httpd.scan_server
    if scan_server.watch is not None:
        scan_server.watch.start()

    def _drain_and_stop() -> None:
        scan_server.draining = True
        scan_server.scheduler.drain(timeout=60.0)
        httpd.shutdown()

    def _on_sigterm(signum, frame) -> None:
        # serve_forever runs on this thread; shutdown() must come from
        # another one or it deadlocks.
        threading.Thread(target=_drain_and_stop, daemon=True).start()

    def _on_sighup(signum, frame) -> None:
        # Engine build is seconds of work: stage off the signal frame.
        threading.Thread(
            target=scan_server.reload_ruleset, args=({},), daemon=True
        ).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
        signal.signal(signal.SIGHUP, _on_sighup)
    except (ValueError, AttributeError):
        pass  # not the main thread (embedded); drain is the caller's job
    print(f"trivy-tpu server listening on {httpd.server_address[0]}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if scan_server.watch is not None:
            scan_server.watch.close()
        scan_server.scheduler.close()
        httpd.server_close()


def start_background(
    addr: str, cache: ArtifactCache, token: str = "", db_dir: str = "",
    serve_config: ServeConfig | None = None, secret_engine_factory=None,
    secret_config: str = "", rules_cache_dir: str | None = None,
    profile_dir: str = "", slo_config: str = "", flight_out: str = "",
    result_cache: ScanResultCache | None = None,
    fleet_config=None, fleet_member: str = "",
    watch_config=None,
    device: str = DEFAULT_DEVICE, mesh=None,
) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """In-process server for tests (the §4 'multi-node without a cluster'
    pattern: integration_test.go:77-103 binds a real server on a free port)."""
    httpd = make_http_server(
        addr, cache, token, db_dir,
        serve_config=serve_config,
        secret_engine_factory=secret_engine_factory,
        secret_config=secret_config,
        rules_cache_dir=rules_cache_dir,
        profile_dir=profile_dir,
        slo_config=slo_config,
        flight_out=flight_out,
        result_cache=result_cache,
        fleet_config=fleet_config,
        fleet_member=fleet_member,
        watch_config=watch_config,
        device=device,
        mesh=mesh,
    )
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t
