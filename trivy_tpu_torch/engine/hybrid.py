"""Hybrid secret engine: native host pre-sieve -> verify -> exact confirm.

The port of `trivy_tpu/engine/hybrid.py`, the engine `trivy fs` reaches by
default (`make_secret_engine(backend="auto")`).  The device link is the
scarce resource, so the sieve runs where the bytes already live:

  1. HOST: the C fused scan (`native/gram_scan.cpp` `gram_sieve_scan_files`)
     folds each chunk's file buffers into one stream, screens it, confirms
     each hit against its probe's class sequence and resolves the candidate
     (file, rule, first, last) quads at file close.  Chunks run through
     `ChunkPipeline` on a thread pool: the ctypes call drops the GIL, so the
     sieve of chunk N+1 overlaps the verify and confirm of chunk N.
  2. VERIFY, per lane: the host claim-killer's C walk (`DfaVerifier`) for
     lanes that must stay on the host, and the device NFA verify
     (`engine/nfa_device.py` `GpuNfaVerifier`, kernels K5/K5v/K6) for the
     device-eligible lanes of the whole batch, in one pass after the chunk
     pipeline.  `verify` picks: "dfa", "device" (legacy flag-map stream),
     "fused" (verdicts on the device, one keep bit a lane), "none", or
     "auto", which prices the link (`gate_terms`) on a CUDA device and takes
     "dfa" on the CPU.
  3. HOST: the oracle confirms the surviving (file, rule) sets byte-exactly,
     so findings equal the reference's by construction.

The sieve is the host's: this engine builds, stages and launches none of
the sieve kernels K1-K4.  Unlike the reference, it raises where the
reference falls back quietly: a device verifier that cannot be built under
`auto`, and a native library that does not build.

With a `program_table` the engine scans as the reference's does, whose
hybrid inherits the all-device engine's program demux with the native
sieve: the C++ row sieve over `pack_dense` rows, the host derive, the host
DFA claim-killer on the opted-in columns, the programs' resolves.  The
chunked pre-sieve and the device NFA verify never run then.  The port
composes: the demux is a `GpuSecretEngine(sieve="native")` over the merged
ruleset that shares this engine's stats.

With a mesh (`mesh=`, else `topology.engine_mesh`'s) the device verify splits
each dispatch's groups over the lanes (`GpuNfaVerifier(mesh=)`), and the
gate prices the reference's "mesh" profile at the mesh's count of DISTINCT
devices: lanes that split one card share its one link, so such a split
prices as "fused" at one device.
"""

from __future__ import annotations

import contextvars
import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from trivy_tpu_torch import deadline, lockcheck
from trivy_tpu_torch.compiled import CompiledRules
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine import link as link_mod
from trivy_tpu_torch.engine.device import GpuSecretEngine, SieveStats
from trivy_tpu_torch.engine.grams import build_gram_set, fold_members
from trivy_tpu_torch.engine.nfa_device import GpuNfaVerifier
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.engine.pipeline import ChunkPipeline, default_depth
from trivy_tpu_torch.engine.probes import build_probe_set
from trivy_tpu_torch.engine.redfa import DfaVerifier, compute_prefix_bounds
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.native import load_native
from trivy_tpu_torch.obs import gatelog
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.registry.store import CompiledArtifact
from trivy_tpu_torch.rules.model import RuleSet, SecretConfig, build_ruleset
from trivy_tpu_torch.scanner.packing import dedupe_blobs

# Shared empty result for non-candidate files: read only, never mutated.
_EMPTY_SECRET = Secret()

DEFAULT_CHUNK_BYTES = 32 << 20
GAP = 4  # zero bytes between files: no 4-byte window spans two files

VERIFY_MODES = ("auto", "dfa", "none", "device", "fused")

# Process-wide link measurements, one per TRIVY_TPU_LINK value (and device
# for a real probe), so engines built again never re-measure the link.
_LINK_PROBE_LOCK = lockcheck.make_lock("engine.hybrid.link_probe")
_LINK_PROBE: dict[str, tuple[float, float]] = {}  # owner: _LINK_PROBE_LOCK


def probe_link(device: str | torch.device = DEFAULT_DEVICE, size: int = 8 << 20,
               attempts: int = 3) -> tuple[float, float]:
    """(MB/s, round-trip s) of the host-to-`device` link, measured once per
    process as the best of `attempts` copies of `size` incompressible bytes
    to the device and back of one byte, less the best round trip of an
    8-byte copy.  TRIVY_TPU_LINK=wide|relay overrides with the reference's
    figures (tests, known deployments).  A failed probe raises."""
    override = os.environ.get("TRIVY_TPU_LINK", "")
    if override in ("wide", "relay"):
        key = override
    else:
        device = resolve_device(device)
        key = f"{override}@{device}"
    with _LINK_PROBE_LOCK:
        cached = _LINK_PROBE.get(key)
        if cached is not None:
            return cached
        if override == "wide":
            result = (10_000.0, 1e-4)
        elif override == "relay":
            result = (50.0, 0.1)
        else:
            buf = torch.from_numpy(
                np.random.default_rng(0).integers(0, 256, size=size, dtype=np.uint8)
            )
            buf[:8].to(device)[:1].cpu()  # wake the path
            best_dt = best_rtt = float("inf")
            for _ in range(attempts):
                t0 = time.perf_counter()
                buf.to(device)[:1].cpu()
                best_dt = min(best_dt, time.perf_counter() - t0)
                t0 = time.perf_counter()
                buf[:8].to(device)[:1].cpu()
                best_rtt = min(best_rtt, time.perf_counter() - t0)
            result = (size / max(best_dt - best_rtt, 1e-6) / 1e6, best_rtt)
        _LINK_PROBE[key] = result
        return result


# The reference's gate constants, unchanged (priced on its TPU links):
# effective post-codec rate and dispatch RTT the link must clear before
# verify goes to the device; the fused path's looser RTT bar (O(1)
# dispatches a batch); the megakernel's measured exec-rate floor.
GATE_EFF_MB_S = 1000.0
GATE_RTT_S = 0.01
FUSED_GATE_RTT_S = 0.25
MEGA_GATE_EXEC_MB_S = 500.0


def gate_terms(
    h2d_ratio: float = 1.0, d2h_ratio: float = 1.0,
    profile: str = "stream", devices: int = 1,
    exec_mb_s: float | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict:
    """Measure the link (`probe_link`) and price it against the device
    bar; returns every term of the decision (the gate log's record body).

    `profile`: "stream" (every verify byte crosses the link, d2h at the
    compaction ratio), "fused" (rows stay resident: zero re-upload and the
    FUSED_GATE_RTT_S bar), "mesh" (the fused model at `devices` cards) or
    "mega" (the fused model at `devices` cards plus the measured
    `exec_mb_s` against MEGA_GATE_EXEC_MB_S).  `margin` is the signed
    distance from the flip point, the worst term as a fraction of its
    threshold; positive = cleared."""
    mb_s, rtt = probe_link(device)
    devices = max(int(devices), 1)
    fused_model = profile in ("fused", "mesh", "mega")
    reupload = link_mod.FUSED_REUPLOAD_RATIO if fused_model else 1.0
    rtt_bar = FUSED_GATE_RTT_S if fused_model else GATE_RTT_S
    eff = link_mod.effective_link_rate(mb_s, h2d_ratio, d2h_ratio, reupload_ratio=reupload)
    if profile in ("mesh", "mega"):
        eff *= devices
    wide = eff >= GATE_EFF_MB_S and rtt < rtt_bar
    margin = min(eff / GATE_EFF_MB_S - 1.0, 1.0 - rtt / rtt_bar)
    out = {
        "profile": profile,
        "devices": devices,
        "link_mb_per_sec": mb_s,
        "link_rtt_s": rtt,
        "h2d_ratio": h2d_ratio,
        "d2h_ratio": d2h_ratio,
        "eff_mb_per_sec": eff,
        "eff_threshold_mb_per_sec": GATE_EFF_MB_S,
        "rtt_threshold_s": rtt_bar,
        "codec": link_mod.codec_mode(),
        "wide": wide,
        "margin": margin,
    }
    if profile == "mega" and exec_mb_s is not None:
        out["exec_mb_per_sec"] = exec_mb_s
        out["exec_threshold_mb_per_sec"] = MEGA_GATE_EXEC_MB_S
        out["wide"] = wide and exec_mb_s >= MEGA_GATE_EXEC_MB_S
        out["margin"] = min(margin, exec_mb_s / MEGA_GATE_EXEC_MB_S - 1.0)
    return out


def record_gate(requested: str, backend: str, reason: str, terms: dict) -> dict:
    """Record a priced decision in the gate log with every link term."""
    return gatelog.record(
        requested=requested, backend=backend, reason=reason,
        profile=terms["profile"], devices=terms["devices"],
        link_mb_per_sec=terms["link_mb_per_sec"], link_rtt_s=terms["link_rtt_s"],
        h2d_ratio=terms["h2d_ratio"], d2h_ratio=terms["d2h_ratio"],
        eff_mb_per_sec=terms["eff_mb_per_sec"],
        eff_threshold_mb_per_sec=terms["eff_threshold_mb_per_sec"],
        rtt_threshold_s=terms["rtt_threshold_s"],
        codec=terms["codec"], margin=terms["margin"],
    )


def _link_is_wide(h2d_ratio: float = 1.0, d2h_ratio: float = 1.0,
                  device: str | torch.device = DEFAULT_DEVICE) -> bool:
    """Whether the link clears the legacy stream's device-verify bar."""
    return gate_terms(h2d_ratio, d2h_ratio, device=device)["wide"]


def normalize_grams(
    masks: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Strip leading masked-out bytes so byte 0 of every gram is kept, then
    sort by (mask, val) so mask groups are contiguous.  Returns (norm_masks,
    norm_vals, perm, strip): perm maps sorted-normalized index -> original
    gram index, strip[k] is the stripped prefix length of gram k (the C
    scan's probe-class confirm adds it to the gram's alignment)."""
    g = len(masks)
    if g == 0:
        return masks, vals, np.zeros(0, dtype=np.int64), np.zeros(0, np.int32)
    nm = masks.astype(np.uint64).copy()
    nv = vals.astype(np.uint64).copy()
    strip = np.zeros(g, dtype=np.int32)
    for _ in range(3):
        shift = (nm != 0) & (nm & 0xFF == 0)
        nm[shift] >>= np.uint64(8)
        nv[shift] >>= np.uint64(8)
        strip[shift] += 1
    nm = nm.astype(np.uint32)
    nv = nv.astype(np.uint32)
    perm = np.lexsort((nv, nm)).astype(np.int64)
    return nm[perm], nv[perm], perm, strip[perm]


class GpuHybridSecretEngine:
    """Host-sieve + verify + confirm engine with the oracle's semantics.

    `device` is where the device verify runs (default "cuda"; "cpu" runs
    the kernels' plain versions).  `compiled` takes a registry
    `CompiledArtifact` (a warm start: the probe set, gram set, rule stack and
    digest come from it, and nothing is compiled), a `CompiledRules` or the
    reference's arrays (`CompiledRules.from_numpy`); it must be compiled
    from `ruleset`.  `rule_stack` takes `build_rule_stack`'s `vstack_*`
    arrays to seed the verifier (default: the artifact's).  `aot_cache_dir`
    is the executable cache the native library and the verify kernels load
    from (default `TRIVY_TPU_AOT_CACHE`, else `trivy_tpu_torch/_build/`).
    `program_table` (whose merged ruleset is `ruleset`) makes it
    multi-program: `scan_programs`, `programs_snapshot`, and `scan_batch`
    through the secret program (module docstring).  `mesh` (a `Mesh` whose
    first lane is `device`, or a list of devices; default
    `topology.engine_mesh`'s) is the device verify's (module docstring).
    `resident_chunks` is the resident-chunk capacity of the program engine
    it composes (the reference hands it to its device-engine base)."""

    def __init__(
        self,
        ruleset: RuleSet | None = None,
        config: SecretConfig | None = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        verify: str = "auto",
        probe_confirm: bool = True,
        pipeline_depth: int | None = None,
        dedupe: bool = True,
        compiled: CompiledArtifact | CompiledRules | dict | None = None,
        rule_stack: dict | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
        program_table=None,
        aot_cache_dir: str | None = None,
        mesh=None,
        resident_chunks: int | None = None,
    ):
        if verify not in VERIFY_MODES:
            raise ValueError(f"unknown verify mode: {verify!r}")
        self.device = resolve_device(device)
        # One mesh for the whole device path: the verifier joins it.
        self.mesh = mesh_topology.engine_mesh(self.device, mesh)
        self.ruleset = ruleset if ruleset is not None else build_ruleset(config)
        self.oracle = OracleScanner(self.ruleset)
        self.aot_cache_dir = aot_cache_dir
        self._ruleset_digest: str | None = None
        if isinstance(compiled, CompiledArtifact):
            # warm start: the artifact was digest-matched to this ruleset
            self.pset, self.gset = compiled.pset, compiled.gset
            self._ruleset_digest = compiled.digest
            if rule_stack is None:
                rule_stack = compiled.vstack
            compiled = CompiledRules.from_artifact(compiled)
        else:
            self.pset = build_probe_set(self.ruleset.rules)
            self.gset = build_gram_set(self.pset)
        if compiled is None:
            compiled = CompiledRules.from_sets(self.pset, self.gset)
        elif isinstance(compiled, dict):
            compiled = CompiledRules.from_numpy(compiled)
        if not (np.array_equal(compiled.masks, self.gset.masks)
                and np.array_equal(compiled.vals, self.gset.vals)):
            raise ValueError("compiled rules do not belong to this ruleset")
        self.compiled = compiled
        self.chunk_bytes = chunk_bytes
        self.stats = SieveStats()
        self.pipeline_depth = (
            pipeline_depth if pipeline_depth is not None else default_depth()
        )
        self.dedupe = dedupe
        self.verify, self.gate_decision = self._resolve_verify(verify)
        self._nfa_verifier: GpuNfaVerifier | None = None
        self._dfa_verifier: DfaVerifier | None = None
        if self.verify in ("dfa", "device", "fused"):
            # One trim-bound array: host and device verifiers must clip
            # walk windows alike for refutation to stay sound.
            bounds = compute_prefix_bounds(self.ruleset.rules, self._trimmable_rules())
            if self.verify in ("device", "fused"):
                self._nfa_verifier = GpuNfaVerifier(
                    self.ruleset.rules, prefix_bounds=bounds,
                    fused=self.verify == "fused", rule_stack=rule_stack,
                    device=self.device, mesh=self.mesh or [self.device],
                )
            # In device modes the DFA still verifies the lanes the device
            # does not take (no 64-position automaton, oversize windows).
            self._dfa_verifier = DfaVerifier(self.ruleset.rules, prefix_bounds=bounds)
        load_native(aot_cache_dir)  # raises with g++'s output when it does not build
        (self._norm_masks, self._norm_vals, self._norm_perm,
         self._norm_strip) = normalize_grams(self.gset.masks, self.gset.vals)
        self.probe_confirm = probe_confirm
        # Rules that are candidates with zero gram hits (all their gating
        # probes are gram-less), resolved once on an all-zero row.
        zero = np.zeros((1, self.gset.num_grams), dtype=bool)
        base = self.compiled.candidate_matrix_bool(self.gset.probe_hits_bool(zero))[0]
        self._base_cand = np.flatnonzero(base)
        self._build_scan_tables()
        self.program_table = program_table
        self._programs: GpuSecretEngine | None = None
        if program_table is not None:
            self._programs = GpuSecretEngine(
                ruleset=self.ruleset, compiled=compiled, device=self.device,
                sieve="native", pipeline_depth=self.pipeline_depth, dedupe=dedupe,
                resident_chunks=resident_chunks,
                program_table=program_table, aot_cache_dir=aot_cache_dir,
                mesh=self.mesh or [self.device],
            )
            self._programs.stats = self.stats

    @property
    def ruleset_digest(self) -> str:
        """Content digest of the active rule material (registry/digest.py):
        a warm-start artifact's, else computed on first use."""
        if self._ruleset_digest is None:
            from trivy_tpu_torch.registry.digest import ruleset_digest

            self._ruleset_digest = ruleset_digest(self.ruleset)
        return self._ruleset_digest

    @property
    def program_stats(self) -> dict:
        return self._programs.program_stats if self._programs is not None else {}

    def scan_programs(self, items: list[tuple[str, bytes]],
                      only: tuple[str, ...] | None = None) -> dict[str, list]:
        """One native-sieve pass, per-program verdicts
        (`GpuSecretEngine.scan_programs`)."""
        if self._programs is None:
            raise RuntimeError(
                "scan_programs needs an engine built with a program_table "
                "(programs.make_program_engine)")
        return self._programs.scan_programs(items, only)

    def programs_snapshot(self) -> dict:
        if self._programs is None:
            return {"enabled": False}
        return self._programs.programs_snapshot()

    def verify_devices(self) -> int:
        """The device count the gate prices: the mesh's distinct devices,
        else `capacity_hint()`."""
        if self.mesh is not None:
            return mesh_topology.distinct_device_count(self.mesh)
        return mesh_topology.capacity_hint()

    def _resolve_verify(self, verify: str) -> tuple[str, dict]:
        """(verify mode, gate log record).  `auto` on a CUDA device prices
        the "mesh" profile at `verify_devices()` when that is more than one
        device, else the fused profile, then the legacy stream, then falls
        to the host DFA; on the CPU it takes the DFA (reason `no-device`)."""
        if verify != "auto":
            return verify, gatelog.record(requested=verify, backend=verify, reason="forced")
        if self.device.type != "cuda":
            return "dfa", gatelog.record(requested="auto", backend="dfa",
                                         reason="no-device")
        n_dev = self.verify_devices()
        terms = gate_terms(d2h_ratio=link_mod.FUSED_MASK_D2H_RATIO,
                           profile="mesh" if n_dev > 1 else "fused", devices=n_dev,
                           device=self.device)
        if terms["wide"]:
            verify = "fused"
        else:
            d2h_ratio = (link_mod.STREAM_D2H_RATIO
                         if link_mod.d2h_compaction_enabled() else 1.0)
            terms = gate_terms(d2h_ratio=d2h_ratio, device=self.device)
            verify = "device" if terms["wide"] else "dfa"
        if terms["wide"] and terms["profile"] == "mesh":
            reason = "mesh-wide"
        else:
            reason = "link-wide" if terms["wide"] else "link-narrow"
        return verify, record_gate("auto", verify, reason, terms)

    def _build_scan_tables(self) -> None:
        """Flat CSR tables for the fused C scan (gram_sieve_scan_files)."""
        self._gw_norm = np.ascontiguousarray(
            self.gset.gram_window[self._norm_perm], dtype=np.int32
        )
        self._window_probe_i32 = np.ascontiguousarray(self.gset.window_probe,
                                                      dtype=np.int32)
        self._probe_n_windows = np.bincount(
            self.gset.window_probe, minlength=len(self.pset.probes)
        ).astype(np.int32)
        gate_ptr, gate_probes = [0], []
        rule_conj_ptr, conj_ptr, conj_probes = [0], [0], []
        for plan in self.pset.plans:
            gate_probes.extend(plan.gate_probe_ids)
            gate_ptr.append(len(gate_probes))
            for conj in plan.anchor_conjuncts:
                conj_probes.extend(conj)
                conj_ptr.append(len(conj_probes))
            rule_conj_ptr.append(len(conj_ptr) - 1)
        self._gate_ptr = np.array(gate_ptr, dtype=np.int32)
        self._gate_probes = np.array(gate_probes, dtype=np.int32)
        self._rule_conj_ptr = np.array(rule_conj_ptr, dtype=np.int32)
        self._conj_ptr = np.array(conj_ptr, dtype=np.int32)
        self._conj_probes = np.array(conj_probes, dtype=np.int32)
        self._build_confirm_tables()

    def _build_confirm_tables(self) -> None:
        """Per-hit probe-class confirm tables (gram_scan.cpp confirm_hit):
        each gram carries its probe's full class sequence as case-folded
        256-bit membership bitmaps plus the gram anchor's offset in it, so
        the C scan rejects screen hits whose surrounding bytes break the
        sequence."""
        g = len(self._norm_perm)
        self._gram_cls_start = np.zeros(g, dtype=np.int32)
        self._gram_cls_len = np.zeros(g, dtype=np.int32)
        self._gram_align = np.zeros(g, dtype=np.int32)
        self._cls_blob = np.zeros(0, dtype=np.uint8)
        if not self.probe_confirm:
            return
        p_count = len(self.pset.probes)
        cls_off = np.zeros(p_count, dtype=np.int32)
        cls_len = np.zeros(p_count, dtype=np.int32)
        blobs: list[np.ndarray] = []
        total = 0
        need = {int(self.gset.window_probe[self.gset.gram_window[orig]])
                for orig in self._norm_perm}
        for p in range(p_count):
            if p not in need:
                continue
            classes = self.pset.probes[p].classes
            cls_off[p] = total
            cls_len[p] = len(classes)
            bmap = np.zeros((len(classes), 32), dtype=np.uint8)
            for j, bs in enumerate(classes):
                for fb in fold_members(bs):
                    bmap[j, fb >> 3] |= 1 << (fb & 7)
            blobs.append(bmap.reshape(-1))
            total += len(classes)
        if blobs:
            self._cls_blob = np.concatenate(blobs)
        for k, orig in enumerate(self._norm_perm):
            w = int(self.gset.gram_window[orig])
            p = int(self.gset.window_probe[w])
            self._gram_cls_start[k] = cls_off[p]
            self._gram_cls_len[k] = cls_len[p]
            self._gram_align[k] = int(self.gset.window_start[w]) + int(self._norm_strip[k])

    def _trimmable_rules(self) -> np.ndarray:
        """bool[R]: the rule has an anchor conjunct whose probes all have
        grams, so every match holds a gram occurrence and the verify walk
        may be trimmed around the hits."""
        has_gram = self.gset.probe_has_gram
        return np.array([
            any(conj and all(has_gram[p] for p in conj) for conj in plan.anchor_conjuncts)
            for plan in self.pset.plans
        ], dtype=bool)

    def warmup(self) -> None:
        """Build the native library and the device verifier's resident
        tensors (and, on a card, load its kernels) ahead of timed scans."""
        load_native(self.aot_cache_dir)
        if self._nfa_verifier is not None:
            self._nfa_verifier.warmup(self.aot_cache_dir)
        if self._programs is not None:
            self._programs.warmup()

    # ------------------------------------------------------------------

    def _sieve_chunk(self, contents: list[bytes]):
        """The fused C scan over one chunk's file buffers (runs on a pool
        worker).  Returns (pairs [N, 4] int32 (file, rule, first_hint,
        last_hint) ordered by file then rule, device-eligible mask, the
        pointer array and lengths the verify walks, (pack_s, sieve_s)):
        timings return as data, since two workers adding to the stats would
        lose updates."""
        t0 = time.perf_counter()
        nfiles = len(contents)
        lens = np.fromiter((len(c) for c in contents), dtype=np.int64, count=nfiles)
        # Pointers straight at the bytes objects (no copy; `contents` stays
        # referenced while both C calls run).
        ptr_arr = (ctypes.c_char_p * nfiles)(*contents)
        starts = np.zeros(nfiles, dtype=np.int64)  # filled by the C scan
        pack_dt = time.perf_counter() - t0

        t0 = time.perf_counter()
        lib = load_native()
        cap = max(1024, 4 * nfiles)
        while True:
            out = np.empty((cap, 4), dtype=np.int32)
            found = lib.gram_sieve_scan_files(
                ctypes.cast(ptr_arr, ctypes.c_void_p),
                lens.ctypes.data, nfiles,
                self._norm_masks.ctypes.data, self._norm_vals.ctypes.data,
                len(self._norm_masks),
                self._gw_norm.ctypes.data, len(self._window_probe_i32),
                self._window_probe_i32.ctypes.data,
                self._probe_n_windows.ctypes.data, len(self._probe_n_windows),
                self._gate_ptr.ctypes.data, self._gate_probes.ctypes.data,
                self._rule_conj_ptr.ctypes.data, self._conj_ptr.ctypes.data,
                self._conj_probes.ctypes.data, len(self.pset.plans),
                self._cls_blob.ctypes.data if self.probe_confirm else None,
                self._gram_cls_start.ctypes.data,
                self._gram_cls_len.ctypes.data,
                self._gram_align.ctypes.data,
                starts.ctypes.data,
                out.ctypes.data, cap,
            )
            if found <= cap:
                break
            cap = int(found) + 64
        sieve_dt = time.perf_counter() - t0
        pairs = out[: int(found)]
        dev = (
            self._nfa_verifier.device_eligible(pairs, lens)
            if self._nfa_verifier is not None
            else np.zeros(len(pairs), dtype=bool)
        )
        return pairs, dev, ptr_arr, lens, (pack_dt, sieve_dt)

    def _chunks(self, items: list[tuple[str, bytes]]) -> list[tuple[int, int]]:
        """Contiguous item ranges of ~chunk_bytes each."""
        out: list[tuple[int, int]] = []
        start, size = 0, 0
        for i, (_p, c) in enumerate(items):
            size += len(c) + GAP
            if size >= self.chunk_bytes and i + 1 > start:
                out.append((start, i + 1))
                start, size = i + 1, 0
        if start < len(items):
            out.append((start, len(items)))
        return out

    def scan_batch(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """Scan (path, content) blobs; returns per-file Secret results."""
        if self._programs is not None:
            return self._programs.scan_batch(items)
        if not items:
            return []
        self.stats.files += len(items)
        self.stats.bytes += sum(len(c) for _, c in items)
        gd = self.gate_decision
        if obs_trace.enabled():
            # the gate's verdict on this batch's span tree
            with obs_trace.span("hybrid.gate", backend=gd["backend"],
                                reason=gd["reason"], margin=gd.get("margin")):
                pass

        results: list[Secret | None] = [None] * len(items)
        spans = self._chunks(items)
        t0 = time.perf_counter()
        allowed_pos = np.flatnonzero(np.fromiter(
            (self.ruleset.allow_path(p) for p, _ in items), dtype=bool, count=len(items)
        ))
        self.stats.confirm_s += time.perf_counter() - t0
        self.stats.pipeline_depth = self.pipeline_depth
        # Up to pipeline_depth sieve chunks in flight on the pool while this
        # thread finishes chunk N (the CUDA work stays on this thread).
        # Device-destined lanes gather across chunks ([N, 5] blocks: global
        # file, rule, first, last, preverified) and verify in ONE pass after
        # the pipeline, so dispatches stay O(tiers), not O(chunks).
        dev_lanes: list[np.ndarray] = []
        pool = ThreadPoolExecutor(max_workers=max(1, self.pipeline_depth - 1))

        def _finish(span, fut):
            deadline.check()
            pairs, dev, ptr_arr, lens, (pack_dt, sieve_dt) = fut.result()
            self.stats.pack_s += pack_dt
            self.stats.sieve_s += sieve_dt
            self._finish_chunk(items, span[0], span[1], (pairs, dev, ptr_arr, lens),
                               results, allowed_pos, dev_lanes)

        def _sieve_traced(contents):
            with obs_trace.span("sieve", files=len(contents),
                                bytes=sum(len(c) for c in contents)):
                return self._sieve_chunk(contents)

        pipe = ChunkPipeline(
            # copy_context: worker-side sieve spans join the batch's tree
            stage=lambda span: pool.submit(
                contextvars.copy_context().run, _sieve_traced,
                [c for _p, c in items[span[0] : span[1]]],
            ),
            execute=lambda span, fut: fut,
            finish=_finish,
            depth=self.pipeline_depth,
            cancel=lambda span, fut: fut.cancel(),
        )
        try:
            pipe.run(spans)
        finally:
            pool.shutdown(wait=True)
        self.stats.h2d_overlap_s += pipe.stats.h2d_overlap_s
        if dev_lanes:
            deadline.check()
            self._finish_device(items, np.concatenate(dev_lanes), results)
        return results  # type: ignore[return-value]

    def scan(self, file_path: str, content: bytes) -> Secret:
        """One file as a one-item batch: the reference hybrid inherits this
        from its device-engine base (`GpuSecretEngine.scan` here); the
        image config's secret scan calls it."""
        return self.scan_batch([(file_path, content)])[0]

    def scan_batch_host(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """Re-run with the device verifier out of the loop: every lane
        verifies on the host DFA (byte-identical: both verifiers clip alike
        and the confirm is exact).  Owner thread only: the verifier swap is
        not safe against a concurrent scan_batch on the same engine."""
        nfa = self._nfa_verifier
        if nfa is None:
            return self.scan_batch(items)
        self._nfa_verifier = None
        try:
            return self.scan_batch(items)
        finally:
            self._nfa_verifier = nfa

    def scan_batch_device_legacy(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """Re-run one rung above `scan_batch_host`: the device verifier
        stays, its fused mode off, so verdicts resolve through the legacy
        flag-map stream.  Owner thread only, like `scan_batch_host`."""
        nfa = self._nfa_verifier
        if nfa is None or not nfa.fused:
            return self.scan_batch(items)
        nfa.fused = False
        try:
            return self.scan_batch(items)
        finally:
            nfa.fused = True

    def _finish_chunk(self, items, lo, hi, sieved, results, allowed_pos, dev_lanes) -> None:
        scan_pairs, dev_mask, ptr_arr, lens = sieved
        host = ~dev_mask
        if self._dfa_verifier is not None and host.any():
            # Host automaton verify over the chunk's original buffers; with
            # a device verifier, only the lanes it does not take walk here.
            t0 = time.perf_counter()
            with obs_trace.span("verify", pairs=int(host.sum())):
                sub = scan_pairs[host]
                ok = self._dfa_verifier.verify_pairs_files(
                    ptr_arr, lens, sub[:, 0], sub[:, 1], sub[:, 2], sub[:, 3],
                )
                keep = np.ones(len(scan_pairs), dtype=bool)
                keep[host] = ok.astype(bool)
                scan_pairs, dev_mask = scan_pairs[keep], dev_mask[keep]
            self.stats.verify_s += time.perf_counter() - t0
        dev_files: set[int] = set()
        if dev_mask.any():
            # Files with a device-destined lane defer to the end-of-scan
            # device pass; their host-verified lanes travel along as
            # preverified so the confirm sees the union.
            dev_files = set(scan_pairs[dev_mask, 0].tolist())
            sel = np.isin(scan_pairs[:, 0], np.fromiter(dev_files, np.int32))
            block = np.empty((int(sel.sum()), 5), dtype=np.int64)
            block[:, :4] = scan_pairs[sel]
            block[:, 0] += lo  # global file index
            block[:, 4] = ~dev_mask[sel]  # host-verified already
            dev_lanes.append(block)
            scan_pairs = scan_pairs[~sel]

        t0 = time.perf_counter()
        cand_rows: dict[int, np.ndarray] = {}
        if len(scan_pairs):
            fis, ris = scan_pairs[:, 0], scan_pairs[:, 1]
            splits = np.flatnonzero(fis[1:] != fis[:-1]) + 1
            for fi, idxs in zip(fis[np.r_[0, splits]], np.split(ris, splits)):
                cand_rows[int(fi)] = idxs
        self.stats.candidate_s += time.perf_counter() - t0

        base = self._base_cand
        if len(base):
            # Gram-less rules are candidates everywhere; deferred files get
            # them as preverified lanes instead.
            pairs = []
            for fi in range(hi - lo):
                if fi in dev_files:
                    block = np.empty((len(base), 5), dtype=np.int64)
                    block[:, 0] = lo + fi
                    block[:, 1] = base
                    block[:, 2:4] = 0
                    block[:, 4] = 1
                    dev_lanes.append(block)
                    continue
                pairs.append((fi, np.union1d(cand_rows[fi], base)
                              if fi in cand_rows else base))
        else:
            pairs = list(cand_rows.items())

        t0 = time.perf_counter()
        # Non-candidate files share one empty result; allowed paths carry
        # their FilePath (scanner.go:375-380), and the oracle reproduces it
        # for allowed candidates.
        with obs_trace.span("confirm", files=hi - lo):
            results[lo:hi] = [_EMPTY_SECRET] * (hi - lo)
            a0, a1 = np.searchsorted(allowed_pos, (lo, hi))
            for i in allowed_pos[a0:a1].tolist():
                results[i] = Secret(file_path=items[i][0])
            for fi, idxs in pairs:
                self._confirm_file(items, lo + int(fi), idxs, results)
        self.stats.confirm_s += time.perf_counter() - t0

    def _confirm_file(self, items, gi: int, idxs, results) -> None:
        """Byte-exact oracle confirm of one file's candidate rules."""
        if len(idxs) == 0:
            return
        path, content = items[gi]
        self.stats.candidate_pairs += len(idxs)
        res = self.oracle.scan(path, content, rule_indices=list(map(int, idxs)))
        self.stats.confirmed_findings += len(res.findings)
        results[gi] = res

    def _finish_device(self, items, lanes: np.ndarray, results: list) -> None:
        """End-of-scan device verify: one batched pass over every deferred
        lane ([N, 5]: gfile, rule, first, last, preverified), then the
        confirm of the surviving (file, rule) sets."""
        t0 = time.perf_counter()
        unver = lanes[lanes[:, 4] == 0]
        # Lanes of one file share one contents entry (its span ships once),
        # and content-digest dedupe collapses identical files to one blob:
        # verdicts depend on content only.
        ufiles, inv = np.unique(unver[:, 0], return_inverse=True)
        contents = [items[int(g)][1] for g in ufiles]
        if self.dedupe and len(contents) > 1:
            td = time.perf_counter()
            dd = dedupe_blobs(contents)
            if dd.any_duplicates():
                self.stats.dedupe_saved_bytes += dd.saved_bytes
                contents = [contents[int(i)] for i in dd.unique_index]
                inv = dd.inverse[inv]
            self.stats.dedupe_s += time.perf_counter() - td
        lens = np.fromiter((len(c) for c in contents), dtype=np.int64, count=len(contents))
        sub = unver[:, :4].copy()
        sub[:, 0] = inv
        with obs_trace.span("verify", pairs=len(unver), device=True):
            ok = self._nfa_verifier.verify_lanes(contents, sub, lens)
        self.stats.device_pairs += len(unver)
        surviving = np.concatenate([lanes[lanes[:, 4] == 1][:, :2], unver[ok][:, :2]])
        self.stats.verify_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        with obs_trace.span("confirm", lanes=len(surviving)):
            surviving = surviving[np.lexsort((surviving[:, 1], surviving[:, 0]))]
            if len(surviving):
                fis = surviving[:, 0]
                splits = np.flatnonzero(fis[1:] != fis[:-1]) + 1
                for gi, idxs in zip(fis[np.r_[0, splits]],
                                    np.split(surviving[:, 1], splits)):
                    self._confirm_file(items, int(gi), np.unique(idxs).tolist(), results)
        self.stats.confirm_s += time.perf_counter() - t0


def make_secret_engine(
    ruleset: RuleSet | None = None,
    config: SecretConfig | None = None,
    backend: str = "auto",
    device: str | torch.device = DEFAULT_DEVICE,
    mesh=None,
    rules_cache_dir: str | None = None,
    **kw,
):
    """Engine factory, the twin of the reference's.

    backend:
      auto    the hybrid engine (the native library must build: it raises
              where the reference would fall back to the device engine)
      hybrid  host pre-sieve + verify + confirm (`GpuHybridSecretEngine`)
      device  all bytes through the device sieve (`GpuSecretEngine`)
      native  the device engine over the C++ host row sieve
              (`GpuSecretEngine(sieve="native")`)
      oracle  the pure-Python reference engine
    Aliases: tpu = device, cpu = oracle.  A `program_table` kwarg makes the
    engine multi-program (`ruleset` must be its merged ruleset: use
    `programs.make_program_engine`); the oracle has no sieve to demux and
    refuses it.

    `rules_cache_dir` routes construction through the compiled-artifact
    registry (`registry/store.py`): a valid cached artifact supplies the
    tensors (a warm start, no compile), and a miss compiles once and
    persists for the next process.  None (the default) leaves the registry
    out.  `aot_cache_dir` (in `kw`) is the executable cache the engine's
    libraries load from.  `mesh` (a `mesh.topology.Mesh`, a list of devices,
    or None for `topology.engine_mesh`'s) is the device path's: the device
    engine's sieve and the hybrid's device verify split over its lanes; the
    oracle ignores it, as the reference's does."""
    backend = {"tpu": "device", "cpu": "oracle"}.get(backend, backend)
    if backend == "oracle":
        if kw.get("program_table") is not None:
            raise ValueError(
                "the oracle backend has no device pass to demux programs from")
        return OracleScanner(ruleset=ruleset, config=config)
    if rules_cache_dir is not None and "compiled" not in kw:
        from trivy_tpu_torch.registry.store import get_or_compile

        if ruleset is None:
            ruleset = build_ruleset(config)
        kw["compiled"], _ = get_or_compile(ruleset, cache_dir=rules_cache_dir)
    if backend in ("device", "native"):
        if backend == "native":
            kw["sieve"] = "native"
        return GpuSecretEngine(ruleset=ruleset, config=config, device=device, mesh=mesh,
                               **kw)
    if backend not in ("auto", "hybrid"):
        raise ValueError(f"unknown secret-engine backend: {backend!r}")
    return GpuHybridSecretEngine(ruleset=ruleset, config=config, device=device, mesh=mesh,
                                 **kw)
