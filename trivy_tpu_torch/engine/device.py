"""The GPU secret engine: device sieve -> candidates -> claim-killer -> exact
confirm.

The port of `trivy_tpu/engine/device.py` `TpuSecretEngine`, with its
`sieve`, `kernel` and `fused` choices:

* `sieve="gram"` (default): rows packed densely (`pack_dense`), encoded by
  the link codec, staged to the card and sieved there, by K1/K2
  (`kernel="pallas"`, the twin of the reference's Pallas kernels over
  distinct (mask, val) pairs; `kernel="auto"` takes it, `ops/gram_sieve.py`
  `GramSieve`) or by B5 (`kernel="xla"`, the twin of the reference's XLA
  program over the grams in their own order, `RowGramSieve`).
  - **fused** (`fused=True`, the default): a batch inside the single-call
    envelope (one row bucket, at most `MEGA_MAX_FILES` files) runs the
    **megakernel path** (K1's twin only, as in the reference): encode, H2D,
    one megakernel call (`ops/megakernel.py`: unpack, sieve, per-file
    counts, derive, packed verdict bits) and the fetch of the packed mask.
    Any other batch, or every batch with `megakernel=False`, runs the
    **staged fused path**: for each row-bucket chunk the rows go
    host-to-device from pinned buffers on a side stream, unpack and sieve
    there, and the hit words stay on the device (several chunks run through
    the chunk pipeline, `engine/pipeline.py`; each chunk's rows and hit
    words stay in the digest-keyed resident row store); the device derives
    the [files, rules] candidate matrix (`GpuSecretEngine.derive`) and only
    that matrix comes back, compacted (`engine/link.py`).
  - **unfused** (`fused=False`, or `TRIVY_TPU_SYNC_TIMING=1`): the hit words
    come back (compacted), a digest-keyed cache keeps them on the host, and
    the host derives the candidates (`DenseBatch.file_hits`,
    `probe_hits_bool`, `candidate_matrix_bool`).  Under
    `TRIVY_TPU_SYNC_TIMING=1` each dispatch synchronises after its H2D copy,
    splitting `SieveStats.h2d_s` from `exec_s`.
* `sieve="lut"`: files tiled on their own (`pack`, overlap max(16, Jmax)),
  the tiles sieved on the card by B6 (`ops/lut_sieve.py`, the packed
  shift-AND over `ProbeSet.build_lut`), the probe words fetched and the
  candidates resolved on the host (`candidate_matrix`).  No codec.
* `sieve="native"`: the C++ row sieve on the host (`native/gram_scan.cpp`
  `gram_sieve`), then the host derive; nothing runs on the card.

`fused` follows the reference's ladder: the argument, else
`TRIVY_TPU_FUSED` ("0" off, anything else on), else the device default,
which is on for every device here (the reference's is on only on its
accelerator; the port's CPU path is the plain twin of its card path).

Every path then runs the claim-killer: a C DFA / NFA-64 walk per candidate
(file, rule) pair (`engine/redfa.py`, `native/dfa_verify.cpp`) drops the
pairs the rule's automaton refutes, and the oracle confirms what is left
byte-exactly, so findings equal the reference engine's by construction.

Every stage sits inside the reference's spans (`obs/trace.py`: chunk.encode,
chunk.h2d, chunk.exec, sieve.megakernel, chunk.fetch, verify, confirm),
fenced device phases (`obs/metrics.py` `device_phase`) and fault seams
(`faults.py`: device.put, device.exec, device.fetch).

With a `program_table` (`programs/base.py`, built by
`programs.make_program_engine`) the rule axis is the table's merged one:
`scan_programs` runs the same pass once (dedupe, candidates, the
claim-killer on the columns of `verify=True` programs only) and hands each
program its slice of the candidate matrix, and `scan_batch` routes through
it for the secret program.  Its kernel libraries load through the
executable cache (`registry/aotcache.py`).

**Mesh** (`mesh=`, the reference's meshed branches; `mesh/`): a `Mesh` of
lanes, else the process mesh `topology.get_mesh()` when its first lane is
the engine's device (`topology.engine_mesh`; None on the CPU and on a
one-card host unless `TRIVY_TPU_MESH` asks).  Row buckets round up to
lanes (x K1's block rows), every chunk stages one shard a lane through
that lane's `RowStager` (`pipeline.stage_rows`, its memwatch entries held
until the chunk is done), and the sieve runs per shard: K1/K2 by
`make_sharded_pallas_sieve` (B1m, the codec's unpack shard-local), B5 by
`make_sharded_gram_sieve` (B5m), B6 by `make_sharded_sieve` (B6m), the
megakernel by `make_sharded_megakernel` (K3m: K4 a shard, counts summed,
one epilogue).  The fused derive reads every shard's hit words gathered in
row order on the engine's device (the first lane), so a file whose rows
straddle a shard boundary derives as unmeshed; fetched results are demuxed
lane by lane (`link._demux_shards`).  Resident entries carry the lane count
in their key.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import time

import numpy as np
import torch

from trivy_tpu_torch import faults
from trivy_tpu_torch.compiled import CompiledRules
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine import link as link_mod
from trivy_tpu_torch.engine.grams import build_gram_set
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.engine.pipeline import (
    ChunkPipeline,
    ResidentChunkCache,
    ResidentRowStore,
    chunk_digest,
    default_depth,
    lane_stagers,
    stage_rows,
    wait_staged,
)
from trivy_tpu_torch.engine.probes import build_probe_set
from trivy_tpu_torch.engine.redfa import DfaVerifier
from trivy_tpu_torch.engine.stats import SieveStats
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.mesh.plan import Sharded
from trivy_tpu_torch.native import gram_sieve_native, load_native
from trivy_tpu_torch.obs import memwatch
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.gram_sieve import (
    GramSieve,
    RowGramSieve,
    make_sharded_gram_sieve,
    make_sharded_pallas_sieve,
)
from trivy_tpu_torch.ops.lut_sieve import LutSieve, make_sharded_sieve
from trivy_tpu_torch.ops.megakernel import (
    MEGA_MAX_FILES,
    MegaGramSieve,
    make_sharded_megakernel,
)
from trivy_tpu_torch.registry.store import CompiledArtifact
from trivy_tpu_torch.rules.model import RuleSet, SecretConfig, build_ruleset
from trivy_tpu_torch.scanner.packing import (
    DEFAULT_OVERLAP,
    DEFAULT_TILE_LEN,
    DenseBatch,
    dedupe_blobs,
    pack,
    pack_dense,
)

# Row-batch shapes: every sieve call uses one of these row counts, and
# larger scans are chunked into top-bucket batches.  Kept from the reference
# for shape parity (B5 and B6 take TILE_BUCKETS, K1 TILE_BUCKETS_PALLAS);
# retune only from a measurement on the card.
TILE_BUCKETS = (512, 4096)
TILE_BUCKETS_PALLAS = (4096, 8192, 16384, 32768)
DEFAULT_MAX_BATCH_TILES = 4096

GRAM_OVERLAP = 3  # gram window (4) - 1

# The `SieveStats` counter of each stock program's resolve in `scan_programs`.
RESOLVE_COUNTERS = {"secret": "secret_resolve_s", "license": "license_resolve_s"}


def _sync_timing() -> bool:
    """TRIVY_TPU_SYNC_TIMING set: the forced-sync H2D/exec decomposition."""
    return bool(os.environ.get("TRIVY_TPU_SYNC_TIMING"))


class GpuSecretEngine:
    """Drop-in engine with the oracle's Scan semantics, on a CUDA card (or
    on the CPU when `device="cpu"`, through the kernels' plain versions).

    `sieve` ("gram", "lut", "native"), `kernel` ("auto" = "pallas", or
    "xla") and `fused` pick the path (module docstring).  `compiled` takes a
    registry `CompiledArtifact` (a warm start: the probe set, gram set, link
    alphabet and digest come from it, and nothing is compiled), a
    `CompiledRules` or the dict of arrays that `CompiledRules.from_numpy`
    reads; it must be compiled from `ruleset` (arrays of another ruleset
    are refused).  `aot_cache_dir` is the
    executable cache `warmup()` and `registry.store.aot_warmup` load the
    kernel libraries from (default `TRIVY_TPU_AOT_CACHE`, else
    `trivy_tpu_torch/_build/`).

    `megakernel` switches the megakernel path (fused K1-twin gram sieve
    only): the argument when given, else `TRIVY_TPU_MEGAKERNEL` ("0" off,
    anything else on), else on for a CUDA device and off on the CPU, as the
    reference's is on only on its accelerator.  It needs `tile_len` a power
    of two >= 256 and some gram.  In auto mode (neither given), `warmup()`
    then prices the reference's megakernel gate (`_price_mega_gate`,
    engine/link.py `gate_terms` profile "mega") and keeps the megakernel
    only when it clears the bar.

    `max_batch_tiles` caps the row buckets (default 4,096; 32,768 for
    K1 unless given).  `pipeline_depth` bounds the chunks in flight
    (default `default_depth()`, `TRIVY_TPU_PIPELINE_DEPTH`), `dedupe` scans
    each distinct blob once, and `resident_chunks` caps the resident row
    store and the host hit-word cache (default `TRIVY_TPU_RESIDENT_CHUNKS`,
    else 32; 0 turns residency off).

    `program_table` (a `ProgramTable` whose merged ruleset is `ruleset`)
    makes the engine multi-program: `scan_programs`, `programs_snapshot`.

    `mesh` (a `mesh.topology.Mesh` or a list of devices whose first is
    `device`; default `topology.engine_mesh`'s) runs the sieve over its lanes
    (module docstring)."""

    def __init__(
        self,
        ruleset: RuleSet | None = None,
        config: SecretConfig | None = None,
        tile_len: int = DEFAULT_TILE_LEN,
        max_batch_tiles: int | None = None,
        compiled: CompiledArtifact | CompiledRules | dict | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
        megakernel: bool | None = None,
        pipeline_depth: int | None = None,
        dedupe: bool = True,
        resident_chunks: int | None = None,
        sieve: str = "gram",
        kernel: str = "auto",
        fused: bool | None = None,
        program_table=None,
        aot_cache_dir: str | None = None,
        mesh=None,
    ):
        if sieve not in ("gram", "lut", "native"):
            raise ValueError(f"unknown sieve: {sieve}")
        if kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel: {kernel}")
        self.device = resolve_device(device)
        self.mesh = mesh_topology.engine_mesh(self.device, mesh)
        # Batches pad to lanes x bucket so every shard gets whole rows (the
        # K1 branch further multiplies by its block rows).
        self._tile_align = mesh_topology.mesh_device_count(self.mesh)
        # Resident keys carry the lane count: a meshed entry never aliases
        # an unmeshed one.
        self._mesh_tag = f":lanes{self.mesh.size}" if self.mesh is not None else ""
        self.ruleset = ruleset if ruleset is not None else build_ruleset(config)
        self.oracle = OracleScanner(self.ruleset)
        self.program_table = program_table
        self.program_stats: dict[str, dict] = {}
        self.aot_cache_dir = aot_cache_dir
        pset = None
        alphabet = None
        self._ruleset_digest: str | None = None
        if isinstance(compiled, CompiledArtifact):
            # warm start: the artifact was digest-matched to this ruleset
            pset, alphabet = compiled.pset, compiled.alphabet
            self._ruleset_digest = compiled.digest
            compiled = CompiledRules.from_artifact(compiled)
        else:
            pset = build_probe_set(self.ruleset.rules)
            compiled = CompiledRules.of(compiled, pset, build_gram_set(pset))
        self.compiled = compiled
        self.sieve = sieve
        self.kernel = "pallas" if kernel == "auto" else kernel
        self.tile_len = tile_len
        self.overlap = GRAM_OVERLAP
        self.stats = SieveStats()
        self.pipeline_depth = (
            pipeline_depth if pipeline_depth is not None else default_depth()
        )
        self.dedupe = dedupe
        self._resident = ResidentChunkCache(resident_chunks)
        self._row_store = ResidentRowStore(resident_chunks)
        self._stagers = lane_stagers(self.mesh, self.device, self.pipeline_depth)
        self._stager = self._stagers[0]
        self._verifier: DfaVerifier | None = None
        self._link = None
        self._codec_tag = ":raw"
        self._d2h_compact = False
        self._fused = False
        self._mega: MegaGramSieve | None = None
        self._mega_fn = None  # K3m, the meshed split (None: K3, `_mega`)
        self._mega_on = False
        self._mega_auto = False
        self._kernel_tag = ""
        self._sieve_fn = None
        self._pallas_obj: GramSieve | None = None
        self._tile_buckets = TILE_BUCKETS
        on_pallas = sieve == "gram" and self.kernel == "pallas"
        if max_batch_tiles is None:
            max_batch_tiles = TILE_BUCKETS_PALLAS[-1] if on_pallas else DEFAULT_MAX_BATCH_TILES
        self.max_batch_tiles = max_batch_tiles

        if sieve == "native":
            # the C++ row sieve on the host: no codec, no card
            return
        if sieve == "lut":
            # no transcoder (the LUT's byte semantics are the contract), but
            # the D2H compaction is lossless and applies
            if pset is None:
                pset = build_probe_set(self.ruleset.rules)
            self.pset = pset
            self._gate, self._gate_any, self._conj, self._conj_any = pset.gate_masks()
            self._d2h_compact = link_mod.d2h_compaction_enabled()
            self.overlap = max(DEFAULT_OVERLAP, pset.jmax)
            self._sieve_fn = LutSieve(pset.build_lut(), device=self.device)
            if self.mesh is not None:
                self._sieve_fn = make_sharded_sieve(self.mesh, self._sieve_fn)
            return

        mode = link_mod.codec_mode()
        self._d2h_compact = mode != "off"
        if mode != "off":
            if alphabet is None:
                alphabet = link_mod.derive_alphabet(compiled)
            self._link = link_mod.select_codec(alphabet, mode, compiled)
        # Resident-row keys carry the codec: coded rows never alias raw ones.
        if self._link is not None:
            self._codec_tag = ":" + self._link.codec_id
            cmasks, cvals = self._link.encode_grams(compiled.masks, compiled.vals)
        else:
            cmasks, cvals = compiled.masks, compiled.vals
        fenv = os.environ.get("TRIVY_TPU_FUSED", "")
        if fused is not None:
            self._fused = bool(fused)
        elif fenv:
            self._fused = fenv != "0"
        else:
            self._fused = True
        # the codec's unpack, shard-local under a mesh
        unpack = None
        if self._link is not None:
            unpack = lambda rows: self._link.unpack(rows, self.tile_len)  # noqa: E731
        if on_pallas:
            # K1/K2: words over distinct (mask, val) pairs, expanded back to
            # gram order by `gram_expand`
            self._pallas_obj = self._sieve_fn = GramSieve(cmasks, cvals, device=self.device)
            if self.mesh is not None:
                self._sieve_fn = make_sharded_pallas_sieve(self.mesh, self._pallas_obj,
                                                           pre=unpack)
                # every shard tiles into whole blocks
                self._tile_align *= self._pallas_obj.block_rows
            self._tile_buckets = TILE_BUCKETS_PALLAS
            expand = self._pallas_obj.gram_expand
            if not len(expand):
                expand = np.arange(self._pallas_obj.num_distinct)
        else:
            # B5: words over the grams in their own order, pad grams after
            self._sieve_fn = RowGramSieve(cmasks, cvals, device=self.device)
            if self.mesh is not None:
                self._sieve_fn = make_sharded_gram_sieve(self.mesh, self._sieve_fn, unpack)
            expand = np.arange(len(compiled.masks))

        def dev(a, dtype=torch.float32) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self._expand = dev(expand, torch.int64)
        self._wmember = dev(compiled.wmember)
        self._pmember = dev(compiled.pmember)
        self._pwindows = dev(compiled.pwindows)
        self._nogram = dev(~compiled.probe_has_gram, torch.bool)
        self._gate_member = dev(compiled.gate_member)
        self._gate_any = dev(compiled.gate_any, torch.bool)
        self._conj_member = dev(compiled.conj_member)
        self._conj_any = dev(compiled.conj_any, torch.bool)

        env = os.environ.get("TRIVY_TPU_MEGAKERNEL", "")
        # Auto mode only: warmup() prices the megakernel gate; an explicit
        # choice (argument or environment) is never second-guessed.
        self._mega_auto = megakernel is None and not env
        if megakernel is not None:
            want_mega = bool(megakernel)
        elif env:
            want_mega = env != "0"
        else:
            want_mega = self.device.type == "cuda"
        if (
            want_mega
            and on_pallas
            and self._fused
            and len(compiled.masks) > 0
            and tile_len >= 256
            and tile_len & (tile_len - 1) == 0
        ):
            self._mega = MegaGramSieve(
                cmasks, cvals,
                wmember=compiled.wmember,
                pmember=compiled.pmember,
                pwindows=compiled.pwindows,
                probe_has_gram=compiled.probe_has_gram,
                gate_member=compiled.gate_member,
                gate_any=compiled.gate_any,
                conj_member=compiled.conj_member,
                conj_any=compiled.conj_any,
                num_conjuncts=compiled.num_conjuncts,
                row_len=tile_len,
                sym_bits=self._link.sym_bits if self._link is not None else None,
                device=self.device,
            )
            # Verdict masks in the row store carry the kernel id: a ruleset
            # or codec change re-bakes the constants, and a stale mask must
            # never alias the new program's.
            self._kernel_tag = ":" + self._mega.kernel_id
            if self.mesh is not None:
                self._mega_fn = make_sharded_megakernel(self.mesh, self._mega)
            self._mega_on = True

    # ------------------------------------------------------------------

    @property
    def ruleset_digest(self) -> str:
        """Content digest of the active rule material (registry/digest.py):
        a warm-start artifact's, else computed on first use."""
        if self._ruleset_digest is None:
            from trivy_tpu_torch.registry.digest import ruleset_digest

            self._ruleset_digest = ruleset_digest(self.ruleset)
        return self._ruleset_digest

    def _buckets(self) -> list[int]:
        """Row batch shapes: the sieve's buckets capped by max_batch_tiles,
        rounded up to the mesh's lane multiple."""
        align = self._tile_align
        caps = [b for b in self._tile_buckets if b <= self.max_batch_tiles]
        if not caps or caps[-1] != self.max_batch_tiles:
            caps.append(self.max_batch_tiles)
        return [-(-b // align) * align for b in caps]

    @property
    def _staged_cols(self) -> int:
        """Width of a staged row: the codec's packed width, else the tile."""
        return self._link.coded_len(self.tile_len) if self._link is not None else self.tile_len

    @staticmethod
    def _pad_chunk(rows: np.ndarray, off: int, max_rows: int) -> np.ndarray:
        part = rows[off : off + max_rows]
        if len(part) < max_rows:
            part = np.concatenate(
                [part, np.zeros((max_rows - len(part), part.shape[1]), np.uint8)]
            )
        return np.ascontiguousarray(part)

    def warmup(self) -> None:
        """Build the claim-killer (native library and DFA tables, ~0.6 s
        of host time for the builtin ruleset) and, on a card, load the
        kernel library of the sieve and make its first launch at the
        smallest bucket, ahead of timed scanning.  In auto mode, price the
        megakernel gate from a measured dispatch."""
        self._host_verifier()
        if self.sieve == "native":
            return
        if self.device.type == "cuda":
            _build.load("lut_sieve" if self.sieve == "lut" else
                        "gram_sieve" if self._pallas_obj is not None else "gram_rows",
                        self.aot_cache_dir)
            if self._mega is not None:
                _build.load("megakernel", self.aot_cache_dir)
            self._exec(torch.zeros((self._buckets()[0], self._staged_cols),
                                   dtype=torch.uint8, device=self.device))
            self._sync()
        if self._mega is not None and self._mega_on and self._mega_auto:
            self._price_mega_gate(self._mega_exec_mb_s())

    def _mega_exec_mb_s(self) -> float:
        """Raw MB/s of one warm K3 call at the smallest row bucket and the
        minimum file pad (8 lanes, all padding): the reference's gate
        pricing shape."""
        rows = self._buckets()[0]
        args = self._mega_zero_args()
        self._mega_call(*args)  # warm
        self._sync()
        t0 = time.perf_counter()
        self._mega_call(*args)
        self._sync()
        dt = max(time.perf_counter() - t0, 1e-9)
        return rows * self.tile_len / dt / 1e6

    def _mega_call(self, coded, lo, hi, valid) -> torch.Tensor:
        """The packed verdict mask of one batch: K3m under a mesh, else K3."""
        fn = self._mega_fn if self._mega_fn is not None else self._mega
        return fn(coded, lo, hi, valid)

    def _mega_zero_args(self) -> tuple:
        """K3's arguments at the smallest row bucket, all zero rows, and the
        minimum file pad (8 lanes, all padding)."""
        rows = self._buckets()[0]
        return (
            torch.zeros((rows, self._staged_cols), dtype=torch.uint8, device=self.device),
            torch.zeros((1, 8), dtype=torch.int32, device=self.device),
            torch.full((1, 8), -1, dtype=torch.int32, device=self.device),
            torch.zeros((8, 1), dtype=torch.int8, device=self.device),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            for dev in (self.mesh.distinct_devices() if self.mesh is not None
                        else (self.device,)):
                torch.cuda.synchronize(dev)

    def _price_mega_gate(self, exec_mb_s: float) -> None:
        """The reference's `_price_mega_gate`: the megakernel stays on only
        when the fused link model at one card clears the bar and the
        measured exec rate clears `MEGA_GATE_EXEC_MB_S`; the decision goes
        to the gate log."""
        terms = link_mod.gate_terms(
            h2d_ratio=self._link.ratio if self._link is not None else 1.0,
            d2h_ratio=link_mod.FUSED_MASK_D2H_RATIO,
            profile="mega", devices=mesh_topology.distinct_device_count(self.mesh),
            exec_mb_s=exec_mb_s, device=self.device,
        )
        self._mega_on = bool(terms["wide"])
        rec = link_mod.record_gate("auto", "fused", "mega-wide" if self._mega_on else "mega-narrow",
                          terms)
        self.mega_gate = {**rec, "exec_mb_per_sec": exec_mb_s}

    # -- candidate resolution on the host (unfused, lut, native) --------

    def candidate_matrix_bool(self, probe_bool: np.ndarray) -> np.ndarray:
        """[F, P] bool probe hits -> [F, R] bool candidates (matmul form)."""
        return self.compiled.candidate_matrix_bool(probe_bool)

    def candidate_matrix(self, file_hits: np.ndarray) -> np.ndarray:
        """[F, R] bool candidates from per-file probe bitmaps [F, Pw] (the
        LUT sieve's resolution, over `ProbeSet.gate_masks`)."""
        h = file_hits[:, None, :]  # [F, 1, Pw]
        gate_ok = ~self._gate_any[None, :] | (h & self._gate[None]).any(-1)
        conj_hit = (file_hits[:, None, None, :] & self._conj[None]).any(-1)  # [F, R, K]
        conj_ok = (~self._conj_any[None] | conj_hit).all(-1)
        return gate_ok & conj_ok

    # -- staging and the sieve call --------------------------------------

    def _encode_chunk(self, part: np.ndarray) -> tuple[np.ndarray, int]:
        """(staged buffer, raw padded bytes): the link codec transcodes the
        padded chunk to packed class ids; without one the chunk ships as
        is.  Callers count link bytes at actual staging time, so resident
        hits never count."""
        if self._link is None:
            return part, part.nbytes
        t0 = time.perf_counter()
        with obs_trace.span("chunk.encode", bytes=part.nbytes):
            ph = obs_metrics.device_phase("encode")
            coded = self._link.encode_rows(part)
            ph.done()
        self.stats.encode_s += time.perf_counter() - t0
        return coded, part.nbytes

    def _count_link(self, raw_nbytes: int, coded_nbytes: int) -> None:
        self.stats.bytes_on_link_raw += raw_nbytes
        self.stats.bytes_on_link_coded += coded_nbytes

    def _note_dispatch(self) -> None:
        self.stats.device_dispatches += 1

    def _chunk_digest(self, buf: np.ndarray, cache: ResidentChunkCache) -> str | None:
        """Cache key of a staged buffer (digest + codec), or None when the
        cache is off."""
        if not cache.capacity:
            return None
        return chunk_digest(buf) + self._codec_tag + self._mesh_tag

    def _stage(self, buf: np.ndarray, real_rows: int):
        """(rows, ready, handles) of one chunk staged to the device, or one
        shard a lane under a mesh (`pipeline.stage_rows`, which ledgers each
        lane's real rows and bytes); the caller releases `handles` once the
        chunk's kernels are done with the rows."""
        return stage_rows(buf, self._stagers, self.mesh, real_rows)

    def _gather(self, out):
        """A meshed result's shards joined in row order on the engine's
        device; an unmeshed one as it is."""
        return out.gather(self.device) if isinstance(out, Sharded) else out

    def _exec(self, rows):
        """Unpack (codec) and sieve one staged chunk on the current stream;
        the hit words stay on the device.  With tracing on, each part runs
        as a fenced `device_phase`; off, the phases are shared no-ops.
        Under a mesh the sharded sieve unpacks and sieves lane by lane, one
        phase."""
        if self.mesh is not None:
            ph = obs_metrics.device_phase("sieve-step")
            out = self._sieve_fn(rows)
            ph.done(out.shards)
            return out
        if self._link is not None:
            ph = obs_metrics.device_phase("unpack")
            rows = self._link.unpack(rows, self.tile_len)
            ph.done(rows)
        ph = obs_metrics.device_phase("sieve-step")
        out = self._sieve_fn(rows)
        ph.done(out)
        return out

    def _sieve_rows(self, rows: np.ndarray, fetch: bool = False):
        """Per-row hit words over one row bucket or whole top-bucket chunks.
        `fetch` False: [Tpad, Dw] on the device, Tpad the bucket-padded row
        count (the reference's `_sieve_rows_fused`); each chunk's staged rows
        and hit words enter the resident row store.  `fetch` True: [T, W]
        uint32 on the host (the reference's `_sieve_rows`); each chunk's
        words are fetched (compacted) and enter the host hit-word cache.
        Either way the key is the chunk digest, and a digest-identical chunk
        is served from its cache without staging or launching anything.
        Several chunks run through `ChunkPipeline`: the encode and copy of
        chunk N+1 overlap the kernels of chunk N (and the fetch of chunk
        N-1).  Under TRIVY_TPU_SYNC_TIMING=1 the host path runs serially
        and uncached (`_timed_dispatch`): a cache hit would skip the
        transfer it measures."""
        buckets = self._buckets()
        total = len(rows)
        size = next((b for b in buckets if total <= b), buckets[-1])
        n_chunks = max(1, -(-total // size))
        if fetch and _sync_timing():
            return np.concatenate([self._timed_dispatch(rows, ci * size, size)
                                   for ci in range(n_chunks)])[:total]
        cache = self._resident if fetch else self._row_store
        outs: list = [None] * n_chunks

        def stage(ci):
            buf, raw_n = self._encode_chunk(self._pad_chunk(rows, ci * size, size))
            digest = self._chunk_digest(buf, cache)
            hit = cache.get(digest) if digest is not None else None
            if hit is not None:
                out = hit if fetch else hit[1]
                return (digest, None, None, out, True, memwatch.NOOP_HANDLE)
            self._count_link(raw_n, buf.nbytes)
            with obs_trace.span("chunk.h2d", chunk=ci, bytes=buf.nbytes):
                faults.fire("device.put")
                # the lanes' staging ledger entries ride the pipeline handle
                # and release at finish (or cancel on a drained pipeline)
                dev, ready, mw = self._stage(buf, max(0, min(size, total - ci * size)))
            return (digest, dev, ready, None, False, mw)

        def execute(ci, staged):
            digest, dev, ready, out, hit, mw = staged
            if hit:
                self.stats.resident_hits += 1
                return staged
            self._note_dispatch()
            with obs_trace.span("chunk.exec", chunk=ci):
                faults.fire("device.exec")
                out = self._exec(wait_staged(dev, ready))
            return (digest, dev, None, out, False, mw)

        def finish(ci, handle):
            digest, dev, _ready, out, hit, mw = handle
            mw.release()
            if not hit:
                if fetch:
                    with obs_trace.span("chunk.fetch", chunk=ci):
                        faults.fire("device.fetch")
                        ph = obs_metrics.device_phase("compact")
                        out = self._fetch_hits(out)
                        ph.done()
                if digest is not None:
                    cache.put(digest, out if fetch else (dev, out))
            outs[ci] = out

        def cancel(ci, handle):
            handle[5].release()

        if n_chunks == 1:
            staged = stage(0)
            try:
                handle = execute(0, staged)
            except BaseException:
                cancel(0, staged)
                raise
            finish(0, handle)
        else:
            pipe = ChunkPipeline(stage, execute, finish, depth=self.pipeline_depth,
                                 cancel=cancel)
            pipe.run(range(n_chunks))
            self.stats.h2d_overlap_s += pipe.stats.h2d_overlap_s
        if fetch:
            return np.concatenate(outs)[:total]
        outs = [self._gather(o) for o in outs]
        return outs[0] if n_chunks == 1 else torch.cat(outs)

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """D2H of a device result whose leading axis is rows (hit words or
        the candidate matrix), compacted to its non-zero rows unless
        compaction is off; the raw/actual byte pair lands in stats."""
        if self._d2h_compact:
            arr, raw_b, got_b = link_mod.fetch_rows_compact(out)
        else:
            arr = link_mod._demux_shards(out)
            raw_b = got_b = arr.nbytes
        self.stats.d2h_bytes_raw += raw_b
        self.stats.d2h_bytes += got_b
        return arr

    def _fetch_hits(self, out: torch.Tensor) -> np.ndarray:
        """One chunk's hit words on the host, [T, W] uint32."""
        return self._fetch(out).view(np.uint32)

    def _timed_dispatch(self, rows: np.ndarray, off: int, size: int) -> np.ndarray:
        """One uncached dispatch of rows [off, off + size), its words
        fetched, under TRIVY_TPU_SYNC_TIMING=1: the copy is forced to
        complete (a synchronize) before the sieve runs, splitting
        stats.h2d_s from stats.exec_s."""
        buf, raw_n = self._encode_chunk(self._pad_chunk(rows, off, size))
        self._note_dispatch()
        self._count_link(raw_n, buf.nbytes)
        t0 = time.perf_counter()
        dev, ready, mw = self._stage(buf, min(size, len(rows) - off))
        try:
            dev = wait_staged(dev, ready)
            self._sync()  # the forced round trip
            self.stats.h2d_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            out = self._fetch_hits(self._exec(dev))
        finally:
            mw.release()
        self.stats.exec_s += time.perf_counter() - t0
        return out

    # -- the fused derive and the megakernel -----------------------------

    def _use_fused_derive(self) -> bool:
        """The device-resident sieve and on-device derive: the fused gram
        path, never under sync timing (whose phase split assumes the serial
        host path)."""
        return (
            self._fused
            and self.sieve == "gram"
            and len(self.compiled.masks) > 0
            and not _sync_timing()
        )

    def derive(
        self, hits: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
        valid: torch.Tensor,
    ) -> torch.Tensor:
        """Candidate lanes on the device, the twin of the reference's
        `_derive_fn.derive`: hit words [T, Dw] int32 and per-file row ranges
        lo/hi [Fp] int32 (hi INCLUSIVE; hi < lo marks padding) and valid
        [Fp] bool -> [Fp, R] uint8.

        The membership contractions are float32 matrix products of 0/1
        operands, run with TF32 held off: every partial sum is an integer
        count far below 2^24, so each product is exact and the thresholds
        equal the reference's int8 x int8 -> int32 ones."""
        t = hits.shape[0]
        shifts = torch.arange(32, dtype=torch.int32, device=hits.device)
        bits = ((hits[:, :, None] >> shifts) & 1).reshape(t, -1)[:, self._expand]
        csz = torch.cat([
            torch.zeros((1, bits.shape[1]), dtype=torch.int32, device=hits.device),
            torch.cumsum(bits, dim=0, dtype=torch.int32),
        ])
        lo_c = lo.clamp(0, t).long()
        hi_c = (hi + 1).clamp(0, t).long()
        gh = ((csz[hi_c] - csz[lo_c]) > 0) & valid[:, None]
        r, k = self.compiled.num_rules, self.compiled.num_conjuncts
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            win = (gh.float() @ self._wmember) > 0
            ph = ((win.float() @ self._pmember) >= self._pwindows) | self._nogram
            gate_ok = ~self._gate_any | ((ph.float() @ self._gate_member) > 0)
            conj_hit = (ph.float() @ self._conj_member).reshape(len(ph), r, k) > 0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        conj_ok = (~self._conj_any | conj_hit).all(dim=-1)
        return (gate_ok & conj_ok).to(torch.uint8)

    def _derive_candidates(self, batch: DenseBatch, hits: torch.Tensor) -> np.ndarray:
        """[F, R] bool candidates; the file count pads to a power of two
        (at least 8), padded files get hi = -1 < lo = 0."""
        f = batch.num_files
        if f == 0:
            return np.zeros((0, self.compiled.num_rules), dtype=bool)
        fp = max(8, 1 << (f - 1).bit_length())
        lo = np.zeros(fp, np.int32)
        hi = np.full(fp, -1, np.int32)
        lo[:f] = batch.file_row_lo
        hi[:f] = batch.file_row_hi
        valid = hi >= lo
        ph = obs_metrics.device_phase("lane.derive")
        out = self.derive(
            hits,
            torch.from_numpy(lo).to(self.device),
            torch.from_numpy(hi).to(self.device),
            torch.from_numpy(valid).to(self.device),
        )
        ph.done(out)
        with obs_trace.span("chunk.fetch"):
            faults.fire("device.fetch")
            ph = obs_metrics.device_phase("compact")
            arr = self._fetch(out)
            ph.done()
        return arr[:f].astype(bool)

    @property
    def megakernel_active(self) -> bool:
        """True when the megakernel is built and switched on."""
        return self._mega is not None and self._mega_on

    def _mega_candidates(self, batch: DenseBatch) -> np.ndarray | None:
        """One megakernel call from packed bytes to verdict bits: stage the
        coded rows, run K3, fetch the packed mask.  Returns the [F, R] bool
        candidate matrix, or None when the batch is outside the single-call
        envelope (no single row bucket fits, or more than MEGA_MAX_FILES
        files), and the staged path then scans it, byte-identically."""
        f = batch.num_files
        r = self.compiled.num_rules
        if f == 0:
            return np.zeros((0, r), dtype=bool)
        total = len(batch.rows)
        fit = next((b for b in self._buckets() if total <= b), None)
        if fit is None or f > MEGA_MAX_FILES:
            return None
        fp = max(8, 1 << (f - 1).bit_length())
        lo = np.zeros((1, fp), np.int32)
        hi = np.full((1, fp), -1, np.int32)  # padding: hi < lo -> invalid
        lo[0, :f] = batch.file_row_lo
        hi[0, :f] = batch.file_row_hi
        valid = (hi >= lo).astype(np.int8).reshape(fp, 1)

        t0 = time.perf_counter()
        buf, raw_n = self._encode_chunk(self._pad_chunk(batch.rows, 0, fit))
        # Store key: chunk digest + codec + KERNEL id + the file-interval
        # digest — identical row bytes under another file split (or a
        # re-baked program) must never alias a cached verdict mask.
        store = self._row_store
        digest = self._chunk_digest(buf, store)
        mask = None
        mw = memwatch.NOOP_HANDLE
        if digest is not None:
            digest += self._kernel_tag + ":" + hashlib.blake2b(
                lo.tobytes() + hi.tobytes(), digest_size=8
            ).hexdigest()
            res = store.rows(digest)
            if res is not None:
                self.stats.resident_hits += 1
                mask = res[1]
        if mask is None:
            self._note_dispatch()
            self._count_link(raw_n, buf.nbytes)
            with obs_trace.span("chunk.h2d", bytes=buf.nbytes):
                faults.fire("device.put")
                dev, ready, mw = self._stage(buf, total)
            lo_d = torch.from_numpy(lo).to(self.device)
            hi_d = torch.from_numpy(hi).to(self.device)
            v_d = torch.from_numpy(valid).to(self.device)
            with obs_trace.span("sieve.megakernel", rows=fit, files=f):
                faults.fire("device.exec")
                ph = obs_metrics.device_phase("sieve.megakernel")
                mask = self._mega_call(wait_staged(dev, ready), lo_d, hi_d, v_d)
                ph.done(mask)
            if digest is not None:
                store.put_rows(digest, dev, mask)
        self.stats.sieve_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        with obs_trace.span("chunk.fetch"):
            faults.fire("device.fetch")
            # raw bytes: what the staged path's [Fp, R] uint8 candidate
            # fetch would have moved for the same batch.
            try:
                lanes, raw_b, got_b = link_mod.fetch_mask_packed(mask, fp * r)
            finally:
                mw.release()  # the fetch waited on the kernels reading the rows
            self.stats.d2h_bytes_raw += raw_b
            self.stats.d2h_bytes += got_b
        cand = lanes.reshape(fp, self._mega.mask_bytes * 8)[:f, :r]
        self.stats.candidate_s += time.perf_counter() - t0
        return cand

    def _candidates(self, contents: list[bytes]) -> np.ndarray:
        """[F, R] bool candidate matrix for a content batch."""
        if self.sieve == "lut":
            t0 = time.perf_counter()
            tiled = pack(contents, self.tile_len, self.overlap)
            self.stats.pack_s += time.perf_counter() - t0
            self.stats.tiles += len(tiled.tiles)
            t0 = time.perf_counter()
            tile_hits = self._sieve_rows(tiled.tiles, fetch=True)
            self.stats.sieve_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            cand = self.candidate_matrix(tiled.file_hits(tile_hits))
            self.stats.candidate_s += time.perf_counter() - t0
            return cand

        t0 = time.perf_counter()
        batch = pack_dense(contents, self.tile_len, self.overlap)
        self.stats.pack_s += time.perf_counter() - t0
        self.stats.tiles += len(batch.rows)
        t0 = time.perf_counter()
        if self.sieve == "native":
            row_hits = gram_sieve_native(batch.rows, self.compiled.masks, self.compiled.vals)
            self.stats.sieve_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            gram_hits = batch.file_hits(row_hits)  # the per-row bools ORed per file
        else:
            if self.megakernel_active and self._use_fused_derive():
                cand = self._mega_candidates(batch)
                if cand is not None:
                    return cand
            if self._use_fused_derive():
                # hit words stay on the device; only the compacted [F, R]
                # candidate matrix comes back
                hits_dev = self._sieve_rows(batch.rows)
                self.stats.sieve_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                cand = self._derive_candidates(batch, hits_dev)
                self.stats.candidate_s += time.perf_counter() - t0
                return cand
            word_hits = self._sieve_rows(batch.rows, fetch=True)  # [T, W] uint32
            self.stats.sieve_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            bits = np.unpackbits(
                batch.file_hits(word_hits).astype("<u4").view(np.uint8), axis=-1,
                bitorder="little").astype(bool)
            if self._pallas_obj is not None:
                # K1's words are over distinct (mask, val) pairs: expand back
                # to the gram order
                gram_hits = self._pallas_obj.expand_bool(bits[:, : self._pallas_obj.num_distinct])
            else:
                gram_hits = bits[:, : len(self.compiled.masks)]
        cand = self.candidate_matrix_bool(self.compiled.probe_hits_bool(gram_hits))
        self.stats.candidate_s += time.perf_counter() - t0
        return cand

    def scan_batch_staged_sieve(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """scan_batch with the megakernel held off for this call (the serve
        scheduler's step-down rung): the staged path scans the batch."""
        prev = self._mega_on
        self._mega_on = False
        try:
            return self.scan_batch(items)
        finally:
            self._mega_on = prev

    # -- the claim-killer and the confirm ---------------------------------

    def _host_verifier(self) -> DfaVerifier:
        """The claim-killer (engine/redfa.py), built once per engine: the
        gram-level candidate matrix has no per-hit class precision, so
        rules with common-substring grams claim broadly, and one C walk per
        (file, rule) pair keeps those out of the ~100 us/pair Python
        confirm.  The native library builds on first use and raises when
        it does not: the port never skips this step quietly."""
        if self._verifier is None:
            load_native(self.aot_cache_dir)
            self._verifier = DfaVerifier(self.ruleset.rules)
        return self._verifier

    def _verify_candidates(
        self, items: list[tuple[str, bytes]], cand: np.ndarray
    ) -> np.ndarray:
        """Drop the candidate (file, rule) pairs the automaton refutes."""
        verifier = self._host_verifier()
        t0 = time.perf_counter()
        with obs_trace.span("verify", files=len(items)):
            fis, ris = np.nonzero(cand)
            if len(fis):
                contents = [c for _, c in items]
                lens = np.fromiter(
                    (len(c) for c in contents), dtype=np.int64, count=len(items)
                )
                ptr_arr = (ctypes.c_char_p * len(items))(*contents)
                ok = verifier.verify_pairs_files(
                    ptr_arr, lens, fis.astype(np.int32), ris.astype(np.int32),
                ).astype(bool)
                cand = cand.copy()
                cand[fis[~ok], ris[~ok]] = False
        self.stats.verify_s += time.perf_counter() - t0
        return cand

    def _dedupe(self, items: list[tuple[str, bytes]]):
        """Content-digest dedupe in front of the sieve: (the distinct items,
        the dedupe record or None).  Sieve, derive and verify run over
        distinct blobs; candidates fan back out to every alias through
        `dd.inverse`, and the confirm stays per (path, content) because path
        gating is per file."""
        if not (self.dedupe and len(items) > 1):
            return items, None
        t0 = time.perf_counter()
        dd = dedupe_blobs([c for _, c in items])
        dt = time.perf_counter() - t0
        self.stats.dedupe_s += dt
        self.stats.pack_s += dt
        if not dd.any_duplicates():
            return items, None
        self.stats.dedupe_saved_bytes += dd.saved_bytes
        return [items[int(i)] for i in dd.unique_index], dd

    def _count_batch(self, items: list[tuple[str, bytes]]) -> None:
        self.stats.files += len(items)
        self.stats.bytes += sum(len(c) for _, c in items)
        self.stats.pipeline_depth = self.pipeline_depth

    def confirm(self, items: list[tuple[str, bytes]], cand: np.ndarray,
                offset: int = 0) -> list[Secret]:
        """The exact confirm: the oracle over each file's candidate rules,
        column j of `cand` being rule `offset + j` of the engine's ruleset
        (the secret program's slice starts at 0)."""
        t0 = time.perf_counter()
        results: list[Secret] = []
        with obs_trace.span("confirm", files=len(items)):
            for fi, (path, content) in enumerate(items):
                idxs = np.flatnonzero(cand[fi])
                if len(idxs) == 0:
                    # The reference's allow-path result shape
                    # (scanner.go:375-380 returns Secret{FilePath} for
                    # allowed paths) without running the oracle.
                    if self.oracle.allow_path(path):
                        results.append(Secret(file_path=path))
                    else:
                        results.append(Secret())
                    continue
                self.stats.candidate_pairs += len(idxs)
                res = self.oracle.scan(path, content,
                                       rule_indices=(idxs + offset).tolist())
                self.stats.confirmed_findings += len(res.findings)
                results.append(res)
        self.stats.confirm_s += time.perf_counter() - t0
        return results

    def scan_batch(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """Scan (path, content) blobs; returns per-file Secret results."""
        if self.program_table is not None:
            # the rule axis is the merged table's: the secret program's
            # slice (indices 0..N-1) through the demux
            return self.scan_programs(items, only=("secret",)).get(
                "secret", [Secret() for _ in items])
        if not items:
            return []
        self._count_batch(items)
        scan_items, dd = self._dedupe(items)
        cand = self._candidates([c for _, c in scan_items])
        cand = self._verify_candidates(scan_items, cand)
        if dd is not None:
            cand = cand[dd.inverse]
        return self.confirm(items, cand)

    def scan_programs(
        self,
        items: list[tuple[str, bytes]],
        only: tuple[str, ...] | None = None,
    ) -> dict[str, list]:
        """One sieve pass, per-program verdicts: {program_id: [verdict per
        item, in item order]}, in table order.

        Sieves the merged rule axis as scan_batch does (same pack, dedupe,
        candidates), applies the claim-killer only to the columns of
        programs with `verify=True`, then hands each program its slice of
        the candidate matrix.  `only` restricts which programs resolve; the
        pass is one either way.

        Spans: `programs.scan` (the root) holds `programs.sieve`,
        `programs.verify` and one `programs.resolve` a program (its id in
        `program`); each adds its seconds to its `SieveStats` counter
        (`program_sieve_s`, `program_verify_s`, `RESOLVE_COUNTERS`)."""
        table = self.program_table
        if table is None:
            raise RuntimeError(
                "scan_programs needs an engine built with a program_table "
                "(programs.make_program_engine)")
        wanted = [(p, sl) for p, sl in table.slices()
                  if only is None or p.program_id in only]
        if not items:
            return {p.program_id: [] for p, _ in wanted}
        with obs_trace.span("programs.scan", files=len(items),
                            bytes=sum(len(c) for _, c in items)):
            t0 = time.perf_counter()
            with obs_trace.span("programs.sieve", files=len(items)):
                self._count_batch(items)
                scan_items, dd = self._dedupe(items)
                cand = self._candidates([c for _, c in scan_items])
            t1 = time.perf_counter()
            self.stats.program_sieve_s += t1 - t0
            vmask = table.verify_column_mask(cand.shape[1])
            if vmask.any():
                # The claim-killer refutes (file, rule) pairs by exact DFA
                # match: sound only for the columns whose program opted in.
                # The opt-out columns go in zeroed and keep their raw
                # candidacy.
                with obs_trace.span("programs.verify", files=len(scan_items)):
                    verified = self._verify_candidates(scan_items, cand & vmask[None, :])
                    cand = np.where(vmask[None, :], verified, cand)
                self.stats.program_verify_s += time.perf_counter() - t1
            if dd is not None:
                cand = cand[dd.inverse]

            out: dict[str, list] = {}
            for prog, sl in wanted:
                pslice = cand[:, sl]
                t0 = time.perf_counter()
                with obs_trace.span("programs.resolve", program=prog.program_id):
                    verdicts = prog.resolve(self, items, pslice, sl.start)
                resolve_s = time.perf_counter() - t0
                counter = RESOLVE_COUNTERS.get(prog.program_id)
                if counter is not None:
                    setattr(self.stats, counter, getattr(self.stats, counter) + resolve_s)
                if len(verdicts) != len(items):
                    raise RuntimeError(
                        f"program {prog.program_id!r} returned {len(verdicts)} "
                        f"verdicts for {len(items)} items")
                st = self.program_stats.setdefault(prog.program_id, {
                    "files": 0, "candidate_files": 0, "candidate_pairs": 0,
                    "verdicts": 0, "resolve_s": 0.0,
                })
                st["files"] += len(items)
                st["candidate_files"] += int(pslice.any(axis=1).sum())
                st["candidate_pairs"] += int(pslice.sum())
                st["verdicts"] += prog.verdict_count(verdicts)
                st["resolve_s"] = round(st["resolve_s"] + resolve_s, 6)
                out[prog.program_id] = verdicts
        return out

    def programs_snapshot(self) -> dict:
        """The program table's attribution: each program's counters."""
        if self.program_table is None:
            return {"enabled": False}
        snap = self.program_table.snapshot()
        for p in snap["programs"]:
            p.update(self.program_stats.get(p["id"], {}))
        snap["enabled"] = True
        return snap

    def scan(self, file_path: str, content: bytes) -> Secret:
        return self.scan_batch([(file_path, content)])[0]
