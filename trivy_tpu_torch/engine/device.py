"""The GPU secret engine: device sieve -> on-device candidates -> claim-killer
-> exact confirm.

The port of `trivy_tpu/engine/device.py` `TpuSecretEngine` with
`kernel="pallas", fused=True`.  A batch inside the single-call envelope (one
row bucket, at most `MEGA_MAX_FILES` files) runs the **megakernel path**,
the reference's default on its accelerator: encode, H2D, one megakernel call
(`ops/megakernel.py`: unpack, sieve, per-file counts, derive, packed verdict
bits) and the fetch of the packed mask.  Any other batch, or every batch with
`megakernel=False`, runs the **staged fused path**:

  1. the host dedupes blobs by content digest and packs them densely into
     overlapping rows (`scanner/packing.py`);
  2. for each row-bucket chunk, the link codec encodes the rows, they go
     host-to-device from pinned buffers on a side stream, unpack on the
     device, and the gram sieve kernel runs (`ops/gram_sieve.py`); hit words
     stay on the device.  Batches of several top-bucket chunks run through
     the chunk pipeline (`engine/pipeline.py`: the copy of chunk N+1
     overlaps the kernels of chunk N), and each chunk's rows and hit words
     stay in the digest-keyed resident row store, so a rescan of unchanged
     rows crosses no link and launches nothing;
  3. the device derives the [files, rules] candidate matrix from the hit
     words (`GpuSecretEngine.derive`), and only that matrix comes back,
     compacted (`engine/link.py`).

Both paths then run the claim-killer: a C DFA / NFA-64 walk per candidate
(file, rule) pair (`engine/redfa.py`, `native/dfa_verify.cpp`) drops the
pairs the rule's automaton refutes, and the oracle confirms what is left
byte-exactly, so findings equal the reference engine's by construction.

Every stage sits inside the reference's spans (`obs/trace.py`: chunk.encode,
chunk.h2d, chunk.exec, sieve.megakernel, chunk.fetch, verify, confirm),
fenced device phases (`obs/metrics.py` `device_phase`) and fault seams
(`faults.py`: device.put, device.exec, device.fetch).  Left out for later
slices: the forced-sync timing decomposition, mesh staging, the
executable cache and scan programs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch import faults
from trivy_tpu_torch.compiled import CompiledRules
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine import link as link_mod
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.engine.pipeline import (
    ChunkPipeline,
    ResidentRowStore,
    RowStager,
    chunk_digest,
    default_depth,
    wait_staged,
)
from trivy_tpu_torch.engine.redfa import DfaVerifier
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.native import load_native
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.gram_sieve import GramSieve
from trivy_tpu_torch.ops.megakernel import MEGA_MAX_FILES, MegaGramSieve
from trivy_tpu_torch.rules.model import RuleSet, SecretConfig, build_ruleset
from trivy_tpu_torch.scanner.packing import (
    DEFAULT_TILE_LEN,
    DenseBatch,
    dedupe_blobs,
    pack_dense,
)

# Row-batch shapes: every sieve call uses one of these row counts, and
# larger scans are chunked into top-bucket batches.  Kept from the reference
# for shape parity; retune only from a measurement on the card.
TILE_BUCKETS_PALLAS = (4096, 8192, 16384, 32768)

GRAM_OVERLAP = 3  # gram window (4) - 1


@dataclass
class SieveStats:
    files: int = 0
    bytes: int = 0
    tiles: int = 0
    candidate_pairs: int = 0
    device_pairs: int = 0  # candidate lanes verified on the device NFA (hybrid)
    confirmed_findings: int = 0
    # Wall-clock per phase (seconds), accumulated across scan_batch calls:
    # host pack, sieve (encode, H2D and kernel launches), candidate derive
    # and fetch, the claim-killer's C walk, exact confirm.
    pack_s: float = 0.0
    sieve_s: float = 0.0
    candidate_s: float = 0.0
    verify_s: float = 0.0
    confirm_s: float = 0.0
    device_dispatches: int = 0
    # Chunk-pipeline accounting (engine/pipeline.py): finish-stage wall
    # that ran while later chunks were staged or executing, content-digest
    # dedupe savings and seconds (a part of pack_s here, of verify_s in
    # the hybrid's device pass), resident row-store hits, and the depth
    # the run used.
    h2d_overlap_s: float = 0.0
    dedupe_saved_bytes: int = 0
    dedupe_s: float = 0.0
    resident_hits: int = 0
    pipeline_depth: int = 0
    # Link accounting: padded chunk bytes before and after the codec, the
    # host encode time, and the full vs actually fetched D2H bytes.
    bytes_on_link_raw: int = 0
    bytes_on_link_coded: int = 0
    encode_s: float = 0.0
    d2h_bytes_raw: int = 0
    d2h_bytes: int = 0

    def phases(self) -> dict:
        out = {
            "pack_s": round(self.pack_s, 4),
            "sieve_s": round(self.sieve_s, 4),
            "candidate_s": round(self.candidate_s, 4),
            "confirm_s": round(self.confirm_s, 4),
        }
        if self.verify_s:
            out["verify_s"] = round(self.verify_s, 4)
        if self.pipeline_depth:
            out["pipeline_depth"] = self.pipeline_depth
            out["h2d_overlap_s"] = round(self.h2d_overlap_s, 4)
        if self.dedupe_saved_bytes:
            out["dedupe_saved_bytes"] = self.dedupe_saved_bytes
        if self.dedupe_s:
            out["dedupe_s"] = round(self.dedupe_s, 4)
        if self.resident_hits:
            out["resident_hits"] = self.resident_hits
        if self.bytes_on_link_raw:
            out["bytes_on_link_raw"] = self.bytes_on_link_raw
            out["bytes_on_link_coded"] = self.bytes_on_link_coded
            out["codec_ratio"] = round(
                self.bytes_on_link_coded / self.bytes_on_link_raw, 4
            )
        if self.encode_s:
            out["encode_s"] = round(self.encode_s, 4)
        if self.d2h_bytes_raw:
            out["d2h_bytes_raw"] = self.d2h_bytes_raw
            out["d2h_bytes"] = self.d2h_bytes
            out["d2h_ratio"] = round(self.d2h_bytes / self.d2h_bytes_raw, 4)
        return out


class GpuSecretEngine:
    """Drop-in engine with the oracle's Scan semantics, on a CUDA card (or
    on the CPU when `device="cpu"`, through the kernels' plain versions).

    `compiled` takes a `CompiledRules` or the dict of arrays that
    `CompiledRules.from_numpy` reads; it must be compiled from `ruleset`.

    `megakernel` switches the megakernel path: the argument when given, else
    `TRIVY_TPU_MEGAKERNEL` ("0" off, anything else on), else on for a CUDA
    device and off on the CPU, as the reference's is on only on its
    accelerator.  It needs `tile_len` a power of two >= 256 and some gram.
    In auto mode (neither given), `warmup()` then prices the reference's
    megakernel gate (`_price_mega_gate`, engine/hybrid.py `gate_terms`
    profile "mega") and keeps the megakernel only when it clears the bar.

    `pipeline_depth` bounds the chunks in flight (default `default_depth()`,
    `TRIVY_TPU_PIPELINE_DEPTH`), `dedupe` scans each distinct blob once, and
    `resident_chunks` caps the resident row store (default
    `TRIVY_TPU_RESIDENT_CHUNKS`, else 32; 0 turns residency off)."""

    def __init__(
        self,
        ruleset: RuleSet | None = None,
        config: SecretConfig | None = None,
        tile_len: int = DEFAULT_TILE_LEN,
        max_batch_tiles: int | None = None,
        compiled: CompiledRules | dict | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
        megakernel: bool | None = None,
        pipeline_depth: int | None = None,
        dedupe: bool = True,
        resident_chunks: int | None = None,
    ):
        self.device = resolve_device(device)
        self.ruleset = ruleset if ruleset is not None else build_ruleset(config)
        self.oracle = OracleScanner(self.ruleset)
        if compiled is None:
            compiled = CompiledRules.build(self.ruleset)
        elif isinstance(compiled, dict):
            compiled = CompiledRules.from_numpy(compiled)
        self.compiled = compiled
        self.tile_len = tile_len
        self.overlap = GRAM_OVERLAP
        self.max_batch_tiles = (
            max_batch_tiles if max_batch_tiles is not None
            else TILE_BUCKETS_PALLAS[-1]
        )
        self.stats = SieveStats()
        self.pipeline_depth = (
            pipeline_depth if pipeline_depth is not None else default_depth()
        )
        self.dedupe = dedupe
        self._row_store = ResidentRowStore(resident_chunks)
        self._stager = RowStager(self.device, self.pipeline_depth)
        self._verifier: DfaVerifier | None = None

        mode = link_mod.codec_mode()
        self._d2h_compact = mode != "off"
        self._link = None
        if mode != "off":
            self._link = link_mod.select_codec(
                link_mod.derive_alphabet(compiled), mode, compiled
            )
        # Resident-row keys carry the codec: coded rows never alias raw ones.
        self._codec_tag = ":raw"
        if self._link is not None:
            self._codec_tag = ":" + self._link.codec_id
            cmasks, cvals = self._link.encode_grams(compiled.masks, compiled.vals)
        else:
            cmasks, cvals = compiled.masks, compiled.vals
        self.sieve = GramSieve(cmasks, cvals, device=self.device)

        def dev(a, dtype=torch.float32) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        expand = self.sieve.gram_expand
        if not len(expand):
            expand = np.arange(self.sieve.num_distinct)
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
        self._mega: MegaGramSieve | None = None
        self._mega_on = False
        self._kernel_tag = ""
        if (
            want_mega
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
            self._mega_on = True

    # ------------------------------------------------------------------

    def _buckets(self) -> list[int]:
        """Row batch shapes: TILE_BUCKETS_PALLAS capped by max_batch_tiles."""
        caps = [b for b in TILE_BUCKETS_PALLAS if b <= self.max_batch_tiles]
        if not caps or caps[-1] != self.max_batch_tiles:
            caps.append(self.max_batch_tiles)
        return caps

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
        kernel libraries the engine launches, ahead of timed scanning.  In
        auto mode, price the megakernel gate from a measured dispatch."""
        self._host_verifier()
        if self.device.type == "cuda":
            _build.load("gram_sieve")
            if self._mega is not None:
                _build.load("megakernel")
        if self._mega is not None and self._mega_on and self._mega_auto:
            self._price_mega_gate(self._mega_exec_mb_s())

    def _mega_exec_mb_s(self) -> float:
        """Raw MB/s of one warm K3 call at the smallest row bucket and the
        minimum file pad (8 lanes, all padding): the reference's gate
        pricing shape."""
        rows = self._buckets()[0]
        cols = self._link.coded_len(self.tile_len) if self._link is not None else self.tile_len
        args = (
            torch.zeros((rows, cols), dtype=torch.uint8, device=self.device),
            torch.zeros((1, 8), dtype=torch.int32, device=self.device),
            torch.full((1, 8), -1, dtype=torch.int32, device=self.device),
            torch.zeros((8, 1), dtype=torch.int8, device=self.device),
        )
        self._mega(*args)  # warm
        self._sync()
        t0 = time.perf_counter()
        self._mega(*args)
        self._sync()
        dt = max(time.perf_counter() - t0, 1e-9)
        return rows * self.tile_len / dt / 1e6

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _price_mega_gate(self, exec_mb_s: float) -> None:
        """The reference's `_price_mega_gate`: the megakernel stays on only
        when the fused link model at one card clears the bar and the
        measured exec rate clears `MEGA_GATE_EXEC_MB_S`; the decision goes
        to the gate log."""
        from trivy_tpu_torch.engine.hybrid import gate_terms, record_gate

        terms = gate_terms(
            h2d_ratio=self._link.ratio if self._link is not None else 1.0,
            d2h_ratio=link_mod.FUSED_MASK_D2H_RATIO,
            profile="mega", devices=1, exec_mb_s=exec_mb_s, device=self.device,
        )
        self._mega_on = bool(terms["wide"])
        rec = record_gate("auto", "fused", "mega-wide" if self._mega_on else "mega-narrow",
                          terms)
        self.mega_gate = {**rec, "exec_mb_per_sec": exec_mb_s}

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

    def _chunk_digest(self, buf: np.ndarray) -> str | None:
        """Row-store key of a staged buffer (digest + codec), or None when
        residency is off."""
        if not self._row_store.capacity:
            return None
        return chunk_digest(buf) + self._codec_tag

    def _exec(self, rows: torch.Tensor) -> torch.Tensor:
        """Unpack (codec) and sieve one staged chunk on the current stream;
        the hit words stay on the device.  With tracing on, each part runs
        as a fenced `device_phase`; off, the phases are shared no-ops."""
        if self._link is not None:
            ph = obs_metrics.device_phase("unpack")
            rows = self._link.unpack(rows, self.tile_len)
            ph.done(rows)
        ph = obs_metrics.device_phase("sieve-step")
        out = self.sieve(rows)
        ph.done(out)
        return out

    def _sieve_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Hit words [Tpad, Dw] on the device, Tpad the bucket-padded row
        count (one bucket, or whole top-bucket chunks): the counterpart of
        the reference's `_sieve_rows_fused`.  Each chunk's staged rows and
        hit words enter the resident row store under the chunk digest, and
        a digest-identical chunk is served from there without staging or
        launching anything.  Several chunks run through `ChunkPipeline`:
        the encode and copy of chunk N+1 overlap the kernels of chunk N."""
        store = self._row_store
        buckets = self._buckets()
        max_rows = buckets[-1]
        total = len(rows)
        fit = next((b for b in buckets if total <= b), None)
        if fit is not None:
            buf, raw_n = self._encode_chunk(self._pad_chunk(rows, 0, fit))
            digest = self._chunk_digest(buf)
            if digest is not None:
                res = store.rows(digest)
                if res is not None:
                    self.stats.resident_hits += 1
                    return res[1]
            self._note_dispatch()
            self._count_link(raw_n, buf.nbytes)
            with obs_trace.span("chunk.h2d", bytes=buf.nbytes):
                faults.fire("device.put")
                dev, ready = self._stager.stage_rows(buf)
            with obs_trace.span("chunk.exec"):
                faults.fire("device.exec")
                out = self._exec(wait_staged(dev, ready))
            if digest is not None:
                store.put_rows(digest, dev, out)
            return out
        n_chunks = -(-total // max_rows)
        outs: list = [None] * n_chunks

        def stage(ci):
            part = self._pad_chunk(rows, ci * max_rows, max_rows)
            buf, raw_n = self._encode_chunk(part)
            digest = self._chunk_digest(buf)
            if digest is not None:
                res = store.rows(digest)
                if res is not None:
                    return (digest, res[0], None, res[1], True)
            self._count_link(raw_n, buf.nbytes)
            with obs_trace.span("chunk.h2d", chunk=ci, bytes=buf.nbytes):
                faults.fire("device.put")
                dev, ready = self._stager.stage_rows(buf)
            return (digest, dev, ready, None, False)

        def execute(ci, staged):
            digest, dev, ready, out, hit = staged
            if hit:
                self.stats.resident_hits += 1
                return staged
            self._note_dispatch()
            with obs_trace.span("chunk.exec", chunk=ci):
                faults.fire("device.exec")
                out = self._exec(wait_staged(dev, ready))
            return (digest, dev, None, out, False)

        def finish(ci, handle):
            digest, dev, _ready, out, hit = handle
            if not hit and digest is not None:
                store.put_rows(digest, dev, out)
            outs[ci] = out

        pipe = ChunkPipeline(stage, execute, finish, depth=self.pipeline_depth)
        pipe.run(range(n_chunks))
        self.stats.h2d_overlap_s += pipe.stats.h2d_overlap_s
        return torch.cat(outs)

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

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """D2H of the candidate matrix, compacted unless the codec is off;
        the raw/actual byte pair lands in stats."""
        if self._d2h_compact:
            arr, raw_b, got_b = link_mod.fetch_rows_compact(out)
        else:
            arr = out.cpu().numpy()
            raw_b = got_b = arr.nbytes
        self.stats.d2h_bytes_raw += raw_b
        self.stats.d2h_bytes += got_b
        return arr

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
        digest = self._chunk_digest(buf)
        mask = None
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
                dev, ready = self._stager.stage_rows(buf)
            lo_d = torch.from_numpy(lo).to(self.device)
            hi_d = torch.from_numpy(hi).to(self.device)
            v_d = torch.from_numpy(valid).to(self.device)
            with obs_trace.span("sieve.megakernel", rows=fit, files=f):
                faults.fire("device.exec")
                ph = obs_metrics.device_phase("sieve.megakernel")
                mask = self._mega(wait_staged(dev, ready), lo_d, hi_d, v_d)
                ph.done(mask)
            if digest is not None:
                store.put_rows(digest, dev, mask)
        self.stats.sieve_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        with obs_trace.span("chunk.fetch"):
            faults.fire("device.fetch")
            # raw bytes: what the staged path's [Fp, R] uint8 candidate
            # fetch would have moved for the same batch.
            lanes, raw_b, got_b = link_mod.fetch_mask_packed(mask, fp * r)
            self.stats.d2h_bytes_raw += raw_b
            self.stats.d2h_bytes += got_b
        cand = lanes.reshape(fp, self._mega.mask_bytes * 8)[:f, :r]
        self.stats.candidate_s += time.perf_counter() - t0
        return cand

    def _candidates(self, contents: list[bytes]) -> np.ndarray:
        """[F, R] bool candidate matrix for a content batch."""
        t0 = time.perf_counter()
        batch = pack_dense(contents, self.tile_len, self.overlap)
        self.stats.pack_s += time.perf_counter() - t0
        self.stats.tiles += len(batch.rows)
        if self.megakernel_active:
            cand = self._mega_candidates(batch)
            if cand is not None:
                return cand
        t0 = time.perf_counter()
        hits = self._sieve_rows(batch.rows)
        self.stats.sieve_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        cand = self._derive_candidates(batch, hits)
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

    def _host_verifier(self) -> DfaVerifier:
        """The claim-killer (engine/redfa.py), built once per engine: the
        gram-level candidate matrix has no per-hit class precision, so
        rules with common-substring grams claim broadly, and one C walk per
        (file, rule) pair keeps those out of the ~100 us/pair Python
        confirm.  The native library builds on first use and raises when
        it does not: the port never skips this step quietly."""
        if self._verifier is None:
            load_native()
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

    def scan_batch(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """Scan (path, content) blobs; returns per-file Secret results."""
        if not items:
            return []
        self.stats.files += len(items)
        self.stats.bytes += sum(len(c) for _, c in items)
        self.stats.pipeline_depth = self.pipeline_depth

        # Content-digest dedupe: sieve, derive and verify run over distinct
        # blobs, candidates fan back out to every alias; the confirm stays
        # per (path, content) because path gating is per file.
        contents = [c for _, c in items]
        scan_items = items
        dd = None
        if self.dedupe and len(items) > 1:
            t0 = time.perf_counter()
            dd = dedupe_blobs(contents)
            dt = time.perf_counter() - t0
            self.stats.dedupe_s += dt
            self.stats.pack_s += dt
            if dd.any_duplicates():
                self.stats.dedupe_saved_bytes += dd.saved_bytes
                scan_items = [items[int(i)] for i in dd.unique_index]
                contents = [c for _, c in scan_items]
            else:
                dd = None

        cand = self._candidates(contents)
        cand = self._verify_candidates(scan_items, cand)
        if dd is not None:
            cand = cand[dd.inverse]

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
                res = self.oracle.scan(path, content, rule_indices=idxs.tolist())
                self.stats.confirmed_findings += len(res.findings)
                results.append(res)
        self.stats.confirm_s += time.perf_counter() - t0
        return results

    def scan(self, file_path: str, content: bytes) -> Secret:
        return self.scan_batch([(file_path, content)])[0]
