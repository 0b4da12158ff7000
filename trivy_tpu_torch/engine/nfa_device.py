"""Device NFA verification of candidate (file, rule) lanes: `GpuNfaVerifier`.

The port of `trivy_tpu/engine/nfa_device.py` `NfaVerifier`, the verify
stage of the hybrid engine (engine/hybrid.py) on the card.  Each rule's
64-position Glushkov search automaton (the compilation engine/redfa.py uses
for its NFA-64 walk) becomes 0/1 tensors and, for the kernels, 64-bit words
(`ops/nfa_verify.py`).  The lane contract, constants and host logic are the
reference's, unchanged in meaning:

* a lane is a candidate (file, rule, first_hint, last_hint) quad; it walks
  the window [first - bound, last + bound + 8] (`prefix_bound`, shared with
  the host claim-killer so both clip alike), or the whole file for an
  untrimmable rule;
* **stream** (the production shape): lanes group by file, each file's span
  (the union of its lanes' windows) packs once into fixed rows of raw bytes
  (`STREAM_TIERS` 512 / 4,096 / 16,384, one 0x00 separator between spans),
  and every distinct candidate rule (the 32 most claimed, `RULE_STACK_
  BUCKETS`) runs over the same rows in one dispatch of K5
  (`ops.nfa_verify.nfa_stream`), a full max-group block of rows at a time,
  with at most `default_depth()` fetches outstanding.  The native library
  assembles the rows and the lane placement in one call (`assemble_spans`)
  before the first dispatch.  The legacy mode fetches the flag map
  (compacted, `link.fetch_stream_packed`)
  and maps it to lanes on the host; the **fused** mode ships a per-tier
  lane table (and its index, `LaneIndex`) with the rows, resolves verdicts
  in the same launch (`nfa_stream_verdict`: K5 keeps the lanes of each
  block it flags and writes no flags) and fetches one keep bit per lane;
* **padded**: spans holding a NUL byte or longer than 16,384, and lanes of
  rules beyond the stack, pack as class ids into [G, Bg, L] buckets
  (`LEN_BUCKETS`) and run K6 (`nfa_padded`) against the resident per-rule
  tensors.

The verdict is block-granular (a flag anywhere in a 32-byte block that
overlaps the lane's window keeps it): an over-approximation that the exact
confirm settles.  Rows (slices of the call's own tier arrays, the last
chunk of a range a padded copy) and lane tables are host arrays nothing
writes after assembly, copied with a synchronous H2D copy, so no host buffer
is reused while a DMA reads it.

**Mesh** (`mesh=`, the reference's group-axis sharding, `mesh/plan.py`
"stream_bytes", "padded_classes", "vstack_rules"): the group axis of every
dispatch splits into equal contiguous shards, one a lane, and K5 or K6
launches once a lane on its slice against the rule tables replicated on
its device.  A meshed stream takes `GROUP_BUCKETS` (at least 8 groups),
and under a mesh every group bucket rounds up to a multiple of the lane
count, so every dispatch splits, at any lane count.  The fused mode gives
each lane its own lane table and `LaneIndex`: the dispatch's lanes whose
rows lie in the lane's slice, rows rebased to it; each lane's keep bits
are placed back at their lanes' positions, so the keep-mask comes out in
global lane order, byte-identical to the unmeshed one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from trivy_tpu_torch import faults
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine import link as link_mod
from trivy_tpu_torch.engine.pipeline import default_depth
from trivy_tpu_torch.engine.redfa import compile_search_nfa64, compute_prefix_bounds
from trivy_tpu_torch.engine.stats import SieveStats
from trivy_tpu_torch.mesh import plan as mesh_plan
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.native import load_native
from trivy_tpu_torch.obs import memwatch
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.ops.nfa_verify import (
    STREAM_BLOCK,
    LaneIndex,
    NfaStack,
    NfaTables,
    nfa_padded,
    nfa_stream,
    nfa_stream_verdict,
)

MAX_LEN = 1 << 15  # lanes whose walk window exceeds this verify on the host
LEN_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, MAX_LEN)
GROUP_BUCKETS = (8, 16, 32, 64, 128)
LANES_PER_GROUP = 64
_NO_TRIM = np.iinfo(np.int32).max

STREAM_TIERS = (512, 4096, 16384)  # row lengths; spans take the smallest fit
RULE_STACK_BUCKETS = (4, 8, 16, 32)  # per-dispatch rule counts
STREAM_GROUP_BUCKETS = (1, 2, 4) + GROUP_BUCKETS


@dataclasses.dataclass
class SpanRows:
    """One verify call's stream rows and lane placement (`assemble_spans`);
    the per-lane arrays follow the order the lanes were given in."""

    rows: list[np.ndarray]  # a tier's rows, [n_rows, length] uint8
    tier: np.ndarray        # int32 [N]: the lane's tier, -1 when not placed
    row: np.ndarray         # int64 [N]: its row in the tier
    b0: np.ndarray          # int32 [N]: the first 32-byte block of its window
    b1: np.ndarray          # int32 [N]: one past the last
    overflow: np.ndarray    # int64: positions of the lanes for the padded path
    span_bytes: int


def assemble_spans(contents, files, slots, start, stop) -> SpanRows:
    """Stream rows and lane placement for lanes given in file order (a
    file's lanes consecutive): `files`, `slots` (the rule's stack slot, -1
    for a rule beyond the stack), walk windows `start`/`stop`; `contents[f]`
    is file f's bytes.  The native library's `span_place` places every lane
    and sizes each tier's rows, `span_copy` copies the spans into one
    zeroed array a tier (native/span_assemble.cpp: tiers, first-fit rows,
    separators, overflow)."""
    files = np.ascontiguousarray(files, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    start = np.ascontiguousarray(start, dtype=np.int64)
    stop = np.ascontiguousarray(stop, dtype=np.int64)
    n = len(files)
    if not len(slots) == len(start) == len(stop) == n:
        raise ValueError("assemble_spans: lane columns of unequal length")
    if n and (files.min() < 0 or files.max() >= len(contents) or start.min() < 0
              or (stop < start).any()):
        raise ValueError("assemble_spans: a lane's file or window is out of range")
    lib = load_native()
    ptrs = (ctypes.c_char_p * len(contents))(*contents)
    lens = np.fromiter(map(len, contents), dtype=np.int64, count=len(contents))
    tier_len = np.asarray(STREAM_TIERS, dtype=np.int64)
    tier = np.empty(n, np.int32)
    row = np.zeros(n, np.int64)
    b0 = np.zeros(n, np.int32)
    b1 = np.zeros(n, np.int32)
    overflow = np.empty(n, np.int64)
    sp_file, sp_src, sp_len, sp_dst = (np.empty(n, np.int64) for _ in range(4))
    sp_tier = np.empty(n, np.int32)
    n_rows = np.empty(len(STREAM_TIERS), np.int64)
    counts = np.empty(3, np.int64)
    lib.span_place(
        ctypes.cast(ptrs, ctypes.c_void_p), lens.ctypes.data,
        files.ctypes.data, slots.ctypes.data, start.ctypes.data, stop.ctypes.data, n,
        tier_len.ctypes.data, len(STREAM_TIERS), STREAM_BLOCK,
        tier.ctypes.data, row.ctypes.data, b0.ctypes.data, b1.ctypes.data,
        overflow.ctypes.data,
        sp_file.ctypes.data, sp_src.ctypes.data, sp_len.ctypes.data,
        sp_tier.ctypes.data, sp_dst.ctypes.data,
        n_rows.ctypes.data, counts.ctypes.data,
    )
    rows = [np.zeros((int(k), ln), dtype=np.uint8) for k, ln in zip(n_rows, STREAM_TIERS)]
    bases = np.array([r.ctypes.data for r in rows], dtype=np.uintp)
    lib.span_copy(
        ctypes.cast(ptrs, ctypes.c_void_p),
        sp_file.ctypes.data, sp_src.ctypes.data, sp_len.ctypes.data,
        sp_tier.ctypes.data, sp_dst.ctypes.data, int(counts[1]),
        bases.ctypes.data,
    )
    return SpanRows(rows=rows, tier=tier, row=row, b0=b0, b1=b1,
                    overflow=overflow[: counts[0]], span_bytes=int(counts[2]))


def _bits(word: int, m: int) -> np.ndarray:
    """Bits 0..m-1 of `word` as a [64] float32 0/1 vector."""
    out = np.zeros(64, np.float32)
    for q in range(m):
        if word >> q & 1:
            out[q] = 1.0
    return out


class GpuNfaVerifier:
    """Keep-mask for candidate lanes on a CUDA card (or the CPU, through
    the kernels' plain versions, when `device="cpu"`).  `mesh` (a `Mesh`
    whose first lane is `device`, or a list of devices) splits each
    dispatch's groups over its lanes (module docstring).  `stats` (the
    engine's `SieveStats`, else a fresh one) sums the lane assembly and
    dispatch seconds of every call."""

    def __init__(self, rules, trimmable=None, prefix_bounds=None, fused=False,
                 rule_stack=None, sieve_kernel_id="",
                 device: str | torch.device = DEFAULT_DEVICE, mesh=None,
                 stats: SieveStats | None = None):
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else SieveStats()
        self.mesh = mesh_topology.engine_mesh(self.device, mesh, auto=False)
        self.num_rules = len(rules)
        # Mutable: scan_batch_device_legacy flips it off for one retry.
        self.fused = bool(fused)
        self.sieve_kernel_id = str(sieve_kernel_id)
        self.prefix_bound = np.asarray(
            prefix_bounds if prefix_bounds is not None
            else compute_prefix_bounds(rules, trimmable),
            dtype=np.int64,
        )
        nfas = [compile_search_nfa64(r) for r in rules]
        # The dense accept tensor holds 64 classes; rules needing more stay
        # with the host verifier.
        nfas = [n if (n is not None and n.num_classes <= 64) else None for n in nfas]
        self.has_nfa = np.array([n is not None for n in nfas], dtype=bool)
        self._nfas = nfas
        self._byte_tensor_cache: dict[int, tuple] = {}
        r = self.num_rules
        self.follow = np.zeros((r, 64, 64), dtype=np.float32)
        self.accept = np.zeros((r, 64, 64), dtype=np.float32)  # [R, C, S]
        self.first = np.zeros((r, 64), dtype=np.float32)
        self.last = np.zeros((r, 64), dtype=np.float32)
        self.luts = np.zeros((r, 256), dtype=np.uint8)
        for i, nfa in enumerate(nfas):
            if nfa is None:
                continue
            m = len(nfa.follow)
            for p in range(m):
                self.follow[i, p] = _bits(int(nfa.follow[p]), m)
            for c in range(nfa.num_classes):
                self.accept[i, c] = _bits(int(nfa.classmask[c]), m)
            self.first[i] = _bits(int(nfa.first), m)
            self.last[i] = _bits(int(nfa.last), m)
            self.luts[i] = nfa.byte_class
        self._tables: dict[torch.device, NfaTables] = {}
        self._padded_s = 0.0
        self.stream_stats: dict = {}
        if rule_stack is not None:
            self._seed_rule_stack(rule_stack)

    def _seed_rule_stack(self, stack) -> None:
        """Seed the per-rule byte-tensor cache from `build_rule_stack`'s
        `vstack_*` arrays (the reference's registry artifact arrays, or the
        port's own); a stack whose rule count differs is ignored."""
        try:
            has = np.asarray(stack["vstack_has"]).astype(bool)
            fol = np.asarray(stack["vstack_follow"], dtype=np.float32)
            acc = np.asarray(stack["vstack_accept_b"], dtype=np.float32)
            fst = np.asarray(stack["vstack_first"], dtype=np.float32)
            lst = np.asarray(stack["vstack_last"], dtype=np.float32)
        except (KeyError, TypeError):
            return
        if len(has) != self.num_rules:
            return
        for r in range(self.num_rules):
            if has[r] and self._nfas[r] is not None:
                self._byte_tensor_cache[r] = (fol[r], acc[r], fst[r], lst[r])

    def _shards(self, family: str, arr: np.ndarray) -> list[torch.Tensor]:
        """Host array `arr` on the verifier's lanes: one tensor a lane, split
        as the plan places `family`, or the whole on the verifier's device
        without a mesh."""
        t = torch.from_numpy(arr)
        place = mesh_plan.sharding_for(self.mesh, family)
        return [t.to(self.device)] if place is None else list(place.split(t).shards)

    def _group_cap(self, groups: int, buckets: tuple[int, ...]) -> int:
        """The group bucket a dispatch of `groups` groups takes, rounded up
        to a multiple of the lane count so the group axis splits evenly."""
        n = len(self._lanes())
        g = next((b for b in buckets if groups <= b), buckets[-1])
        return -(-g // n) * n

    def _lanes(self) -> tuple[torch.device, ...]:
        """The devices a dispatch splits over: the mesh's lanes, or the
        verifier's device alone."""
        return self.mesh.devices if self.mesh is not None else (self.device,)

    def _device_tables(self, device: torch.device | None = None) -> NfaTables:
        """The padded path's resident per-rule words and K6 tables
        (`NfaTables`) on `device` (default the verifier's): built once a
        device (the plan's replicated "vstack_rules") and ledgered in
        memwatch as "nfa-tensors" for the verifier's life."""
        dev = self.device if device is None else device
        if dev not in self._tables:
            if self._tables:
                first = next(iter(self._tables.values()))
                tables = dataclasses.replace(first, words=first.words.to(dev),
                                             table=first.table.to(dev))
            else:
                tables = NfaTables.build(self.follow, self.accept, self.first,
                                         self.last, dev)
            self._tables[dev] = tables
            memwatch.track("nfa-tensors", tables.nbytes, device=str(dev), owner=self)
        return self._tables[dev]

    def warmup(self, aot_cache_dir: str | None = None) -> None:
        """Ship the resident tensors and, on a card, load the kernels (from
        the executable cache `aot_cache_dir`, else the default one)."""
        for dev in dict.fromkeys(self._lanes()):
            self._device_tables(dev)
        if self.device.type == "cuda":
            from trivy_tpu_torch.ops import _build

            _build.load("nfa_verify", aot_cache_dir)

    # ------------------------------------------------------------------

    def _windows(self, pairs: np.ndarray, lens: np.ndarray):
        """Per-lane walk windows [start, stop) over pairs [N, 4] (file, rule,
        first_hint, last_hint): the claim-killer's clip."""
        flen = lens[pairs[:, 0]]
        bound = self.prefix_bound[pairs[:, 1]]
        trim = bound != _NO_TRIM
        start = np.where(trim, np.maximum(pairs[:, 2].astype(np.int64) - bound, 0), 0)
        stop = np.where(
            trim, np.minimum(pairs[:, 3].astype(np.int64) + bound + 8, flen), flen
        )
        return start, np.maximum(stop, start)

    def device_eligible(self, pairs: np.ndarray, lens: np.ndarray):
        """bool[N]: the lane's rule has a 64-position automaton and its
        clipped window fits MAX_LEN."""
        if not len(pairs):
            return np.zeros(0, dtype=bool)
        start, stop = self._windows(pairs, lens)
        return self.has_nfa[pairs[:, 1]] & (stop - start <= MAX_LEN)

    def verify_lanes(
        self, contents: list[bytes], pairs: np.ndarray, lens: np.ndarray
    ) -> np.ndarray:
        """bool[N] keep-mask for device-eligible lanes; contents[i] is the
        whole file of pairs[:, 0] == i, and a lane ships only its window."""
        n = len(pairs)
        keep = np.zeros(n, dtype=bool)
        if n == 0:
            return keep
        start, stop = self._windows(pairs, lens)
        stream = self.has_nfa[pairs[:, 1]] & (stop - start <= STREAM_TIERS[-1])
        s_idx = np.flatnonzero(stream)
        self._padded_s = 0.0
        if len(s_idx):
            self._verify_stream(contents, pairs, start, stop, s_idx, keep)
        rest = np.flatnonzero(~stream)
        if len(rest):
            self._verify_padded(contents, pairs, start, stop, rest, keep)
        if len(s_idx):
            # the padded path's seconds (overflow and non-stream lanes),
            # beside the stream's own parts
            self.stream_stats["padded_s"] = self._padded_s
        return keep

    def _rule_byte_tensors(self, r: int):
        """(follow [64, 64], accept_b [256, 64], first [64], last [64])
        float32 for rule r: raw-byte accept (class map folded in), byte 0
        forced dead; cached per rule."""
        cached = self._byte_tensor_cache.get(r)
        if cached is not None:
            return cached
        nfa = self._nfas[r]
        m = len(nfa.follow)
        follow = np.stack([_bits(int(nfa.follow[p]), m) if p < m
                           else np.zeros(64, np.float32) for p in range(64)])
        byte_masks = nfa.classmask[nfa.byte_class]  # [256] uint64
        accept_b = np.zeros((256, 64), np.float32)
        for q in range(m):
            accept_b[:, q] = ((byte_masks >> np.uint64(q)) & np.uint64(1)).astype(np.float32)
        accept_b[0, :] = 0.0  # 0x00 = the universal dead separator
        out = (follow, accept_b, _bits(int(nfa.first), m), _bits(int(nfa.last), m))
        self._byte_tensor_cache[r] = out
        return out

    def _verify_stream(self, contents, pairs, start, stop, s_idx, keep) -> None:
        """Ledger the call's stacked rule words ("verify-stream") for
        exactly the call, even when a dispatch raises."""
        mw: list = []
        try:
            self._verify_stream_impl(contents, pairs, start, stop, s_idx, keep, mw)
        finally:
            for h in mw:
                h.release()

    def _verify_stream_impl(self, contents, pairs, start, stop, s_idx, keep, mw) -> None:
        """Multi-rule stream dispatch (the reference's `_verify_stream_impl`):
        pair (f, r) survives iff rule r's flag is set in a 32-byte block
        overlapping the pair's window inside the file's span."""
        depth = default_depth()
        tiers = STREAM_TIERS
        fused = bool(self.fused)
        st = self.stream_stats = {
            "lanes": int(len(s_idx)), "span_bytes": 0,
            "rows": [0] * len(tiers),
            "rules": 0, "dispatches": 0, "overflow_lanes": 0,
            "assemble_s": 0.0, "dispatch_s": 0.0, "fetch_map_s": 0.0,
            "pipeline_depth": depth, "h2d_overlap_s": 0.0,
            "fetch_bytes_raw": 0, "fetch_bytes": 0,
            "backend": "fused" if fused else "stream",
            "sieve_kernel": self.sieve_kernel_id,
        }
        compact_fetch = link_mod.d2h_compaction_enabled()
        t_asm = time.perf_counter()

        # distinct rules on the stream, most-claimed first; rules beyond the
        # largest stack go to the padded path
        rvals, rcounts = np.unique(pairs[s_idx, 1], return_counts=True)
        if len(rvals) > RULE_STACK_BUCKETS[-1]:
            keep_rules = rvals[np.argsort(-rcounts)[: RULE_STACK_BUCKETS[-1]]]
        else:
            keep_rules = rvals
        slot_rules = np.sort(keep_rules)  # stack slot i runs rule slot_rules[i]
        st["rules"] = len(slot_rules)
        slot_of = np.full(int(rvals[-1]) + 1, -1, dtype=np.int32)
        slot_of[slot_rules] = np.arange(len(slot_rules), dtype=np.int32)

        order = s_idx[np.argsort(pairs[s_idx, 0], kind="stable")]
        slots = slot_of[pairs[order, 1]]
        asm = assemble_spans(contents, pairs[order, 0], slots, start[order], stop[order])
        overflow = order[asm.overflow]  # lanes for the padded path
        # per tier, its placed lanes' columns (lane id, row, slot, b0, b1) in
        # file order, so rows ascend
        by_tier = []
        for tier in range(len(tiers)):
            m = asm.tier == tier
            by_tier.append((order[m], asm.row[m], slots[m], asm.b0[m], asm.b1[m]))
        st["span_bytes"] = asm.span_bytes
        st["rows"] = [len(r) for r in asm.rows]
        st["overflow_lanes"] = len(overflow)
        dt = time.perf_counter() - t_asm
        st["assemble_s"] = dt
        self.stats.verify_assemble_s += dt
        self.stats.verify_assemble_lanes += st["lanes"] - len(overflow)
        obs_trace.add_span("verify.assemble", t_asm, dt)

        def _chunk_lanes(tier, row_lo, row_hi):
            """The columns of `tier`'s lanes in rows [row_lo, row_hi)."""
            cols = by_tier[tier]
            p, q = np.searchsorted(cols[1], (row_lo, row_hi))
            return [c[p:q] for c in cols]

        flush_rows = STREAM_GROUP_BUCKETS[-1] * LANES_PER_GROUP
        # a meshed dispatch keeps at least 8 groups (rounded up to the lanes)
        group_buckets = GROUP_BUCKETS if self.mesh is not None else STREAM_GROUP_BUCKETS
        lanes_dev = self._lanes()
        stack = None
        stacks: dict[torch.device, NfaStack] = {}  # the stack replicated a device
        in_flight: deque = deque()
        fetched: list[tuple] = []

        def _build_stack():
            nonlocal stack
            rb = next((b for b in RULE_STACK_BUCKETS if len(slot_rules) <= b),
                      RULE_STACK_BUCKETS[-1])
            fol = np.zeros((rb, 64, 64), np.float32)
            acc = np.zeros((rb, 256, 64), np.float32)
            fst = np.zeros((rb, 64), np.float32)
            lst = np.zeros((rb, 64), np.float32)
            for slot, r in enumerate(slot_rules):
                fol[slot], acc[slot], fst[slot], lst[slot] = self._rule_byte_tensors(int(r))
            stack = NfaStack.build(fol, acc, fst, lst, self.device)
            for dev in dict.fromkeys(lanes_dev):
                stacks[dev] = stack if dev == self.device else dataclasses.replace(
                    stack, words=stack.words.to(dev), table=stack.table.to(dev))
                mw.append(memwatch.track("verify-stream", stack.nbytes, device=str(dev)))

        def _fetch_one():
            ent = in_flight.popleft()
            tf = time.perf_counter()
            if ent[0] == "fused":
                # the d2h is the packed keep-mask, one per lane shard, each
                # shard's bits placed back at its lanes; verdicts apply at once
                _, lane_ids, parts, raw_b = ent
                mask = np.zeros(len(lane_ids), dtype=bool)
                got_b = 0
                with obs_trace.span("verify.fetch", lanes=len(lane_ids)):
                    faults.fire("nfa.fetch")
                    for sel, out in parts:
                        bits, _, got = link_mod.fetch_mask_packed(out, raw_b)
                        got_b += got
                        if sel is None:
                            mask = bits[: len(lane_ids)]
                        else:
                            mask[sel] = bits[: len(sel)]
                keep[lane_ids[mask]] = True
            else:
                _, tier_, lo_, hi_, outs = ent
                raw_b = got_b = 0
                shards = []
                with obs_trace.span("verify.fetch", rows=hi_ - lo_):
                    faults.fire("nfa.fetch")
                    for out in outs:  # one a lane shard, in row order
                        if compact_fetch:
                            part, raw, got = link_mod.fetch_stream_packed(out)
                        else:
                            part = out.cpu().numpy()
                            raw = got = part.nbytes
                        shards.append(part)
                        raw_b += raw
                        got_b += got
                packed = shards[0] if len(shards) == 1 else np.concatenate(shards, axis=1)
                fetched.append((tier_, lo_, hi_, packed))
            st["fetch_bytes_raw"] += raw_b
            st["fetch_bytes"] += got_b
            dtf = time.perf_counter() - tf
            st["fetch_map_s"] += dtf
            if in_flight:  # later dispatches ran while we waited
                st["h2d_overlap_s"] += dtf

        def _flush_range(tier, row_lo, row_hi):
            """Dispatch rows [row_lo, row_hi) of `tier` in group-bucket
            chunks, fetching the oldest results once `depth` are in flight;
            fused mode attaches each chunk's lane table."""
            td = time.perf_counter()
            with obs_trace.span("verify.dispatch", tier=tier, rows=row_hi - row_lo):
                if stack is None:
                    _build_stack()
                length = tiers[tier]
                lo_blocks = length // STREAM_BLOCK
                gi = row_lo
                while gi < row_hi:
                    remaining = -(-(row_hi - gi) // LANES_PER_GROUP)
                    gcap = self._group_cap(remaining, group_buckets)
                    lo = gi
                    hi = min(lo + gcap * LANES_PER_GROUP, row_hi)
                    gi = hi
                    rows_arr = asm.rows[tier][lo:hi]
                    if hi - lo < gcap * LANES_PER_GROUP:  # the range's last chunk
                        rows_arr = np.zeros((gcap * LANES_PER_GROUP, length), dtype=np.uint8)
                        rows_arr[: hi - lo] = asm.rows[tier][lo:hi]
                    if fused:
                        lane_ids, rows_l, slots_l, b0_l, b1_l = _chunk_lanes(tier, lo, hi)
                        n_l = len(lane_ids)
                        if n_l == 0:
                            continue  # rows carried no lanes
                        npad = max(8, 1 << (n_l - 1).bit_length())
                        table = np.zeros((4, npad), np.int32)
                        table[0, :n_l] = rows_l - lo
                        table[1, :n_l] = slots_l
                        table[2, :n_l] = b0_l
                        table[3, :n_l] = b1_l
                        faults.fire("nfa.dispatch")
                        shards = self._shards("stream_bytes", rows_arr)
                        indexed = []  # (lanes' positions, rows, LaneIndex) a shard
                        r0 = 0
                        for rows_dev in shards:
                            dev = rows_dev.device
                            if len(shards) == 1:
                                sel, sub = None, table
                            else:
                                # this lane's lanes, rows rebased to its slice
                                rows_l = table[0, :n_l]
                                sel = np.flatnonzero((rows_l >= r0)
                                                     & (rows_l < r0 + len(rows_dev)))
                                k = len(sel)
                                sub = np.zeros((4, max(8, 1 << max(k - 1, 0).bit_length())),
                                               np.int32)
                                sub[:, :k] = table[:, sel]
                                sub[0, :k] -= r0
                            indexed.append((sel, rows_dev, LaneIndex.build(
                                sub, len(rows_dev), lo_blocks, stacks[dev].width, dev)))
                            r0 += len(rows_dev)
                        # the phase holds the launches alone, the uploads before it
                        ph = obs_metrics.device_phase("verify.fused")
                        parts = [(sel, nfa_stream_verdict(rows_dev, stacks[rows_dev.device],
                                                          lanes))
                                 for sel, rows_dev, lanes in indexed]
                        ph.done([out for _, out in parts])
                        # what the legacy flag-map fetch would have moved
                        raw_b = -(-stack.rb // 8) * lo_blocks * gcap * LANES_PER_GROUP
                        in_flight.append(("fused", lane_ids, parts, raw_b))
                    else:
                        faults.fire("nfa.dispatch")
                        shards = self._shards("stream_bytes", rows_arr)
                        ph = obs_metrics.device_phase("verify-stream")
                        outs = [nfa_stream(rows_dev, stacks[rows_dev.device])
                                for rows_dev in shards]
                        ph.done(outs)
                        in_flight.append(("stream", tier, lo, hi, outs))
                    st["dispatches"] += 1
                    while len(in_flight) > depth:
                        _fetch_one()
            dt = time.perf_counter() - td
            st["dispatch_s"] += dt
            self.stats.verify_dispatch_s += dt

        if not any(st["rows"]) and not len(overflow):
            return
        if not any(st["rows"]):
            self._verify_padded(contents, pairs, start, stop, overflow, keep)
            return
        # each tier's rows in blocks of the largest group bucket, then the rest
        for tier, n_rows in enumerate(st["rows"]):
            for lo in range(0, n_rows, flush_rows):
                _flush_range(tier, lo, min(lo + flush_rows, n_rows))

        # overflow lanes run on the padded path while the stream dispatches
        # above are still in flight
        if len(overflow):
            self._verify_padded(contents, pairs, start, stop, overflow, keep)
        while in_flight:
            _fetch_one()

        t0 = time.perf_counter()
        for tier, row_lo, row_hi, packed in fetched:
            # packed: [ceil(R/8), rows, Lo] uint8
            mlane, mrow, mslot, mb0, mb1 = _chunk_lanes(tier, row_lo, row_hi)
            if not len(mlane):
                continue
            rows_rel = mrow - row_lo
            cs = np.zeros((packed.shape[1], packed.shape[2] + 1), dtype=np.uint16)
            for slot in np.unique(mslot):
                sm = mslot == slot
                bits = (packed[slot // 8] >> (slot % 8)) & 1
                np.cumsum(bits, axis=1, dtype=np.uint16, out=cs[:, 1:])
                rr = rows_rel[sm]
                hit = cs[rr, mb1[sm]] > cs[rr, mb0[sm]]
                keep[mlane[sm][hit]] = True
        st["fetch_map_s"] += time.perf_counter() - t0

    def _verify_padded(self, contents, pairs, start, stop, lane_idx, keep) -> None:
        """Bucket-padded dispatch for jumbo windows, NUL-bearing spans and
        overflow rules (`_verify_padded_impl`), under a `verify.padded`
        span."""
        t0 = time.perf_counter()
        with obs_trace.span("verify.padded", lanes=len(lane_idx)):
            self._verify_padded_impl(contents, pairs, start, stop, lane_idx, keep)
        self._padded_s += time.perf_counter() - t0

    def _verify_padded_impl(self, contents, pairs, start, stop, lane_idx, keep) -> None:
        """Lanes sort by (window bucket, rule), pack as class ids into
        [G, LANES_PER_GROUP] groups per length bucket, one K6 launch per
        (bucket, group chunk); launches queue first, verdicts are fetched
        after."""
        wlen = stop - start
        bucket = np.searchsorted(np.array(LEN_BUCKETS), wlen, side="left")
        order = lane_idx[np.lexsort((pairs[lane_idx, 1], bucket[lane_idx]))]
        in_flight: list[tuple[list[np.ndarray], list[torch.Tensor]]] = []
        pos = 0
        while pos < len(order):
            bk = bucket[order[pos]]
            end = pos
            while end < len(order) and bucket[order[end]] == bk:
                end += 1
            lanes = order[pos:end]
            pos = end
            length = LEN_BUCKETS[bk]
            # split the bucket's lanes into per-rule groups of Bg
            groups: list[np.ndarray] = []
            gstart = 0
            rules = pairs[lanes, 1]
            for i in range(1, len(lanes) + 1):
                if i == len(lanes) or rules[i] != rules[gstart]:
                    for off in range(gstart, i, LANES_PER_GROUP):
                        groups.append(lanes[off : min(off + LANES_PER_GROUP, i)])
                    gstart = i
            gi = 0
            while gi < len(groups):
                gcap = self._group_cap(len(groups) - gi, GROUP_BUCKETS)
                chunk = groups[gi : gi + gcap]
                gi += gcap
                classes = np.zeros((gcap, LANES_PER_GROUP, length), dtype=np.uint8)
                gids = np.zeros(gcap, dtype=np.int32)
                for g, lane_arr in enumerate(chunk):
                    r = int(pairs[lane_arr[0], 1])
                    gids[g] = r
                    lut = self.luts[r]
                    for b, li in enumerate(lane_arr):
                        data = np.frombuffer(
                            contents[int(pairs[li, 0])], dtype=np.uint8
                        )[start[li] : stop[li]]
                        classes[g, b, : len(data)] = lut[data]
                # the group axis splits over the lanes, one K6 launch a lane
                outs = [nfa_padded(c, g, self._device_tables(c.device))
                        for c, g in zip(self._shards("padded_classes", classes),
                                        self._shards("padded_classes", gids))]
                in_flight.append((chunk, outs))
        for chunk, outs in in_flight:
            matched = np.concatenate([o.cpu().numpy() for o in outs])
            for g, lane_arr in enumerate(chunk):
                keep[lane_arr] = matched[g, : len(lane_arr)]


def build_rule_stack(verifier: GpuNfaVerifier) -> dict[str, np.ndarray]:
    """Stacked uint8 per-rule byte tensors (the reference registry's
    `vstack_*` arrays, equal to `trivy_tpu`'s `build_rule_stack`): every
    stream-eligible rule's raw-byte automaton, so a verifier can be seeded
    with `rule_stack=` instead of building them rule by rule."""
    r = verifier.num_rules
    out = {
        "vstack_has": np.zeros(r, np.uint8),
        "vstack_follow": np.zeros((r, 64, 64), np.uint8),
        "vstack_accept_b": np.zeros((r, 256, 64), np.uint8),
        "vstack_first": np.zeros((r, 64), np.uint8),
        "vstack_last": np.zeros((r, 64), np.uint8),
    }
    for i in range(r):
        if verifier._nfas[i] is None:
            continue
        fol, acc, fst, lst = verifier._rule_byte_tensors(i)
        out["vstack_has"][i] = 1
        out["vstack_follow"][i] = fol.astype(np.uint8)
        out["vstack_accept_b"][i] = acc.astype(np.uint8)
        out["vstack_first"][i] = fst.astype(np.uint8)
        out["vstack_last"][i] = lst.astype(np.uint8)
    return out
