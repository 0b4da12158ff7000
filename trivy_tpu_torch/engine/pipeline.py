"""Bounded-depth chunk pipeline: overlap h2d staging, device exec, d2h fetch.

A port of `trivy_tpu/engine/pipeline.py`.  A scan batch larger than the top
row bucket splits into fixed-bucket chunks, and three stages stay in flight
at once —

  stage   host encode of chunk N+1 and its H2D copy, issued on a side CUDA
          stream from a ring of pinned host buffers (`RowStager`), never
          waited on before exec needs the rows
  exec    the kernels of chunk N on the current stream, ordered after the
          copy by an event (`wait_staged`)
  finish  what the engine does once chunk N-1 is done (the fused path
          keeps hit words on the device and only files them in residency)

`ChunkPipeline` (copied verbatim) is the small scheduler the engine drives.
Depth is bounded (default 2 chunks in flight beyond the one being
finished) so host and device memory stay O(depth * chunk), and a chunk that
raises drains the pipeline cleanly: queued work is cancelled, the in-flight
tail is dropped, and the exception propagates.

`ResidentChunkCache` is the companion device-side dedupe: a bounded LRU of
results keyed by packed-chunk content digest, so a rescan of a
mostly-unchanged corpus ships only changed rows across the link.
`ResidentRowStore` keeps the STAGED row tensors themselves (plus their hit
words, or the megakernel's verdict mask) device-resident under the same
digest-keyed LRU discipline, ledgered in memwatch as "resident-rows".

On a mesh (`mesh/`), `stage_rows` splits a chunk row-wise into one shard
per lane, each staged by that lane's own `RowStager` (its side stream and
pinned ring on its device), and ledgers each lane's real rows in the
occupancy ledger and its bytes in memwatch.
"""


from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.mesh.plan import Sharded, lane_bounds, sharding_for
from trivy_tpu_torch.obs import memwatch
from trivy_tpu_torch.obs import trace as obs_trace

DEFAULT_DEPTH = 2
DEFAULT_RESIDENT_CHUNKS = 32
# memwatch component of staged chunks, ledgered from stage to finish
STAGING_COMPONENT = "pipeline-staging"


def default_depth() -> int:
    """Pipeline depth: chunks staged/executing beyond the one finishing.
    1 = fully serial (stage, exec, finish each chunk before the next).
    TRIVY_TPU_PIPELINE_DEPTH overrides (bench serial-vs-pipelined A/B)."""
    try:
        return max(1, int(os.environ.get("TRIVY_TPU_PIPELINE_DEPTH", "")))
    except ValueError:
        return DEFAULT_DEPTH


@dataclass
class PipelineStats:
    """Per-run accounting, merged into SieveStats by the engines."""

    depth: int = 0
    chunks: int = 0
    stage_s: float = 0.0  # host-side issue cost of staging (async h2d)
    finish_s: float = 0.0  # d2h fetch + host confirm
    # Finish time during which >= 1 LATER chunk was staged or executing —
    # the transfer/compute wall-clock the pipeline actually hid.  Serial
    # depth=1 runs report 0 here by construction.
    h2d_overlap_s: float = 0.0


class ChunkPipeline:
    """Three-stage bounded scheduler over an ordered chunk sequence.

    stage(chunk)            -> staged   issue async work (H2D copy / worker
                                        submit); must not block on the device
    execute(chunk, staged)  -> handle   issue the async device exec (or pass
                                        `staged` through for host pipelines)
    finish(chunk, handle)   -> None     block on the handle, fetch, confirm

    Chunks finish strictly in submission order (engines write results into
    order-indexed slots, and the hybrid's oracle confirm must see files in
    corpus order for byte-identical findings).  `cancel(chunk, handle)` is
    called for never-finished in-flight chunks when a stage raises.
    """

    def __init__(
        self,
        stage: Callable,
        execute: Callable,
        finish: Callable,
        depth: int | None = None,
        cancel: Callable | None = None,
    ):
        self._stage = stage
        self._execute = execute
        self._finish = finish
        self._cancel = cancel
        self.stats = PipelineStats(depth=depth or default_depth())

    def run(self, chunks: Iterable) -> None:
        with obs_trace.span("pipeline", depth=self.stats.depth) as sp:
            self._run(chunks)
            sp.set(
                chunks=self.stats.chunks,
                h2d_overlap_s=round(self.stats.h2d_overlap_s, 4),
            )

    def _run(self, chunks: Iterable) -> None:
        depth = self.stats.depth
        inflight: deque = deque()
        try:
            for chunk in chunks:
                while len(inflight) >= depth:
                    self._finish_one(inflight)
                t0 = time.perf_counter()
                staged = self._stage(chunk)
                self.stats.stage_s += time.perf_counter() - t0
                inflight.append((chunk, self._execute(chunk, staged)))
                self.stats.chunks += 1
            while inflight:
                self._finish_one(inflight)
        except BaseException:
            # Drain cleanly: drop (and cancel) whatever is still in flight
            # so the caller's partial results stay consistent and worker
            # pools shut down without finishing abandoned chunks.
            if self._cancel is not None:
                for chunk, handle in inflight:
                    try:
                        self._cancel(chunk, handle)
                    except Exception:  # graftlint: swallow(best-effort cancel mid-drain; outer raise carries the cause)
                        pass
            inflight.clear()
            raise

    def _finish_one(self, inflight: deque) -> None:
        chunk, handle = inflight.popleft()
        overlapped = len(inflight) > 0  # later chunks staged/executing now
        t0 = time.perf_counter()
        self._finish(chunk, handle)
        dt = time.perf_counter() - t0
        self.stats.finish_s += dt
        if overlapped:
            self.stats.h2d_overlap_s += dt


def chunk_digest(buf) -> str:
    """Content digest of a packed chunk (any buffer-protocol object);
    keys the ResidentChunkCache the way blob digests key ArtifactCache."""
    return hashlib.blake2b(memoryview(buf), digest_size=16).hexdigest()


class RowStager:
    """H2D staging of packed row chunks onto one device.

    On a CUDA device: a ring of `depth + 1` pinned host buffers (each grown
    to the largest chunk it has held, one top-bucket chunk in practice) and
    one side stream.  `stage_rows` copies the chunk into the next ring slot
    and issues a `non_blocking` copy into a fresh device tensor on the side
    stream, then records an event there; the caller's kernels wait on that
    event (`wait_staged`), so the copy of chunk N+1 overlaps the kernels of
    chunk N.  A slot is written again only after its last copy's event has
    completed: a later chunk's bytes must never race the DMA still reading
    the slot.  Device tensors come fresh from the caching allocator for
    every chunk and are never recycled here: a resident store may hold
    them, and its entries must stay the rows exactly as shipped.

    On the CPU: the chunk as a tensor over the same memory, no streams and
    no pinning.
    """

    def __init__(self, device: torch.device, depth: int):
        self.device = torch.device(device)
        self.stream = None
        self._slots: list[tuple[torch.Tensor, torch.cuda.Event] | None] = []
        self._next = 0
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self._slots = [None] * (max(1, depth) + 1)

    def stage_rows(self, buf: np.ndarray):
        """(rows tensor on the device, ready event or None on the CPU)."""
        buf = np.ascontiguousarray(buf, dtype=np.uint8)
        if self.stream is None:
            return torch.from_numpy(buf), None
        i = self._next
        self._next = (i + 1) % len(self._slots)
        host = None
        if self._slots[i] is not None:
            host, copied = self._slots[i]
            copied.synchronize()  # the slot's previous DMA has read it
            if host.numel() < buf.nbytes:
                host = None
        if host is None:
            host = torch.empty(buf.nbytes, dtype=torch.uint8, pin_memory=True)
        src = host[: buf.nbytes]
        np.copyto(src.numpy().reshape(buf.shape), buf)
        with torch.cuda.stream(self.stream):
            dev = src.view(buf.shape).to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self._slots[i] = (host, copied)
        return dev, copied


def wait_staged(rows, ready):
    """Order the current stream after a staged chunk's copy and tell the
    caching allocator the rows are used there (`record_stream`), so their
    memory is not handed out again while its kernels still read it.  A CPU
    chunk (`ready` None) passes through; a `Sharded` chunk waits lane by
    lane on its tuple of events."""
    if isinstance(rows, Sharded):
        if ready is not None:
            for shard, ev in zip(rows.shards, ready):
                wait_staged(shard, ev)
        return rows
    if ready is not None:
        stream = torch.cuda.current_stream(rows.device)
        stream.wait_event(ready)
        rows.record_stream(stream)
    return rows


class StagingHandles:
    """Release-once group over the per-lane memwatch handles of one staged
    chunk: the pipeline's finish and cancel sites hold one handle per chunk
    however many lanes it landed on."""

    __slots__ = ("_handles",)

    def __init__(self, handles):
        self._handles = tuple(handles)

    def release(self) -> None:
        for h in self._handles:
            h.release()
        self._handles = ()


def lane_stagers(mesh, device, depth: int) -> list[RowStager]:
    """One `RowStager` per mesh lane (one for `device` without a mesh)."""
    devices = mesh.devices if mesh is not None else (device,)
    return [RowStager(d, depth) for d in devices]


def stage_rows(buf: np.ndarray, stagers: list[RowStager], mesh=None,
               real_rows: int | None = None):
    """H2D-stage one packed row chunk; returns (rows, ready, handles).

    Unmeshed: one copy through `stagers[0]`, exactly the staging the
    pipeline always did.
    Meshed: the chunk splits row-wise into one shard per lane, each staged
    by its lane's stager (`stagers[i]`, from `lane_stagers`), so a lane's
    copy overlaps the other lanes' work; `rows` is a `Sharded` laid out as
    the plan's "coded_rows" and `ready` the lanes' events.  Each lane's
    bytes are memwatch-ledgered under its tag as "pipeline-staging" (the
    caller releases `handles` once the chunk is done with), and the
    occupancy ledger records each lane's REAL row share (`real_rows` leaves
    out bucket padding).  A chunk whose rows do not split evenly over the
    lanes stages unsharded rather than fail."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    rows = buf.shape[0]
    n = mesh_topology.mesh_device_count(mesh)
    bounds = lane_bounds(rows, n) if n > 1 else None
    if bounds is not None:
        real_rows = rows if real_rows is None else real_rows
        shards, events, handles = [], [], []
        for (lo, hi), stager, tag in zip(bounds, stagers, mesh.tags):
            part = buf[lo:hi]
            dev, ready = stager.stage_rows(part)
            shards.append(dev)
            events.append(ready)
            mesh_topology.record_occupancy(tag, max(0, min(hi, real_rows) - lo), part.nbytes)
            handles.append(memwatch.track(STAGING_COMPONENT, part.nbytes, device=tag))
        placed = Sharded(shards, sharding_for(mesh, "coded_rows").axis, mesh.tags)
        ready = None if all(e is None for e in events) else tuple(events)
        return placed, ready, StagingHandles(handles)
    dev, ready = stagers[0].stage_rows(buf)
    handle = memwatch.track(STAGING_COMPONENT, buf.nbytes, device=str(stagers[0].device))
    return dev, ready, StagingHandles([handle])


def shard_nbytes(value) -> dict[str, int]:
    """Per-lane byte map of the `Sharded` tensors in `value` (a tensor or a
    tuple of them); {} when nothing in it is sharded."""
    out: dict[str, int] = {}
    if isinstance(value, (tuple, list)):
        for v in value:
            for tag, nb in shard_nbytes(v).items():
                out[tag] = out.get(tag, 0) + nb
    elif isinstance(value, Sharded):
        for tag, shard in zip(value.tags, value.shards):
            out[tag] = out.get(tag, 0) + shard.nbytes
    return out


def _device_tag(value) -> str:
    """Device of the first tensor in a (tuple of) tensors, as "cuda:0" or
    "cpu"; "" (memwatch's default device) when there is none."""
    if isinstance(value, (tuple, list)):
        for v in value:
            tag = _device_tag(v)
            if tag:
                return tag
        return ""
    dev = getattr(value, "device", None)
    return str(dev) if dev is not None else ""


class ResidentChunkCache:
    """Bounded LRU of per-chunk sieve results keyed by chunk digest.

    The device-resident analogue of the blob-level ArtifactCache: a rescan
    whose packed chunks digest identically never re-ships those rows (the
    cached hit words ARE the chunk's device output, so neither the h2d
    transfer nor the dispatch happens again).  Interface mirrors
    `ArtifactCache.missing_blobs` so callers can diff before staging.
    """

    def __init__(self, capacity: int | None = None,
                 component: str = "chunk-cache"):
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("TRIVY_TPU_RESIDENT_CHUNKS", "")
                )
            except ValueError:
                capacity = DEFAULT_RESIDENT_CHUNKS
        self.capacity = max(0, capacity)
        self._lru: OrderedDict[str, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        # Memwatch attribution: every cached result's bytes are ledgered
        # under `component` for as long as the entry is resident.
        self._component = component
        self._mw: dict[str, object] = {}

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, digest: str):
        """Cached chunk result or None; a hit refreshes LRU order."""
        if self.capacity == 0:
            return None
        val = self._lru.get(digest)
        if val is None:
            self.misses += 1
            return None
        self._lru.move_to_end(digest)
        self.hits += 1
        return val

    def _track(self, value) -> StagingHandles:
        """Ledger one entry's bytes: sharded tensors get one handle per lane
        (the layout the entry carries), anything else one handle on the
        device its tensors live on."""
        per_lane = shard_nbytes(value)
        handles = [
            memwatch.track(self._component, nb, device=tag, owner=self)
            for tag, nb in sorted(per_lane.items())
        ]
        rest = memwatch.nbytes_of(value) - sum(per_lane.values())
        if rest > 0 or not handles:
            handles.append(memwatch.track(self._component, rest,
                                          device=_device_tag(value), owner=self))
        return StagingHandles(handles)

    def put(self, digest: str, value) -> None:
        if self.capacity == 0:
            return
        old = self._mw.pop(digest, None)
        if old is not None:
            old.release()
        self._lru[digest] = value
        self._lru.move_to_end(digest)
        self._mw[digest] = self._track(value)
        while len(self._lru) > self.capacity:
            evicted, _ = self._lru.popitem(last=False)
            mw = self._mw.pop(evicted, None)
            if mw is not None:
                mw.release()

    def missing_chunks(self, digests: Iterable[str]) -> list[str]:
        """ArtifactCache.missing_blobs shape: digests NOT resident (these
        are the rows a rescan must actually ship)."""
        return [d for d in digests if d not in self._lru]

    def clear(self) -> None:
        self._lru.clear()
        for mw in self._mw.values():
            mw.release()
        self._mw.clear()

    def nbytes(self) -> int:
        """Total resident bytes across live entries (ledger cross-check)."""
        return sum(memwatch.nbytes_of(v) for v in self._lru.values())


class ResidentRowStore(ResidentChunkCache):
    """Digest-keyed LRU of STAGED row tensors + their sieve hit words,
    both kept on the device for the fused sieve→derive path.

    Where ResidentChunkCache memoises only the sieve OUTPUT (hit words,
    so a duplicate chunk skips the dispatch), this store also retains the
    sieve INPUT rows on device so the fused verify walk can gather its
    windows in place — the re-upload the legacy path pays per verify
    dispatch never happens.  Entries are `(rows_dev, hits_dev)` tuples;
    eviction follows the same LRU + memwatch discipline as the parent
    (component "resident-rows", capacity TRIVY_TPU_RESIDENT_CHUNKS).

    Entry invariant: `rows_dev` is the uint8 staged row block exactly as
    shipped (coded or raw per the chunk's codec tag — callers key the
    digest with the tag, mirroring `_sieve_rows`'s resident-LRU key), and
    `hits_dev` the matching [rows, n_words] int32 hit words (uint32 bit
    patterns).

    Megakernel entries (engine/device.py `_mega_candidates`) reuse the
    same store with `(rows_dev, mask_dev)` tuples — the packed verdict
    mask instead of hit words — under digests additionally suffixed with
    the KERNEL id and the batch's file-interval digest.  The kernel id
    changes whenever the fused program's baked constants change (ruleset
    or codec rebake), so staged-path hit words and fused verdict masks
    can never alias each other or a stale program's output.
    """

    def __init__(self, capacity: int | None = None):
        super().__init__(capacity, component="resident-rows")

    def put_rows(self, digest: str, rows_dev, hits_dev) -> None:
        self.put(digest, (rows_dev, hits_dev))

    def rows(self, digest: str):
        """Resident (rows_dev, hits_dev) or None; refreshes LRU order."""
        return self.get(digest)
