"""Blob packing: variable-length file contents -> fixed-shape device rows.

A copy of `trivy_tpu/scanner/packing.py` cut to what the port's engines run
(`dedupe_blobs`, `pack_dense` and its `DenseBatch.file_hits`, and the tiled
`pack` of the LUT sieve).  Instead of one worker per file
(pkg/fanal/analyzer/analyzer.go:396-448), files are packed into a
[T, row_len] uint8 matrix whose rows are processed data-parallel.
Consecutive rows overlap by `overlap` bytes so a gram never straddles a row
seam undetected; file tails are zero-padded (gram value bytes exclude 0x00,
so padding can't fire).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

DEFAULT_TILE_LEN = 4096
DEFAULT_OVERLAP = 16


@dataclass
class DedupeResult:
    """Content-digest blob dedupe: scan work runs over `unique_index` only
    and fans back out to every alias through `inverse`.

    Container layers and vendored monorepos repeat files heavily (the
    BASELINE 100k-file monorepo config is exactly this shape); identical
    blobs produce identical sieve/candidate/verify results by construction,
    so only distinct bytes need to cross the host<->device link.  Findings
    stay per-file: the byte-exact confirm still runs per (path, content)
    because path gating (allow rules, FilePath) is path-dependent.
    """

    unique_index: np.ndarray  # [U] int64 — first occurrence position per blob
    inverse: np.ndarray  # [N] int64 — original index -> unique index
    saved_bytes: int  # bytes of duplicate blobs that need not ship


    def any_duplicates(self) -> bool:
        return len(self.inverse) > len(self.unique_index)


def dedupe_blobs(contents: list[bytes]) -> DedupeResult:
    """Digest each blob once (blake2b-128 over content) and collapse
    repeats to their first occurrence.  O(total bytes) hashing at memory
    speed on the host — always cheaper than shipping a duplicate byte over
    a ~70 MB/s link."""
    seen: dict[bytes, int] = {}
    unique: list[int] = []
    inverse = np.empty(len(contents), dtype=np.int64)
    saved = 0
    for i, c in enumerate(contents):
        d = hashlib.blake2b(c, digest_size=16).digest()
        j = seen.get(d)
        if j is None:
            seen[d] = j = len(unique)
            unique.append(i)
        else:
            saved += len(c)
        inverse[i] = j
    return DedupeResult(
        unique_index=np.asarray(unique, dtype=np.int64),
        inverse=inverse,
        saved_bytes=saved,
    )



@dataclass
class PackedBatch:
    tiles: np.ndarray  # [T, tile_len] uint8
    tile_file: np.ndarray  # [T] int32 — which input blob each tile came from
    num_files: int

    def file_hits(self, tile_hits: np.ndarray) -> np.ndarray:
        """OR-combine per-tile hit bitmaps [T, Pw] into per-file bitmaps [F, Pw]."""
        pw = tile_hits.shape[1]
        out = np.zeros((self.num_files, pw), dtype=tile_hits.dtype)
        real = self.tile_file >= 0
        np.bitwise_or.at(out, self.tile_file[real], tile_hits[: len(self.tile_file)][real])
        return out


def _tile_counts(contents: list[bytes], tile_len: int, overlap: int) -> list[int]:
    stride = tile_len - overlap
    counts = []
    for c in contents:
        extra = max(len(c) + overlap - tile_len, 0)
        counts.append(1 + (-(-extra // stride) if extra else 0))
    return counts


@dataclass
class DenseBatch:
    """Zero-waste packing: files concatenated (with a small zero gap) into one
    stream, reshaped into overlapping rows.  A row may span several files;
    per-file hit attribution ORs every row overlapping the file's span (a
    sound over-approximation — neighbors in a row share candidates).
    """

    rows: np.ndarray  # [T, row_len] uint8
    file_row_lo: np.ndarray  # [F] int32 — first row overlapping the file
    file_row_hi: np.ndarray  # [F] int32 — last row (inclusive)
    num_files: int

    def file_hits(self, row_hits: np.ndarray) -> np.ndarray:
        """OR row-level hit bitmaps [T, W] into per-file bitmaps [F, W].

        Exactly ORs rows [lo_i, hi_i] per file: reduceat runs over
        interleaved (lo_i, hi_i+1) boundaries (with a zero sentinel row so
        hi+1 may reach nrows) and keeps the even segments.  End-bounding
        means rows past a file's hi — trailing padding included — never
        contribute, with no reliance on padding-can't-hit invariants.
        """
        if self.num_files == 0:
            return np.zeros((0, row_hits.shape[1]), dtype=row_hits.dtype)
        nrows = len(row_hits)
        lo = np.minimum(self.file_row_lo, nrows - 1).astype(np.int64)
        hi = self.file_row_hi
        valid = hi >= self.file_row_lo
        padded = np.concatenate(
            [row_hits, np.zeros((1, row_hits.shape[1]), row_hits.dtype)]
        )
        idx = np.empty(2 * self.num_files, dtype=np.int64)
        idx[0::2] = lo
        idx[1::2] = np.clip(hi, 0, nrows - 1) + 1
        out = np.bitwise_or.reduceat(padded, idx, axis=0)[0::2]
        out[~valid] = 0
        return out


def pack_dense(
    contents: list[bytes],
    row_len: int,
    overlap: int,
    gap: int | None = None,
) -> DenseBatch:
    """Pack files densely into overlapping rows of one byte stream.

    `overlap` must be >= probe-window - 1 so no window is lost at a row seam;
    `gap` zero bytes separate files (>= overlap stops full-window grams from
    spanning two files).
    """
    gap = overlap if gap is None else gap
    stride = row_len - overlap
    nfiles = len(contents)

    # Single C-level join builds the stream; offsets via cumsum.
    lens = np.fromiter((len(c) for c in contents), dtype=np.int64, count=nfiles)
    starts = np.zeros(nfiles, dtype=np.int64)
    if nfiles > 1:
        np.cumsum(lens[:-1] + gap, out=starts[1:])
    pos = int(starts[-1] + lens[-1] + gap) if nfiles else 0
    total = pos + overlap  # tail padding so the final windows exist

    nrows = max(1, -(-max(total - overlap, 1) // stride))
    stream = np.zeros(nrows * stride + overlap, dtype=np.uint8)
    joined = np.frombuffer((b"\x00" * gap).join(contents), dtype=np.uint8)
    stream[: len(joined)] = joined

    rows = np.lib.stride_tricks.sliding_window_view(stream, row_len)[::stride]
    assert len(rows) == nrows, (len(rows), nrows)

    ends = starts + lens
    # Windows containing any byte of the file start in [s-overlap, e).
    lo = (np.maximum(starts - overlap, 0) // stride).astype(np.int32)
    hi = np.minimum((ends - 1) // stride, nrows - 1).astype(np.int32)
    hi[lens == 0] = -1  # empty file: no rows
    return DenseBatch(
        rows=np.ascontiguousarray(rows),
        file_row_lo=lo,
        file_row_hi=hi,
        num_files=nfiles,
    )




def pack(
    contents: list[bytes],
    tile_len: int = DEFAULT_TILE_LEN,
    overlap: int = DEFAULT_OVERLAP,
    pad_tiles_to: int | None = None,
) -> PackedBatch:
    """Tile each file on its own: tiles of `tile_len` bytes overlapping by
    `overlap`, file tails zero-padded (the LUT sieve's packing)."""
    stride = tile_len - overlap
    counts = _tile_counts(contents, tile_len, overlap)
    total = sum(counts)
    t_alloc = max(pad_tiles_to, total) if pad_tiles_to is not None else total
    tiles = np.zeros((t_alloc, tile_len), dtype=np.uint8)
    tile_file = np.full(t_alloc, -1, dtype=np.int32)

    t = 0
    for fi, c in enumerate(contents):
        data = np.frombuffer(c, dtype=np.uint8)
        for k in range(counts[fi]):
            start = k * stride
            chunk = data[start : start + tile_len]
            tiles[t, : len(chunk)] = chunk
            tile_file[t] = fi
            t += 1

    return PackedBatch(tiles=tiles, tile_file=tile_file, num_files=len(contents))
