"""K5's fused mode (`ops/nfa_verify.py` `nfa_stream_verdict`), on the CPU:
the lane index the kernel reads (`LaneIndex`) and a numpy evaluator of the
kernel's keep step (`keep_block` in `csrc/nfa_verify.cu`: a binary search of
the first lane whose reach passes the flagged block, then every lane from
there whose [b0, b1) holds it), held to `nfa_fused_verdict_plain` over the
plain K5's flags.

Lanes are packed as the engine packs them (spans one zero byte apart, so
neighbouring lanes share boundary blocks), plus nested lanes, lanes past
the live slots, rows or blocks of the launch, reversed and empty ranges
and padding.  The evaluator visits the flagged blocks segment by segment
at 1 to 128 forced segments, in reverse segment order and with the blocks
a fix-up would add last, to show that the verdict does not depend on the
order the walk reaches them.  Tolerance: exact.
"""

import bisect

import numpy as np
import pytest
import torch

from trivy_tpu_torch.ops import nfa_verify as nv

LENGTH = 4096
N_ROWS = 24


def random_stack(rb: int, seed: int):
    """Sparse random automata over 64 positions; "zz" (62 -> 63) matches."""
    rng = np.random.default_rng(seed)
    follow = (rng.random((rb, 64, 64)) < 0.03).astype(np.float32)
    accept_b = (rng.random((rb, 256, 64)) < 0.1).astype(np.float32)
    first = (rng.random((rb, 64)) < 0.05).astype(np.float32)
    last = (rng.random((rb, 64)) < 0.05).astype(np.float32)
    first[:, 62] = last[:, 63] = 1.0
    last[first > 0] = 0.0
    follow[:, 62, 63] = 1.0
    accept_b[:, ord("z"), 62:] = 1.0
    accept_b[:, 0] = 0.0
    return follow, accept_b, first, last


def packed_lanes(rng, n_rows: int, length: int, rb: int, width: int):
    """(rows [n_rows, length] uint8, lane table [4, N] int32) packed as the
    engine packs a tier: spans of 20-400 printable bytes one 0x00 apart,
    each span with 1-3 lanes of random slots and windows inside it, "zz"
    runs here and there; then nested lanes, lanes on slots past `width`,
    rows past `n_rows`, blocks past the row, a reversed and an empty
    range, and padding up to a power of two."""
    rows = np.zeros((n_rows, length), np.uint8)
    cols: list[list[int]] = [[], [], [], []]
    for r in range(n_rows):
        pos = 0
        while True:
            n = int(rng.integers(20, 400))
            if pos + n > length:
                break
            span = rng.integers(32, 127, n).astype(np.uint8)
            for p in rng.integers(0, n - 1, 2):
                span[p : p + 2] = ord("z")
            rows[r, pos : pos + n] = span
            for _ in range(int(rng.integers(1, 4))):
                a = pos + int(rng.integers(0, n))
                b = min(pos + n, a + int(rng.integers(1, 200)))
                for col, v in zip(cols, (r, int(rng.integers(0, rb)), a // 32, -(-b // 32))):
                    col.append(v)
            pos += n + 1
    table = [np.asarray(c, np.int64) for c in cols]
    k = len(table[0])
    extra = [  # row, slot, b0, b1
        (0, 0, 0, length // 32), (0, 0, 3, 5), (0, 0, 4, 40),  # nested
        (1, width, 0, length // 32), (1, rb - 1, 0, length // 32),
        (n_rows + 2, 0, 0, 4), (2, 0, length // 32 - 1, length // 32 + 9),
        (2, 1, 9, 3), (3, 1, 7, 7),
    ]
    rows_e = np.asarray(extra, np.int64).T
    lanes = np.concatenate([np.stack(table), rows_e], axis=1)
    npad = max(8, 1 << (lanes.shape[1] - 1).bit_length())
    out = np.zeros((4, npad), np.int32)
    out[:, : lanes.shape[1]] = lanes
    assert k > 100
    return rows, out


def evaluate_keep(flags: np.ndarray, index: nv.LaneIndex, n_lanes: int,
                  segments: int) -> np.ndarray:
    """keep [n_lanes / 8] uint8 as the fused kernel sets it: for each (row,
    live slot), its flagged blocks visited segment by segment (last
    segment first, and within a segment the first block last, as a fix-up
    adds blocks after the walk), each through `keep_block`'s search."""
    idx = index.index.numpy()
    n_keys = index.n_rows * index.width + 1
    m = index.n_indexed
    off = idx[:n_keys]
    b0, b1, reach, ids = (idx[n_keys + i * m : n_keys + (i + 1) * m] for i in range(4))
    keep = np.zeros(n_lanes, bool)
    n_blocks = flags.shape[2]
    seg = n_blocks // segments
    bounds = [(k * seg, (k + 1) * seg if k + 1 < segments else n_blocks)
              for k in range(segments)]
    for row in range(index.n_rows):
        for slot in range(index.width):
            bits = (flags[slot // 8, row] >> (slot % 8)) & 1
            key = row * index.width + slot
            r0, r1 = int(off[key]), int(off[key + 1])
            for j0, j1 in reversed(bounds):
                blocks = [b for b in range(j0, j1) if bits[b]]
                for b in blocks[1:] + blocks[:1]:
                    i = bisect.bisect_right(reach, b, r0, r1)
                    while i < r1 and b0[i] <= b:
                        if b1[i] > b:
                            keep[ids[i]] = True
                        i += 1
    return np.packbits(keep)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    rb = 6
    arrays = random_stack(rb, seed=2)
    arrays[0][4:] = arrays[1][4:] = arrays[2][4:] = arrays[3][4:] = 0.0  # 2 dead slots
    stack = nv.NfaStack.build(*arrays, device="cpu")
    rows, table = packed_lanes(rng, N_ROWS, LENGTH, rb, stack.width)
    rows_t = torch.from_numpy(rows)
    flags = nv.nfa_stream_plain(rows_t, *map(torch.from_numpy, arrays))
    # the plain verdict over the lanes inside the flags; the others (a row
    # past the launch) keep nothing
    inside = (table[0] < N_ROWS)[None, :]
    safe = np.where(inside, table, 0)
    safe[3] = np.minimum(safe[3], LENGTH // 32)
    want = nv.nfa_fused_verdict_plain(flags, *torch.from_numpy(safe)).numpy()
    return rows_t, stack, table, flags.numpy(), want


def test_lane_index_layout(case):
    rows, stack, table, _, _ = case
    assert stack.width == 4
    index = nv.LaneIndex.build(table, N_ROWS, LENGTH // 32, stack.width, "cpu")
    idx = index.index.numpy()
    n_keys = N_ROWS * stack.width + 1
    m = index.n_indexed
    off = idx[:n_keys]
    b0, b1, reach, ids = (idx[n_keys + i * m : n_keys + (i + 1) * m] for i in range(4))
    assert off[0] == 0 and off[-1] == m and (np.diff(off) >= 0).all()
    # every indexed lane can keep, and every lane that can keep is indexed
    row, slot = table[0], table[1]
    lo, hi = np.maximum(table[2], 0), np.minimum(table[3], LENGTH // 32)
    can = (row >= 0) & (row < N_ROWS) & (slot >= 0) & (slot < stack.width) & (lo < hi)
    assert sorted(ids) == sorted(np.flatnonzero(can))
    for key in range(n_keys - 1):
        r0, r1 = off[key], off[key + 1]
        assert (row[ids[r0:r1]] * stack.width + slot[ids[r0:r1]] == key).all()
        assert (np.diff(b0[r0:r1]) >= 0).all()
        np.testing.assert_array_equal(reach[r0:r1], np.maximum.accumulate(b1[r0:r1]))
    # neighbouring lanes share boundary blocks, and some lanes nest
    shared = sum(int((b0[i + 1] < b1[i])) for i in range(m - 1)
                 if np.searchsorted(off, i, "right") == np.searchsorted(off, i + 1, "right"))
    assert shared > 10


@pytest.mark.parametrize("segments", [1, 2, 8, 32, 128])
def test_keep_step_equals_plain_verdict(case, segments):
    rows, stack, table, flags, want = case
    index = nv.LaneIndex.build(table, N_ROWS, LENGTH // 32, stack.width, "cpu")
    got = evaluate_keep(flags, index, table.shape[1], segments)
    np.testing.assert_array_equal(got, want)
    keep = np.unpackbits(want)
    assert 10 < keep.sum() < len(keep) - 10


def test_wrapper_equals_plain_verdict_on_cpu(case):
    rows, stack, table, _, want = case
    before = dict(nv.LAUNCHES)
    index = nv.LaneIndex.build(table, N_ROWS, LENGTH // 32, stack.width, "cpu")
    for lanes, assoc in ((table, False), (torch.from_numpy(table), False), (index, True)):
        np.testing.assert_array_equal(
            nv.nfa_stream_verdict(rows, stack, lanes, assoc=assoc).numpy(), want)
    assert nv.LAUNCHES == before  # the CPU launches no kernel


def numpy_index(table: np.ndarray, n_rows: int, n_blocks: int, width: int) -> np.ndarray:
    """The index as a numpy sort computes it: the lanes that can keep,
    stably sorted by (row * width + slot, b0), with offsets, b0, b1, the
    running max of b1 within each key and the lane ids."""
    row, slot = table[0].astype(np.int64), table[1].astype(np.int64)
    b0 = np.maximum(table[2], 0).astype(np.int64)
    b1 = np.minimum(table[3], n_blocks).astype(np.int64)
    ok = (row >= 0) & (row < n_rows) & (slot >= 0) & (slot < width) & (b0 < b1)
    ids = np.flatnonzero(ok)
    key = row[ids] * width + slot[ids]
    order = np.lexsort((b0[ids], key))
    ids, key = ids[order], key[order]
    reach = np.concatenate([np.maximum.accumulate(b1[ids][key == k])
                            for k in np.unique(key)]) if len(ids) else ids
    off = np.searchsorted(key, np.arange(n_rows * width + 1), side="left")
    return np.concatenate([off, b0[ids], b1[ids], reach, ids]).astype(np.int32)


@pytest.mark.parametrize("shuffle", [False, True], ids=["engine_order", "shuffled"])
def test_native_build_equals_numpy_sort(case, shuffle):
    """`LaneIndex.build` (the native counting sort) gives the index a
    numpy sort gives, for lanes in the engine's order and shuffled (keys
    out of order, equal b0 within a key), and with many lanes in one key."""
    _, stack, table, _, _ = case
    rng = np.random.default_rng(11)
    table = table.copy()
    if shuffle:
        table = table[:, rng.permutation(table.shape[1])]
        table[:, :64] = [[1] * 64, [2] * 64, rng.integers(0, 6, 64), rng.integers(3, 12, 64)]
    index = nv.LaneIndex.build(table, N_ROWS, LENGTH // 32, stack.width, "cpu")
    want = numpy_index(table, N_ROWS, LENGTH // 32, stack.width)
    np.testing.assert_array_equal(index.index.numpy(), want)
    assert index.n_indexed == (len(want) - N_ROWS * stack.width - 1) // 4
    np.testing.assert_array_equal(index.lanes.numpy(), table)
