"""The packed shift-AND (LUT) probe sieve: tiles [T, L] uint8 -> probe-hit
words [T, Pw].

The port of `trivy_tpu/ops/sieve.py` `sieve_tiles` (B6), the sieve of the
reference engine's `sieve="lut"`:

    acc[t, i] = AND_{j < J} lut[j, tiles[t, i + j]]   for i < L - J + 1,
    hits[t]   = OR_i acc[t, i],

with lut [J, 256, Pw] uint32 from `ProbeSet.build_lut` (bit p of word w:
probe 32 w + p accepts the byte at offset j; all ones past a probe's
length).  `lut_sieve` launches the hand-written CUDA kernel of
`csrc/lut_sieve.cu` for a CUDA tensor and counts the launch in
`gram_sieve.LAUNCHES["lut"]`; for a CPU tensor it runs `lut_sieve_plain`.
The kernel reads the LUT over byte classes (`lut_tables`: bytes whose
columns are equal at every offset share one row), 256 probes a pass; the
plain version reads it as it is.  `lut_consts` builds both at once as one
`LutConsts`, which `LutSieve` keeps on its device.  Words are int32 tensors
holding the uint32 bit patterns.  `make_sharded_sieve` is the meshed form
(B6m): the tile axis split over the lanes, one launch a lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.ops.gram_sieve import (
    LAUNCHES,
    as_int32_bits,
    byte_classes,
    replica,
    shard_map,
)

SLICE_WORDS = 8  # probe words a kernel pass keeps: 256 probes
PLAIN_ROWS = 64  # tiles the plain version sieves at once
LUT_HEADER = 4  # words of a pass block before what the kernel stages
MAX_J = 32  # the kernel's limit on the LUT's offsets (`kMaxJ`)
# The kernel's walk (`csrc/lut_sieve.cu`; `kernel_policy` reads it back on a
# card): threads of a block, survivor slots of a warp's queue, and the steps
# a queued position takes before it is queued again.
BLOCK_THREADS, QUEUE_SLOTS, WALK = 256, 64, 4


def lut_tables(lut: np.ndarray) -> tuple[np.ndarray, tuple[tuple[int, int, int], ...]]:
    """LUT [J, 256, Pw] uint32 -> the kernel's tables, one pass per 8 probe
    words (256 probes).  Per pass, one block of uint32 words:

    * [0] C, the byte classes: bytes whose columns (the pass's words at
      every offset j) are equal, numbered as `byte_classes` does (frequent
      text bytes first); [1:4] 0;
    * [4:68] the class map, 256 uint8: byte b's class;
    * for j < J, C rows of ST = nw | 1 words (nw words in this pass; the odd
      stride keeps classes below 32 in distinct banks): row c holds
      lut[j, b, words] for the bytes b of class c, word nw zero;
    * zero words up to a multiple of 4 (blocks stay 16-byte aligned).

    Returns (the blocks concatenated, and per pass (word offset of its
    block, nw, words staged = block length - LUT_HEADER))."""
    lut = np.asarray(lut, dtype=np.uint32)
    jmax, n_sym, pw = lut.shape
    if n_sym != 256:
        raise ValueError(f"LUT must be [J, 256, Pw], got {lut.shape}")
    blocks, passes, offset = [], [], 0
    for w0 in range(0, pw, SLICE_WORDS):
        nw = min(SLICE_WORDS, pw - w0)
        cols = lut[:, :, w0 : w0 + nw]  # [J, 256, nw]
        cls, reps = byte_classes(cols.transpose(1, 0, 2))
        head = np.zeros(LUT_HEADER, dtype=np.uint32)
        head[0] = len(reps)
        rows = np.zeros((jmax, len(reps), nw | 1), dtype=np.uint32)
        rows[:, :, :nw] = cols[:, reps]
        cmap = cls.astype(np.uint8).view("<u4")
        block = np.concatenate([head, cmap, rows.reshape(-1)])
        block = np.concatenate([block, np.zeros(-len(block) % 4, dtype=np.uint32)])
        passes.append((offset, nw, len(block) - LUT_HEADER))
        blocks.append(block)
        offset += len(block)
    return np.concatenate(blocks), tuple(passes)


class LutBlock(NamedTuple):
    """One pass block of `lut_tables`, read back: `nw` probe words,
    `classes` [256] each byte's class, `table` [J, C, nw | 1] words."""

    nw: int
    classes: np.ndarray
    table: np.ndarray


def read_lut_tables(table: np.ndarray, passes, jmax: int) -> list[LutBlock]:
    """`lut_tables`' blocks (uint32 words, or their int32 bit patterns) for
    a LUT of `jmax` offsets -> one `LutBlock` a pass."""
    table = np.ascontiguousarray(table).view(np.uint32)
    out = []
    for offset, nw, staged in passes:
        block = table[offset : offset + LUT_HEADER + staged]
        c, at = int(block[0]), LUT_HEADER + 64
        classes = block[LUT_HEADER:at].view(np.uint8).astype(np.int64)
        rows = block[at : at + jmax * c * (nw | 1)].reshape(jmax, c, nw | 1)
        out.append(LutBlock(nw, classes, rows))
    return out


class LutConsts(NamedTuple):
    """One LUT in both forms, int32 bit patterns on one device: `lut` [J,
    256, Pw] for the plain version, and for the kernel `table`, the blocks
    of `lut_tables` as one tensor, with `passes` (word offset, probe words,
    staged words) of each block."""

    lut: torch.Tensor
    table: torch.Tensor
    passes: tuple[tuple[int, int, int], ...]


def lut_consts(lut: np.ndarray, device: str | torch.device) -> LutConsts:
    """LUT [J, 256, Pw] uint32 -> its `LutConsts` on `device`."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(as_int32_bits(a).copy()).to(device)

    lut = np.asarray(lut, dtype=np.uint32)
    table, passes = lut_tables(lut)
    return LutConsts(dev(lut), dev(table), passes)


def _or_reduce(a: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 1 (torch has no OR reduction): halve and OR."""
    while a.shape[1] > 1:
        half = a.shape[1] // 2
        rest = a[:, 2 * half :]
        a = a[:, :half] | a[:, half : 2 * half]
        if rest.shape[1]:
            a = torch.cat([a[:, :1] | rest, a[:, 1:]], dim=1)
    return a[:, 0]


def lut_sieve_plain(tiles: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain B6: the reference's J gathers and ANDs, PLAIN_ROWS tiles at a
    time so the [rows, L - J + 1, Pw] intermediate stays bounded."""
    t, length = tiles.shape
    jmax, _, pw = lut.shape
    lv = length - jmax + 1
    idx = tiles.long()
    out = torch.zeros((t, pw), dtype=torch.int32, device=tiles.device)
    for r0 in range(0, t, PLAIN_ROWS):
        rows = idx[r0 : r0 + PLAIN_ROWS]
        acc = lut[0][rows[:, :lv]]
        for j in range(1, jmax):
            acc &= lut[j][rows[:, j : j + lv]]
        out[r0 : r0 + PLAIN_ROWS] = _or_reduce(acc)
    return out


def walk_steps(tiles: torch.Tensor, lut: torch.Tensor) -> tuple[int, int]:
    """The steps of the kernel's walk on these tiles, for a LUT [J, 256, Pw]
    of one pass (Pw <= 8): `live`, the (position, step) pairs its early exit
    takes (every position's step 0, and step j while its AND over steps < j
    is non-zero), and `issued`, the steps its warps issue x 32 lanes: steps
    0 and 1 of every slot of every round (the ragged last round's too), and
    for each batch drained from a warp's queue the most steps a lane of it
    took (at most WALK), the queue modelled as the kernel keeps it:
    survivors pushed in lane order, the top 32 taken further whenever 32
    wait and the live ones pushed again, the rest drained likewise at the
    tile's end."""
    t, length = tiles.shape
    jmax = lut.shape[0]
    lv = length - jmax + 1
    rounds = -(-lv // BLOCK_THREADS)
    idx = tiles.long()
    live = 0
    walks = torch.full((t, rounds * BLOCK_THREADS), -1, dtype=torch.int32,
                       device=tiles.device)
    for r0 in range(0, t, 512):
        rows = idx[r0 : r0 + 512]
        acc = lut[0][rows[:, :lv]]
        live += acc.shape[0] * lv
        steps = torch.zeros(acc.shape[:2], dtype=torch.int32, device=tiles.device)
        queued = None
        for j in range(1, jmax):
            alive = (acc != 0).any(-1)
            live += int(alive.sum())
            if j == 2:
                queued = alive
            if j >= 2:
                steps += alive.int()
            acc &= lut[j][rows[:, j : j + lv]]
        if queued is not None:
            walks[r0 : r0 + 512, :lv] = torch.where(queued, steps, -1)
    warps = BLOCK_THREADS // 32
    issued = 32 * t * warps * rounds * min(jmax, 2)
    # [tile, round, warp, lane] -> one row of rounds x 32 lanes a warp
    warp_walks = walks.view(t, rounds, warps, 32).transpose(1, 2).reshape(-1, rounds, 32)
    n_warps = len(warp_walks)
    # the steps each queued position has left; the last column a dump slot
    stack = torch.zeros((n_warps, QUEUE_SLOTS + 1), dtype=torch.int32, device=tiles.device)
    count = torch.zeros(n_warps, dtype=torch.int64, device=tiles.device)
    lanes = torch.arange(32, device=tiles.device)
    longest = 0

    def push(left, alive):
        nonlocal count
        slot = torch.where(alive, count[:, None] + alive.cumsum(1) - alive.long(),
                           QUEUE_SLOTS)
        stack.scatter_(1, slot, left)
        count = count + alive.sum(1)

    def drain(n):  # the top n[w] slots of each warp w
        nonlocal count, longest
        has = lanes < n[:, None]
        top = (count[:, None] - n[:, None] + lanes).clamp(0, QUEUE_SLOTS)
        left = torch.where(has, stack.gather(1, top), 0)
        longest += int(left.clamp(max=WALK).max(1).values.sum())
        count = count - n
        push(left - WALK, has & (left > WALK))

    for r in range(rounds):
        w = warp_walks[:, r]
        push(w, w >= 0)
        while bool((count >= 32).any()):
            drain(torch.where(count >= 32, 32, 0))
    while bool((count > 0).any()):
        drain(count.clamp(max=32))
    return live, issued + 32 * longest


def _check(tiles: torch.Tensor, consts: LutConsts) -> None:
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError(f"tiles must be a 2-D uint8 tensor, got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")
    lut, table, passes = consts
    if lut.dtype != torch.int32 or lut.dim() != 3 or lut.shape[1] != 256:
        raise ValueError(f"lut must be [J, 256, Pw] int32, got {lut.dtype} "
                         f"{tuple(lut.shape)}")
    jmax, _, pw = lut.shape
    end = passes[-1][0] + passes[-1][2] + LUT_HEADER
    if (tuple(table.shape) != (end,) or table.dtype != torch.int32
            or not table.is_contiguous() or sum(p[1] for p in passes) != pw):
        raise ValueError(f"table must be the contiguous int32 blocks of lut_tables, "
                         f"{end} words for {pw} probe words")
    if not 1 <= jmax <= tiles.shape[1]:
        raise ValueError(f"tiles of {tiles.shape[1]} bytes are shorter than J={jmax}")
    for name, c in (("lut", lut), ("table", table)):
        if c.device != tiles.device:
            raise ValueError(f"{name} on {c.device}, tiles on {tiles.device}")


def lut_sieve(tiles: torch.Tensor, consts: LutConsts) -> torch.Tensor:
    """B6 on `tiles`' device: the CUDA kernel on a card (which reads
    `consts.table`, one launch a pass of 256 probes, counted once), the
    plain version on the CPU (`consts.lut`)."""
    _check(tiles, consts)
    if tiles.device.type == "cpu":
        return lut_sieve_plain(tiles, consts.lut)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    if consts.lut.shape[0] > MAX_J:
        raise ValueError(f"the kernel takes J <= {MAX_J}, got {consts.lut.shape[0]}")
    from trivy_tpu_torch.ops import _build

    tiles = tiles.contiguous()
    t, length = tiles.shape
    jmax, _, pw = consts.lut.shape
    out = torch.empty((t, pw), dtype=torch.int32, device=tiles.device)
    fn = _build.function("lut_sieve", "lut_sieve", "piipiiiiipp")
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        for w0, (offset, nw, staged) in zip(range(0, pw, SLICE_WORDS), consts.passes):
            err = fn(tiles.data_ptr(), t, length, consts.table.data_ptr() + 4 * offset,
                     jmax, nw, staged, pw, w0, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"lut_sieve launch failed: cudaError {err}")
    LAUNCHES["lut"] += 1
    return out


def blocks_per_sm(consts: LutConsts, length: int) -> int:
    """Blocks of the LUT sieve's first pass one SM of the current card holds
    at once, for tiles of `length` bytes."""
    from trivy_tpu_torch.ops import _build

    _, nw, staged = consts.passes[0]
    got = _build.function("lut_sieve", "lut_sieve_blocks_per_sm", "iii")(
        length, nw, staged)
    if got < 0:
        raise RuntimeError("occupancy query for lut_sieve failed")
    return got


def kernel_policy() -> tuple[int, int, int]:
    """(threads a block, queue slots a warp, walk) as the built kernel of
    `csrc/lut_sieve.cu` has them: `walk_steps` models the kernel only while
    this equals (BLOCK_THREADS, QUEUE_SLOTS, WALK)."""
    from trivy_tpu_torch.ops import _build

    fn = _build.function("lut_sieve", "lut_sieve_policy", "i")
    return fn(0), fn(1), fn(2)


class LutSieve:
    """Callable LUT sieve: tiles [T, L] uint8 -> probe-hit words [T, Pw]
    int32, over the LUT of `ProbeSet.build_lut`."""

    def __init__(self, lut: np.ndarray, device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.consts = lut_consts(lut, self.device)
        self.jmax, _, self.n_words = lut.shape

    def to(self, device: str | torch.device) -> LutSieve:
        """This sieve with its LUT on `device` (`gram_sieve.replica`)."""
        return replica(self, device, ("consts",))

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        if tiles.device != self.device:
            raise ValueError(f"tiles on {tiles.device}, sieve on {self.device}")
        return lut_sieve(tiles, self.consts)


def make_sharded_sieve(mesh, sieve: LutSieve):
    """B6m, the twin of `make_sharded_sieve` (`trivy_tpu/ops/sieve.py:48`):
    B6 on each lane's tiles against the LUT replicated per device; [T, Pw]
    words as a `Sharded` in tile order."""
    return shard_map(mesh, sieve)
