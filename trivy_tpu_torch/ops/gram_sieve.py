"""The masked 4-gram sieve: rows [T, L] uint8 -> hit words [T, Dw].

The port of `trivy_tpu/ops/gram_sieve_pallas.py`.  Two kernels, one
contract: bit d of a row's words is set when distinct (mask, val) pair d
matches some case-folded 4-byte window of the row.  Words are `torch.int32`
tensors holding the uint32 bit patterns (torch lacks most uint32 ops);
reinterpret with `.numpy().view(np.uint32)` at the host boundary.

* **bitplane** (`gram_sieve_bitplane`, the twin of `_sieve_bitplane`): the
  window at position p reads positions p..p+3 modulo L, as the TPU kernel's
  lane rotation does, so the last 3 positions of a row may add false hits
  and never lose one.  It tests whole bytes: every byte a mask keeps
  compares equal to the value byte (`byte_test_constants`).
* **window** (`gram_sieve_window`, the twin of `_sieve_window`): positions
  past the row end read zero, and the test is `(w & mask) == val`.

* **rows** (`gram_sieve_rows`, B5, the twin of the XLA program
  `trivy_tpu/ops/gram_sieve.py` `gram_sieve_rows`, which the reference
  engine runs with `kernel="xla"`): only the L - 3 windows that lie inside
  the row (no wrap, no zero fill), `(w & mask) == val`, and the bits in the
  caller's gram order (`pad_grams` pads the list to whole words with
  never-matching grams, `RowGramSieve`), not over distinct pairs.

Each wrapper launches a hand-written CUDA kernel (`csrc/gram_sieve.cu` for
K1/K2, `csrc/gram_rows.cu` for B5) for a CUDA tensor, and counts the
launch in `LAUNCHES`; for a CPU tensor it runs the plain PyTorch version
beside it.  The three row-tail rules differ on purpose: each matches its
own reference program bit for bit.

K1/K2 read the pairs as a pair-set table (`sieve_table`) and the plain
versions read the (mask, val) pairs themselves; `sieve_consts` builds both
at once as one `SieveConsts`, which `GramSieve` keeps on its device and
hands to the wrappers whole.  B5 reads `row_tables`: the distinct pairs'
table over per-offset byte classes, and a gram -> pair index that expands
the pair bits to gram order in the kernel; `row_consts` builds its
`RowConsts`.

**Meshed forms** (the twins of the reference's `make_sharded_pallas_sieve`,
B1m, and `make_sharded_gram_sieve`, B5m): the row axis splits over the
mesh's lanes, each lane runs the same hand kernel on its own rows against
a replica of the constants on its device (`GramSieve.to`,
`RowGramSieve.to`: one copy a distinct device), the link codec's unpack
runs shard-local ahead of it, and the hit words come back as a `Sharded`
in row order.  Each shard is one launch.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from trivy_tpu_torch.bytefreq import FREQ
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.mesh.plan import Sharded, sharding_for

DEFAULT_BLOCK_ROWS = 64
WINDOW_BLOCK_ROWS = 128
# Words of pair bits the table kernels keep per pass (`kSliceWords` in
# csrc/sieve_row.cuh): 256 pairs; a ruleset of more runs one pass per slice.
SLICE_WORDS = 8

# Kernel launches of the port since the process started (or the caller last
# zeroed them): how a run shows that its path went through the CUDA kernels.
# The megakernel's wrappers (`ops/megakernel.py`) and the NFA verify's
# (`ops/nfa_verify.py`) count here too.
LAUNCHES: dict[str, int] = {
    "bitplane": 0, "window": 0, "rows": 0, "lut": 0, "mega": 0, "mega_acc": 0,
    "mega_epilogue": 0, "nfa_stream": 0, "nfa_fused": 0, "nfa_padded": 0,
}

# The three row-tail rules (`_sieve_plain`): wrapped windows (K1), windows
# zero-filled past the row end (K2), windows inside the row only (B5).
TAILS = {"bitplane": "wrap", "window": "zero", "rows": "cut"}


def dedupe_grams(
    masks: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse (mask, val) pairs to distinct pairs in mask-major order.

    Returns (dmasks, dvals, expand) with expand[g] = distinct index of the
    caller's gram g, so `dist[:, expand]` recovers per-gram attribution."""
    if not len(masks):
        return masks, vals, np.zeros(0, dtype=np.int32)
    keys = (masks.astype(np.uint64) << np.uint64(32)) | vals.astype(np.uint64)
    dkeys, inverse = np.unique(keys, return_inverse=True)
    dmasks = (dkeys >> np.uint64(32)).astype(np.uint32)
    dvals = (dkeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return dmasks, dvals, inverse.astype(np.int32)


def _byte_tests(masks, vals):
    """Distinct (offset k, byte v) equality tests + per-gram test lists."""
    tests: dict[tuple[int, int], int] = {}
    gram_tests: list[list[tuple[int, int]]] = []
    for m, v in zip(masks, vals):
        lst = []
        for k in range(4):
            if (int(m) >> (8 * k)) & 0xFF:
                b = (int(v) >> (8 * k)) & 0xFF
                lst.append((k, b))
                tests.setdefault((k, b), len(tests))
        gram_tests.append(lst)
    return tests, gram_tests


def byte_test_constants(
    masks: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(mask, val) pairs rewritten as the bitplane kernel reads them: each
    byte a mask touches at all is compared whole against the value byte."""
    _, gram_tests = _byte_tests(masks, vals)
    bmasks = np.zeros(len(masks), dtype=np.uint32)
    bvals = np.zeros(len(masks), dtype=np.uint32)
    for g, lst in enumerate(gram_tests):
        for k, b in lst:
            bmasks[g] |= np.uint32(0xFF << (8 * k))
            bvals[g] |= np.uint32(b << (8 * k))
    return bmasks, bvals


def table_slices(n_words: int) -> int:
    """Table slices (passes of the kernels) for `n_words` words of pairs."""
    return -(-n_words // SLICE_WORDS)


def sieve_table(
    masks: np.ndarray, vals: np.ndarray, n_words: int, symbols: int = 256
) -> np.ndarray:
    """The pair-set table the CUDA kernels read, [n_slices, 4, 8, symbols]
    uint32 with n_slices = `table_slices(n_words)`: bit b of word
    [i, k, w, s] is set iff pair d = 32 (8 i + w) + b accepts symbol s at
    offset k, `(fold(s) & mask_k) == val_k` over the bytes k of its mask
    and value (a mask byte of 0 accepts every symbol).  The test separates
    byte by byte, so the AND over the four offsets equals `(window & mask)
    == val` on the folded window.  Bits d >= len(masks) are 0.  `symbols`
    covers every value a row can hold: 256 for bytes, 16 or 64 for class ids
    (which the fold leaves alone)."""
    sw, n_slices = SLICE_WORDS, table_slices(n_words)
    masks = np.asarray(masks, dtype=np.uint32)
    vals = np.asarray(vals, dtype=np.uint32)
    if n_words * 32 < len(masks):
        raise ValueError(f"n_words={n_words} too small for {len(masks)} pairs")
    s = np.arange(symbols, dtype=np.uint32)
    folded = np.where((s >= 0x41) & (s <= 0x5A), s + 32, s)
    bits = np.zeros((4, symbols, n_slices * sw * 32), dtype=bool)
    for k in range(4):
        mk = (masks >> np.uint32(8 * k)) & np.uint32(0xFF)
        vk = (vals >> np.uint32(8 * k)) & np.uint32(0xFF)
        bits[k, :, : len(masks)] = (folded[:, None] & mk[None, :]) == vk[None, :]
    words = np.packbits(bits, axis=-1, bitorder="little").view("<u4")
    words = words.reshape(4, symbols, n_slices, sw).transpose(2, 0, 3, 1)
    return np.ascontiguousarray(words, dtype=np.uint32)


def as_int32_bits(a: np.ndarray) -> np.ndarray:
    """uint32 values -> int32 array with the same bit patterns."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)


class SieveConsts(NamedTuple):
    """One set of sieve pairs in both forms, int32 bit patterns on one
    device: `masks`/`vals` [D] for the plain versions and their
    `sieve_table` for the kernels.  Build it with `sieve_consts`, so the
    table always comes from these pairs."""

    masks: torch.Tensor
    vals: torch.Tensor
    table: torch.Tensor


def sieve_consts(
    masks: np.ndarray, vals: np.ndarray, n_words: int,
    device: str | torch.device,
) -> SieveConsts:
    """(mask, val) pairs as uint32 -> their `SieveConsts` on `device`."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(as_int32_bits(a).copy()).to(device)

    return SieveConsts(dev(masks), dev(vals),
                       dev(sieve_table(masks, vals, n_words)))


# Symbols in the order byte classes are numbered (`byte_classes`): the bytes
# most frequent in source and config text first (`bytefreq.FREQ`; ties in
# byte order), so their classes take the low ids.  A class id c shares a
# shared-memory bank with c + 32 only, so text whose classes stay below 32
# reads its tables without conflicts.
SYMBOL_ORDER = np.argsort(-FREQ, kind="stable")


def byte_classes(columns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symbols whose rows of `columns` ([S, ...]) are equal share a class.
    Returns (class id of each symbol [S] int64, one symbol of each class
    [C]), ids numbered by first appearance in `SYMBOL_ORDER`."""
    s = len(columns)
    _, inverse = np.unique(columns.reshape(s, -1), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    ids = np.full(inverse.max() + 1, -1, dtype=np.int64)
    reps = []
    for sym in SYMBOL_ORDER[SYMBOL_ORDER < s]:
        if ids[inverse[sym]] < 0:
            ids[inverse[sym]] = len(reps)
            reps.append(sym)
    return ids[inverse], np.array(reps, dtype=np.int64)


ROW_HEADER = 8  # words of a B5 pass block before what the kernel stages


def row_tables(
    masks: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, tuple[tuple[int, int, int], ...]]:
    """B5's kernel tables for gram constants padded to a multiple of 32
    (`pad_grams`).  The grams' distinct (mask, val) pairs (`dedupe_grams`)
    are sieved 256 a pass; per pass, one block of uint32 words:

    * [0:4] C_k, the classes at offset k: symbols whose pair columns
      (`sieve_table`, case fold baked in) at offset k are equal; [4:8] 0;
    * [8:264] the class map: byte k of word s is symbol s's class at k;
    * for k = 0..3, C_k rows of ST = nw | 1 words (nw pair words in this
      pass; an odd stride keeps classes below 32 in distinct banks): row c
      holds the pairs that accept class c at offset k, word nw zero;
    * the gram -> pair index, one uint16 per gram, two a word, low half
      first: the pair's bit within this pass, 0xFFFF for a pair of another;
    * zero words up to a multiple of 4 (blocks stay 16-byte aligned).

    Returns (the blocks concatenated, and per pass (word offset of its
    block, nw, words staged = block length - ROW_HEADER))."""
    masks = np.asarray(masks, dtype=np.uint32)
    vals = np.asarray(vals, dtype=np.uint32)
    if not len(masks) or len(masks) % 32:
        raise ValueError(f"{len(masks)} grams: pad them to a multiple of 32")
    dmasks, dvals, expand = dedupe_grams(masks, vals)
    dw = -(-len(dmasks) // 32)
    tab = sieve_table(dmasks, dvals, dw)
    blocks, passes, offset = [], [], 0
    for sl in range(len(tab)):
        nw = min(SLICE_WORDS, dw - SLICE_WORDS * sl)
        head = np.zeros(ROW_HEADER, dtype=np.uint32)
        cmap = np.zeros(256, dtype=np.uint32)
        parts = []
        for k in range(4):
            cols = tab[sl, k, :nw].T  # [256 symbols, nw]
            cls, reps = byte_classes(cols)
            head[k] = len(reps)
            cmap |= cls.astype(np.uint32) << np.uint32(8 * k)
            part = np.zeros((len(reps), nw | 1), dtype=np.uint32)
            part[:, :nw] = cols[reps]
            parts.append(part.reshape(-1))
        local = expand - 32 * SLICE_WORDS * sl
        idx = np.where((local >= 0) & (local < 32 * nw), local, 0xFFFF).astype("<u2")
        block = np.concatenate([head, cmap, *parts, idx.view("<u4")])
        block = np.concatenate([block, np.zeros(-len(block) % 4, dtype=np.uint32)])
        passes.append((offset, nw, len(block) - ROW_HEADER))
        blocks.append(block)
        offset += len(block)
    return np.concatenate(blocks), tuple(passes)


class RowBlock(NamedTuple):
    """One pass block of `row_tables`, read back: `nw` pair words, `counts`
    the classes at each offset, `classes` [4, 256] each symbol's class at
    each offset, `tables` per offset [C_k, nw | 1] words, `index` the
    gram -> pair index [Gp] uint16."""

    nw: int
    counts: tuple[int, ...]
    classes: np.ndarray
    tables: tuple[np.ndarray, ...]
    index: np.ndarray


def read_row_tables(table: np.ndarray, passes) -> list[RowBlock]:
    """`row_tables`' blocks (uint32 words, or their int32 bit patterns) ->
    one `RowBlock` a pass."""
    table = np.ascontiguousarray(table).view(np.uint32)
    out = []
    for offset, nw, staged in passes:
        block = table[offset : offset + ROW_HEADER + staged]
        counts = tuple(int(c) for c in block[:4])
        cmap = block[ROW_HEADER : ROW_HEADER + 256]
        classes = np.stack([(cmap >> np.uint32(8 * k)) & np.uint32(0xFF)
                            for k in range(4)]).astype(np.int64)
        at, tables = ROW_HEADER + 256, []
        for c in counts:
            tables.append(block[at : at + c * (nw | 1)].reshape(c, nw | 1))
            at += c * (nw | 1)
        out.append(RowBlock(nw, counts, classes, tuple(tables), block[at:].view("<u2")))
    return out


class RowConsts(NamedTuple):
    """B5's constants on one device: the padded grams `masks`/`vals` [Gp]
    (int32 bits) for the plain version, and for the kernel `table`, the
    blocks of `row_tables` as one int32 tensor, with `passes` (word offset,
    pair words, staged words) of each block.  Build it with `row_consts`."""

    masks: torch.Tensor
    vals: torch.Tensor
    table: torch.Tensor
    passes: tuple[tuple[int, int, int], ...]


def row_consts(masks: np.ndarray, vals: np.ndarray,
               device: str | torch.device) -> RowConsts:
    """Padded gram constants as uint32 -> their `RowConsts` on `device`."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(as_int32_bits(a).copy()).to(device)

    table, passes = row_tables(masks, vals)
    return RowConsts(dev(masks), dev(vals), dev(table), passes)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, tests, and the on-card comparison)
# ---------------------------------------------------------------------------


def _sieve_plain(
    rows: torch.Tensor, masks: torch.Tensor, vals: torch.Tensor,
    n_words: int, tail: str,
) -> torch.Tensor:
    t, length = rows.shape
    f = rows.to(torch.int64)
    f = torch.where((f >= 65) & (f <= 90), f + 32, f)

    def shifted(k: int) -> torch.Tensor:
        if tail == "wrap":
            return torch.roll(f, -k, dims=1)
        if tail == "cut":
            return f[:, k : max(length - 3, 0) + k]
        pad = torch.zeros((t, min(k, length)), dtype=f.dtype, device=f.device)
        return torch.cat([f[:, k:], pad], dim=1)

    w = shifted(0) | (shifted(1) << 8) | (shifted(2) << 16) | (shifted(3) << 24)
    m = masks.to(torch.int64) & 0xFFFFFFFF
    v = vals.to(torch.int64) & 0xFFFFFFFF
    hit = torch.zeros((t, n_words * 32), dtype=torch.int64, device=rows.device)
    # One pass per distinct mask: look every masked window up among that
    # mask's sorted values, and mark the value found in its row.
    for mask in torch.unique(m).tolist():
        sel = torch.nonzero(m == mask).flatten()
        uvals, inverse = torch.unique(v[sel], return_inverse=True)
        wm = w & mask
        pos = torch.searchsorted(uvals, wm).clamp_(max=len(uvals) - 1)
        found = uvals[pos] == wm
        seen = torch.zeros((t, len(uvals) + 1), dtype=torch.int64, device=rows.device)
        seen.scatter_(1, torch.where(found, pos, len(uvals)), 1)
        hit[:, sel] = seen[:, inverse]
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    words = (hit.reshape(t, n_words, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def gram_sieve_bitplane_plain(
    rows: torch.Tensor, masks: torch.Tensor, vals: torch.Tensor, n_words: int
) -> torch.Tensor:
    """Plain K1: wrapped windows against whole-byte (mask, val) pairs
    (int32 bit patterns, see `byte_test_constants`)."""
    return _sieve_plain(rows, masks, vals, n_words, "wrap")


def gram_sieve_window_plain(
    rows: torch.Tensor, masks: torch.Tensor, vals: torch.Tensor, n_words: int
) -> torch.Tensor:
    """Plain K2: zero-filled windows, `(w & mask) == val`."""
    return _sieve_plain(rows, masks, vals, n_words, "zero")


def gram_sieve_rows_plain(
    rows: torch.Tensor, masks: torch.Tensor, vals: torch.Tensor, n_words: int
) -> torch.Tensor:
    """Plain B5: the L - 3 windows inside the row, `(w & mask) == val`, bit
    g of the words for the caller's gram g (duplicates included).  One pass
    per distinct mask, as K1's and K2's, in place of the reference's
    [T, L - 3, G] compare."""
    return _sieve_plain(rows, masks, vals, n_words, "cut")


def pad_grams(masks: np.ndarray, vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pad gram constants to a multiple of 32 with never-matching entries
    (the reference's `pad_grams`): mask all bytes, require the all-zero
    window with 0xFF in the top byte, which only `00 00 00 FF` matches."""
    g = len(masks)
    gpad = -(-max(g, 1) // 32) * 32
    m = np.full(gpad, 0xFFFFFFFF, dtype=np.uint32)
    v = np.zeros(gpad, dtype=np.uint32)
    m[:g] = masks
    v[:g] = vals
    v[g:] = 0xFF000000
    return m, v


def gram_sieve_numpy(
    rows: np.ndarray, masks: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """NumPy reference implementation (unpacked bool output [T, G])."""
    f = rows.astype(np.uint32)
    upper = (f >= 65) & (f <= 90)
    f = np.where(upper, f + 32, f)
    w = f[:, :-3] | (f[:, 1:-2] << 8) | (f[:, 2:-1] << 16) | (f[:, 3:] << 24)
    return ((w[:, :, None] & masks[None, None, :]) == vals[None, None, :]).any(axis=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_fn(kind: str):
    from trivy_tpu_torch.ops import _build

    return _build.function("gram_sieve", f"gram_sieve_{kind}", "piipipp")


def _check_pairs(rows, masks, vals, n_words: int) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be a 2-D uint8 tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    for name, c in (("masks", masks), ("vals", vals)):
        if c.dtype != torch.int32 or c.dim() != 1 or c.device != rows.device:
            raise ValueError(f"{name} must be a 1-D int32 tensor on "
                             f"{rows.device}")
    if len(masks) != len(vals):
        raise ValueError("masks and vals differ in length")
    if n_words < max(1, -(-len(masks) // 32)):
        raise ValueError(f"n_words={n_words} too small for {len(masks)} pairs")


def _check_table(rows, table: torch.Tensor, shape: tuple[int, ...]) -> None:
    if (table.dtype != torch.int32 or tuple(table.shape) != shape
            or table.device != rows.device or not table.is_contiguous()):
        raise ValueError(
            f"table must be a contiguous int32 tensor of shape {shape} on "
            f"{rows.device}, got {table.dtype} {tuple(table.shape)} on "
            f"{table.device}"
        )


def _check(rows, consts: SieveConsts, n_words: int) -> None:
    _check_pairs(rows, consts.masks, consts.vals, n_words)
    # what sieve_table(..., n_words) gives
    _check_table(rows, consts.table, (table_slices(n_words), 4, SLICE_WORDS, 256))


def _sieve(kind: str, rows, consts: SieveConsts, n_words: int) -> torch.Tensor:
    _check(rows, consts, n_words)
    if rows.device.type == "cpu":
        return _sieve_plain(rows, consts.masks, consts.vals, n_words, TAILS[kind])
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    rows = rows.contiguous()
    t, length = rows.shape
    out = torch.empty((t, n_words), dtype=torch.int32, device=rows.device)
    fn = _kernel_fn(kind)
    with torch.cuda.device(rows.device):
        err = fn(
            rows.data_ptr(), t, length, consts.table.data_ptr(), n_words,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gram_sieve_{kind} launch failed: cudaError {err}")
    LAUNCHES[kind] += 1
    return out


def gram_sieve_bitplane(
    rows: torch.Tensor, consts: SieveConsts, n_words: int
) -> torch.Tensor:
    """K1 on `rows`' device: the CUDA kernel on a card (which reads
    `consts.table`), the plain version on the CPU (which reads
    `consts.masks`/`vals`, whole-byte pairs, see `byte_test_constants`)."""
    return _sieve("bitplane", rows, consts, n_words)


def gram_sieve_window(
    rows: torch.Tensor, consts: SieveConsts, n_words: int
) -> torch.Tensor:
    """K2 on `rows`' device: the CUDA kernel on a card (`consts.table`),
    the plain version on the CPU (`consts.masks`/`vals`)."""
    return _sieve("window", rows, consts, n_words)


def gram_sieve_rows(
    rows: torch.Tensor, consts: RowConsts, n_words: int
) -> torch.Tensor:
    """B5 on `rows`' device: the CUDA kernel of `csrc/gram_rows.cu` on a
    card (`consts.table`: one launch a pass of 256 distinct pairs, the
    later passes ORing their grams' bits into the words; counted once), the
    plain version on the CPU (`consts.masks`/`vals`)."""
    _check_pairs(rows, consts.masks, consts.vals, n_words)
    if len(consts.masks) != 32 * n_words:
        raise ValueError(f"{len(consts.masks)} grams, expected {32 * n_words} (padded)")
    end = consts.passes[-1][0] + consts.passes[-1][2] + ROW_HEADER
    _check_table(rows, consts.table, (end,))
    if rows.device.type == "cpu":
        return _sieve_plain(rows, consts.masks, consts.vals, n_words, TAILS["rows"])
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from trivy_tpu_torch.ops import _build

    rows = rows.contiguous()
    t, length = rows.shape
    out = torch.empty((t, n_words), dtype=torch.int32, device=rows.device)
    fn = _build.function("gram_rows", "gram_sieve_rows", "piipiiiipp")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (offset, nw, staged) in enumerate(consts.passes):
            err = fn(rows.data_ptr(), t, length, consts.table.data_ptr() + 4 * offset,
                     nw, staged, n_words, int(i > 0), out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"gram_sieve_rows launch failed: cudaError {err}")
    LAUNCHES["rows"] += 1
    return out


def rows_blocks_per_sm(consts: RowConsts) -> int:
    """Blocks of B5's first pass one SM of the current card holds at once."""
    from trivy_tpu_torch.ops import _build

    _, nw, staged = consts.passes[0]
    got = _build.function("gram_rows", "gram_rows_blocks_per_sm", "ii")(nw, staged)
    if got < 0:
        raise RuntimeError("occupancy query for gram_sieve_rows failed")
    return got


class RowGramSieve:
    """Callable B5 sieve: rows [T, L] uint8 -> hit words [T, Gp / 32] int32,
    bit g for the caller's gram g (the pad grams of `pad_grams` included:
    they fire on a window `00 00 00 FF`, as the reference's do; callers
    read bits below `num_grams`)."""

    def __init__(self, masks: np.ndarray, vals: np.ndarray,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.num_grams = len(masks)
        pmasks, pvals = pad_grams(np.asarray(masks, dtype=np.uint32),
                                  np.asarray(vals, dtype=np.uint32))
        self.n_words = len(pmasks) // 32
        self.consts = row_consts(pmasks, pvals, self.device)

    def to(self, device: str | torch.device) -> RowGramSieve:
        """This sieve with its constants on `device` (`replica`)."""
        return replica(self, device, ("consts",))

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        if rows.device != self.device:
            raise ValueError(f"rows on {rows.device}, sieve on {self.device}")
        return gram_sieve_rows(rows, self.consts, self.n_words)


class GramSieve:
    """Callable sieve: rows [T, L] uint8 -> hit words [T, Dw] int32.

    `PallasGramSieve`'s contract: output bits are over DISTINCT (mask, val)
    pairs in mask-major order, `num_distinct` bits across `n_words` words;
    `gram_expand` maps each caller gram to its distinct bit and
    `expand_bool` applies it.  Rows pad to a multiple of `block_rows`; the
    bitplane kernel serves rows of at least 256 bytes, the window kernel
    narrower ones (and `impl="window"`).
    """

    def __init__(
        self,
        masks: np.ndarray,
        vals: np.ndarray,
        block_rows: int | None = None,
        impl: str = "bitplane",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if impl not in ("bitplane", "window"):
            raise ValueError(f"unknown sieve impl: {impl}")
        self.device = resolve_device(device)
        dmasks, dvals, self.gram_expand = dedupe_grams(
            np.asarray(masks, dtype=np.uint32), np.asarray(vals, dtype=np.uint32)
        )
        self.num_distinct = len(dmasks)
        self.n_words = max(1, -(-self.num_distinct // 32))
        self.impl = impl
        if block_rows is None:
            block_rows = (
                DEFAULT_BLOCK_ROWS if impl == "bitplane" else WINDOW_BLOCK_ROWS
            )
        self.block_rows = block_rows
        bmasks, bvals = byte_test_constants(dmasks, dvals)
        self._window_consts = sieve_consts(dmasks, dvals, self.n_words,
                                           self.device)
        self._bitplane_consts = sieve_consts(bmasks, bvals, self.n_words,
                                             self.device)

    def to(self, device: str | torch.device) -> GramSieve:
        """This sieve with its constants on `device` (`replica`)."""
        return replica(self, device, ("_window_consts", "_bitplane_consts"))

    def expand_bool(self, dist_bool: np.ndarray) -> np.ndarray:
        """[F, num_distinct] bool -> [F, G] bool in the caller's gram order."""
        if not len(self.gram_expand):
            return dist_bool
        return dist_bool[:, self.gram_expand]

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        if rows.device != self.device:
            raise ValueError(f"rows on {rows.device}, sieve on {self.device}")
        t, length = rows.shape
        if length & (length - 1):
            raise ValueError(f"row length {length} not a power of 2")
        pad = (-t) % self.block_rows
        if pad:
            rows = torch.cat(
                [rows, torch.zeros((pad, length), dtype=torch.uint8,
                                   device=rows.device)]
            )
        if self.impl == "bitplane" and length >= 256:
            out = gram_sieve_bitplane(rows, self._bitplane_consts, self.n_words)
        else:
            out = gram_sieve_window(rows, self._window_consts, self.n_words)
        return out[:t] if pad else out


# ---------------------------------------------------------------------------
# Replicas and the meshed sieves
# ---------------------------------------------------------------------------


def consts_to(consts, device: torch.device):
    """A constants tuple (`SieveConsts`, `RowConsts`, `LutConsts`) with its
    tensors on `device`."""
    return type(consts)(*(c.to(device) if isinstance(c, torch.Tensor) else c
                          for c in consts))


def replica(sieve, device: str | torch.device, fields: tuple[str, ...]):
    """`sieve` itself on its own device, else a shallow copy whose constants
    tuples `fields` live on `device`, made once a device and kept on
    `sieve`: the plan's replicated constants, one copy a distinct device."""
    device = resolve_device(device)
    if device == sieve.device:
        return sieve
    reps = sieve.__dict__.setdefault("_replicas", {})
    if device not in reps:
        rep = copy.copy(sieve)
        rep.__dict__["_replicas"] = {}
        rep.device = device
        for f in fields:
            setattr(rep, f, consts_to(getattr(sieve, f), device))
        reps[device] = rep
    return reps[device]


def shard_map(mesh, sieve, pre=None, family: str = "coded_rows"):
    """`sieve` over `mesh`: a callable rows -> `Sharded` outputs, where rows
    is a `Sharded` over the mesh's lanes (staged per lane) or a tensor,
    split here per the plan's `family`.  Lane i runs `pre` (the codec's
    unpack, or None) and then `sieve`'s replica on its device over its own
    rows; nothing crosses between lanes."""
    place = sharding_for(mesh, family)
    replicas = place.replicate(sieve.to)

    def sharded(rows) -> Sharded:
        if not isinstance(rows, Sharded):
            rows = place.split(rows)
        if len(rows.shards) != mesh.size:
            raise ValueError(f"{len(rows.shards)} shards for a mesh of {mesh.size} lanes")
        outs = []
        for shard in rows.shards:
            x = pre(shard) if pre is not None else shard
            outs.append(replicas[shard.device](x))
        return Sharded(outs, rows.axis, rows.tags)

    return sharded


def make_sharded_pallas_sieve(mesh, sieve: GramSieve, pre=None):
    """B1m, the twin of `make_sharded_pallas_sieve`
    (`trivy_tpu/ops/gram_sieve_pallas.py:416`): K1 (K2 below 256 columns)
    on each lane's rows, `pre` shard-local ahead of it; [T, Dw] words as a
    `Sharded` in row order.  Callers size row batches to a multiple of
    lanes x `block_rows` so every shard tiles into whole blocks."""
    return shard_map(mesh, sieve, pre)


def make_sharded_gram_sieve(mesh, sieve: RowGramSieve, unpack=None):
    """B5m, the twin of `make_sharded_gram_sieve`
    (`trivy_tpu/ops/gram_sieve.py:61`): B5 on each lane's rows against
    replicated constants, `unpack` shard-local ahead of it."""
    return shard_map(mesh, sieve, unpack)
