"""Device NFA verify: bit-parallel search automata over candidate bytes.

The port of the device programs of `trivy_tpu/engine/nfa_device.py`.  Each
rule's 64-position Glushkov search automaton steps one byte at a time,

    S' = (reach(S) | first) & accept[byte],    hit = (S' & last) != 0,

with reach(S) the OR of `follow[p]` over the set bits p of S.  The reference
writes the same step as float matrix products of 0/1 tensors,
`S' = min(min(S @ F + first, 1) * cmask, 1)` and `S' . last > 0`, which are
exact on 0/1 values (sums stay below 65), so both forms give the same bits.
Three functions, each a hand-written CUDA kernel of `csrc/nfa_verify.cu` for
CUDA tensors and a plain PyTorch version beside it for CPU tensors:

* **K5**, `nfa_stream` (the twin of `NfaVerifier._stream_multi_impl`,
  :393, with `_pack_rule_flags`, :436): rows [N, L] uint8 of raw bytes, L a
  multiple of 32, and the words of a stack of rb <= 32 rules -> flags
  [ceil(rb/8), N, L/32] uint8.  Bit k of byte [p, n, j] (LSB-first) is set
  when a match of rule slot 8p + k ends in positions [32j, 32j + 32) of row
  n.  State starts empty at each row and carries across its blocks; byte
  0x00 is dead in every rule (`accept_b[:, 0] = 0`), so the one-byte
  separators between spans reset matching.  The reference lays rows out
  [L/32, 32, G, Bg] for its scan's leading axis and returns [P, Lo, G, Bg];
  the port keeps rows [G * Bg, L] and returns the transposed [P, G * Bg, Lo]
  that every consumer of the flags reads anyway.  `nfa_stream_assoc_plain`
  is the plain twin of `_stream_assoc_impl` (:452): the same flags from
  per-block affine summaries combined by an associative scan.  On the card
  both scan modes launch K5 (one thread walks a 16 KB row in microseconds;
  the summaries exist to shorten the TPU scan's serial depth).
* **K5 in fused mode**, `nfa_stream_verdict` (the twin of `_run_fused`,
  :572: the stream and its verdict half in one launch): rows, a stack and a
  lane table row/slot/b0/b1 [N] int32 (N a power of two >= 8; padded lanes
  all 0) -> keep [N/8] uint8, np.packbits order (MSB-first): lane i keeps
  when its slot's match ends in some block of [b0, b1) of its row.  The
  kernel writes no flags: each flagged block sets the keep bits of its
  lanes through a CSR index of the table (`LaneIndex`).  Its plain version
  is `nfa_fused_verdict_plain` (the reference's cumulative block-sum
  gather) over the plain K5's flags.
* **K6**, `nfa_padded` (the twin of `_run`, :325): class ids [G, Bg, L]
  uint8 (lane-contiguous; the reference's [L, G, Bg] transposed), group
  rule ids [G] int32 and the resident per-rule tables ->
  matched [G, Bg] bool: some match of rule gids[g] ends anywhere in lane
  (g, b), its whole bucket length, zero padding included, as the
  reference walks it.  The kernel stops a lane once it has matched, and
  past its last non-zero id at the first step that leaves the state
  unchanged (every later step gives the same state and hit).

Each rule travels as 64-bit words (`pack_bits64`: bit q of word p is the
0/1 tensor's [p, q]): `nfa_stack` and `nfa_tables` build them, and on the
CPU the wrappers unpack them (`unpack_words`) into the 0/1 float tensors the
plain versions read.  The kernels read tables derived from the same words
in one place, `NfaStack.from_words` / `NfaTables.from_words`, frozen objects
that carry the words beside their tables, so a kernel's tables cannot drift
from the words its plain version reads:

* the step of each rule (`step_words`): reach(S), the OR of follow[p] over
  the set bits p of S, is `((S & fwd) << 1) | (S & self)` plus the OR of
  `residual[p]` over the set bits p of `S & exc` (fwd: the edges p -> p + 1
  of the Glushkov numbering's concatenations; self: p -> p; residual: every
  other edge; exc: the positions that have one);
* for K5, the live slots (`rb_live`: 1 + the last slot with a non-zero
  word; the slots past it never leave state 0), the byte -> class map of
  the distinct accept columns of those slots and their class words, and
  `zero_dead` (byte 0 accepted by no live slot, so a run of zero bytes
  sets S = 0 and flags nothing: the kernel skips zero 16-byte chunks);
* for K6, one row a rule: the step words, the residual rows and the
  class masks.

The wrappers take either the object or the words (from which they build
it).  On a card, a launch of few long rows (K5) or lanes (K6) is cut into
segments, each walked from the empty state, and a fix-up kernel carries
the excess state across the boundaries (exact: the step distributes over
union; `csrc/nfa_verify.cu`, "Segments").  torch has no unsigned 64-bit arithmetic on CUDA: words and tables
travel as int64 and the kernels reinterpret them.  Each launch counts in
`gram_sieve.LAUNCHES` ("nfa_stream", "nfa_fused", "nfa_padded").
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.ops.gram_sieve import LAUNCHES

STREAM_BLOCK = 32  # positions OR-compressed into one flag
MAX_STACK = 32  # rule slots one K5 launch serves (one warp lane a slot)
STREAM_WORDS = 64 + 256 + 2  # follow[64], accept_b[256], first, last
PADDED_WORDS = 64 + 64 + 2  # follow[64], classmask[64], first, last
STEP_WORDS = 5  # fwd, self, exc, first, last (csrc/nfa_step.cuh)
RULE_WORDS = STEP_WORDS + 64  # + residual[64]
PADDED_TABLE_WORDS = RULE_WORDS + 64  # + classmask[64]: K6's row a rule
MAP_WORDS = 256 // 8  # K5's byte -> class map, 256 uint8 in int64 words
_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits64(bits: np.ndarray) -> np.ndarray:
    """[..., 64] 0/1 -> [...] int64 words, bit q = bits[..., q] (uint64 bit
    patterns in int64)."""
    b = (np.asarray(bits) != 0).astype(np.uint64)
    words = (b << np.arange(64, dtype=np.uint64)).sum(axis=-1, dtype=np.uint64)
    return np.ascontiguousarray(words).view(np.int64)


def _words(follow, accept, first, last) -> np.ndarray:
    """The four 0/1 arrays of R rules -> their words [R, 64 + accept rows +
    2] int64: follow rows, accept rows, first, last."""
    return np.concatenate([
        pack_bits64(follow), pack_bits64(accept),
        pack_bits64(first)[:, None], pack_bits64(last)[:, None],
    ], axis=1)


def nfa_stack(follow, accept_b, first, last, device) -> torch.Tensor:
    """0/1 arrays of a rule stack (follow [rb, 64, 64], accept_b [rb, 256,
    64], first and last [rb, 64]) -> the words K5 reads, [rb, STREAM_WORDS]
    int64 on `device`."""
    return torch.from_numpy(_words(follow, accept_b, first, last)).to(device)


def nfa_tables(follow, accept, first, last, device) -> torch.Tensor:
    """0/1 arrays of every rule (follow [R, 64, 64], class-indexed accept
    [R, 64, 64], first and last [R, 64]) -> the words K6 reads, [R,
    PADDED_WORDS] int64 on `device`."""
    return torch.from_numpy(_words(follow, accept, first, last)).to(device)


def unpack_words(words: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Words [R, 64 + A + 2] -> the 0/1 float32 tensors the plain versions
    read, on the words' device: follow [R, 64, 64], accept [R, A, 64],
    first [R, 64], last [R, 64] (the inverse of `nfa_stack`/`nfa_tables`)."""
    shifts = torch.arange(64, dtype=torch.int64, device=words.device)
    bits = ((words[..., None] >> shifts) & 1).to(torch.float32)
    return bits[:, :64], bits[:, 64:-2], bits[:, -2], bits[:, -1]


_POS = np.arange(64, dtype=np.uint64)
_OWN = np.uint64(1) << _POS  # bit p
_NEXT = np.where(_POS < 63, np.uint64(1) << np.minimum(_POS + np.uint64(1), np.uint64(63)),
                 np.uint64(0))  # bit p + 1 (none past 63)


def step_words(follow: np.ndarray) -> tuple[np.ndarray, ...]:
    """Follow words [R, 64] (uint64 bit patterns) -> the decomposed step,
    uint64: fwd [R] (bit p: the edge p -> p + 1, p < 63), self [R] (bit p:
    p -> p), exc [R] (bit p: follow[p] has another edge) and residual
    [R, 64] (follow[p] without those two edges).  For every S,
    OR_{p in S} follow[p] == ((S & fwd) << 1) | (S & self)
    | OR_{p in S & exc} residual[p]."""
    f = np.ascontiguousarray(follow).view(np.uint64)
    fwd_b = (f & _NEXT) != 0
    self_b = (f & _OWN) != 0
    residual = f & ~(np.where(fwd_b, _NEXT, np.uint64(0)) | np.where(self_b, _OWN, np.uint64(0)))
    return (pack_bits64(fwd_b).view(np.uint64), pack_bits64(self_b).view(np.uint64),
            pack_bits64(residual != 0).view(np.uint64), residual)


def _host_words(words: torch.Tensor) -> np.ndarray:
    return words.detach().cpu().numpy().view(np.uint64)


@dataclass(frozen=True)
class NfaStack:
    """A K5 rule stack: `words` [rb, STREAM_WORDS] int64 (what `nfa_stack`
    returns and the plain versions read unpacked) and the kernel's image of
    it in shared memory, `table`, built from them by `from_words`: for the
    `width` = max(rb_live, 1) first slots, word-major by slot (word w of
    slot s at [w * width + s]), the step words (fwd, self, exc, first,
    last), residual[64], the class words [n_classes], then the byte -> class
    map (256 uint8 in MAP_WORDS words)."""

    words: torch.Tensor
    table: torch.Tensor
    rb: int
    rb_live: int
    n_classes: int
    zero_dead: bool

    @property
    def width(self) -> int:
        return max(self.rb_live, 1)

    @property
    def nbytes(self) -> int:
        return self.words.nbytes + self.table.nbytes

    @classmethod
    def from_words(cls, words: torch.Tensor, device=None) -> NfaStack:
        """The stack of `words` [rb, STREAM_WORDS] int64, words and table on
        `device` (default: the words')."""
        _check_stack_words(words)
        w = _host_words(words)
        nz = np.flatnonzero(w.any(axis=1))
        rb_live = int(nz[-1]) + 1 if len(nz) else 0
        v = w[: max(rb_live, 1)]
        fwd, own, exc, residual = step_words(v[:, :64])
        accept = v[:, 64:320]  # [width, 256]
        cols, cmap = np.unique(accept.T, axis=0, return_inverse=True)  # [C, width], [256]
        image = np.concatenate([
            np.stack([fwd, own, exc, v[:, 320], v[:, 321]]).reshape(-1),
            residual.T.reshape(-1),
            cols.reshape(-1),
            cmap.reshape(-1).astype(np.uint8).view(np.uint64),
        ])
        dev = words.device if device is None else device
        return cls(words=words.to(dev), table=torch.from_numpy(image.view(np.int64)).to(dev),
                   rb=len(w), rb_live=rb_live, n_classes=len(cols),
                   zero_dead=not accept[:, 0].any())

    @classmethod
    def build(cls, follow, accept_b, first, last, device) -> NfaStack:
        """`nfa_stack`'s 0/1 arrays -> the stack on `device`."""
        return cls.from_words(nfa_stack(follow, accept_b, first, last, "cpu"), device)


@dataclass(frozen=True)
class NfaTables:
    """Every rule's K6 tables: `words` [R, PADDED_WORDS] int64 (what
    `nfa_tables` returns) and `table` [R, PADDED_TABLE_WORDS] int64, a row a
    rule: the step words (fwd, self, exc, first, last), residual[64],
    classmask[64]."""

    words: torch.Tensor
    table: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.words.nbytes + self.table.nbytes

    @classmethod
    def from_words(cls, words: torch.Tensor, device=None) -> NfaTables:
        _check_table_words(words)
        w = _host_words(words)
        fwd, own, exc, residual = step_words(w[:, :64])
        table = np.concatenate([np.stack([fwd, own, exc, w[:, 128], w[:, 129]], axis=1),
                                residual, w[:, 64:128]], axis=1)
        dev = words.device if device is None else device
        return cls(words=words.to(dev),
                   table=torch.from_numpy(np.ascontiguousarray(table).view(np.int64)).to(dev))

    @classmethod
    def build(cls, follow, accept, first, last, device) -> NfaTables:
        """`nfa_tables`' 0/1 arrays -> the tables on `device`."""
        return cls.from_words(nfa_tables(follow, accept, first, last, "cpu"), device)


@dataclass(frozen=True)
class LaneIndex:
    """A fused dispatch's lane table and the kernel's index of it.  `lanes`
    [4, N] int32 on the host (row, slot, b0, b1; what the plain version
    reads) and `index`, one int32 tensor on the launch's device: offsets
    [n_rows * width + 1] (the lanes of (row, slot) at [off[row * width +
    slot], off[... + 1])), then per indexed lane, sorted by (row, slot, b0):
    b0, b1, `reach` (the largest b1 of its (row, slot)'s lanes up to it) and
    its lane id.  Only lanes that can keep are indexed: row in [0, n_rows),
    slot in [0, width) (a slot past the live ones never matches), and a
    non-empty block range once clamped to [0, n_blocks)."""

    lanes: torch.Tensor
    index: torch.Tensor
    n_rows: int
    width: int
    n_indexed: int

    @classmethod
    def build(cls, lanes, n_rows: int, n_blocks: int, width: int, device) -> LaneIndex:
        """`lanes` [4, N] int32 (array or tensor), N a multiple of 8 -> the
        index on `device`, built by the native library's `lane_index` (a
        counting sort: two passes over the table) and copied over once."""
        from trivy_tpu_torch.native import load_native

        table = np.ascontiguousarray(np.asarray(
            lanes.cpu() if isinstance(lanes, torch.Tensor) else lanes, dtype=np.int32))
        if table.ndim != 2 or table.shape[0] != 4 or table.shape[1] % 8:
            raise ValueError(f"lane table must be [4, N] int32, N a multiple of 8, "
                             f"got {table.shape}")
        n, n_keys = table.shape[1], n_rows * width
        out = np.empty(n_keys + 1 + 4 * n, np.int32)
        m = load_native().lane_index(table.ctypes.data, n, n_rows, n_blocks, width,
                                     out.ctypes.data)
        return cls(lanes=torch.from_numpy(table),
                   index=torch.from_numpy(out[: n_keys + 1 + 4 * m]).to(device),
                   n_rows=n_rows, width=width, n_indexed=int(m))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, tests, and the on-card comparison)
# ---------------------------------------------------------------------------


def _pack_slots(flags: torch.Tensor) -> torch.Tensor:
    """[rb, ...] 0/1 -> [ceil(rb/8), ...] uint8, slot 8p + k in bit k."""
    rb = flags.shape[0]
    rp = -(-rb // 8)
    pad = flags.new_zeros((rp * 8 - rb,) + tuple(flags.shape[1:]))
    grouped = torch.cat([flags, pad]).reshape((rp, 8) + tuple(flags.shape[1:]))
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                     device=flags.device).reshape((1, 8) + (1,) * (flags.dim() - 1))
    return (grouped.to(torch.int32) * w).sum(dim=1).to(torch.uint8)


@contextlib.contextmanager
def _no_tf32():
    """float32 products in full precision on a card while the block runs
    (the 0/1 step is exact either way; the comparison should not depend on
    the setting)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def nfa_stream_plain(
    rows: torch.Tensor, follow: torch.Tensor, accept_b: torch.Tensor,
    first: torch.Tensor, last: torch.Tensor,
) -> torch.Tensor:
    """Plain K5: the reference's float step, vectorised over rule slots and
    rows, one Python step a byte (its outer clamp is dropped: the masked
    state is 0/1 already); a block's states then meet `last` in one
    product.  Flags depend on a row's bytes alone, so each distinct row
    (the padding rows are one) is stepped once."""
    rows, inverse = torch.unique(rows, dim=0, return_inverse=True)
    n, length = rows.shape
    rb, lo = follow.shape[0], length // STREAM_BLOCK
    dev = rows.device
    state = torch.zeros((rb, n, 64), dtype=torch.float32, device=dev)
    block = torch.empty((rb, n, STREAM_BLOCK, 64), dtype=torch.float32, device=dev)
    hits = torch.zeros((rb, n, lo), dtype=torch.bool, device=dev)
    fst = first[:, None, :].expand(rb, n, 64)
    with _no_tf32():
        for j in range(lo):
            for i in range(STREAM_BLOCK):
                cmask = accept_b[:, rows[:, j * STREAM_BLOCK + i].long(), :]  # [rb, n, 64]
                state = torch.baddbmm(fst, state, follow).clamp_(max=1.0).mul_(cmask)
                block[:, :, i] = state
            ends = torch.bmm(block.view(rb, n * STREAM_BLOCK, 64), last[:, :, None])
            hits[:, :, j] = (ends.view(rb, n, STREAM_BLOCK) > 0).any(-1)
    return _pack_slots(hits)[:, inverse]


def nfa_stream_assoc_plain(
    rows: torch.Tensor, follow: torch.Tensor, accept_b: torch.Tensor,
    first: torch.Tensor, last: torch.Tensor,
) -> torch.Tensor:
    """Plain twin of `_stream_assoc_impl`: each 32-byte block folds into an
    affine summary (transfer matrix M [64, 64], offset v [64]) plus hit
    detectors a [64] and b, the summaries combine across the row's blocks
    by an inclusive associative scan (log-depth doubling), and block j
    flags when (entering state . a_j) + b_j > 0.  A summary depends on its
    block's bytes alone, so each distinct block (zero padding is one) is
    folded once; holds [rb, L/32, rows, 64, 64] floats at once."""
    rows, inverse = torch.unique(rows, dim=0, return_inverse=True)
    n, length = rows.shape
    rb, lo = follow.shape[0], length // STREAM_BLOCK
    dev = rows.device
    blocks, binv = torch.unique(rows.reshape(n * lo, STREAM_BLOCK), dim=0,
                                return_inverse=True)
    nb = len(blocks)
    blocks = blocks.long().t()  # [32, distinct blocks]
    # one batched product a step: M rows (block, p) x follow [64, 64]
    m = torch.eye(64, device=dev).expand(rb, nb, 64, 64).reshape(rb, -1, 64).clone()
    v = torch.zeros((rb, nb, 64), device=dev)
    av = torch.zeros((rb, nb * 64, 1), device=dev)
    bv = torch.zeros((rb, nb), device=dev)
    fs, ls = first[:, None, :], last[:, :, None]
    with _no_tf32():
        for i in range(STREAM_BLOCK):
            cmask = accept_b[:, blocks[i], :]  # [rb, nb, 64]
            m = torch.clamp(torch.bmm(m, follow).reshape(rb, nb, 64, 64)
                            * cmask[:, :, None, :], max=1.0).reshape(rb, -1, 64)
            v = torch.clamp((torch.bmm(v, follow) + fs) * cmask, max=1.0)
            av = torch.clamp(av + torch.bmm(m, ls), max=1.0)
            bv = torch.clamp(bv + torch.bmm(v, ls)[..., 0], max=1.0)
        # distinct blocks back to [rb, Lo, N, ...] (row-major blocks)
        order = binv.reshape(n, lo).t().reshape(-1)
        m = m.reshape(rb, nb, 64, 64)[:, order]
        v = v[:, order]
        av = av.reshape(rb, nb, 64)[:, order]
        bv = bv[:, order]
        m = m.reshape(rb, lo, n, 64, 64)
        v = v.reshape(rb, lo, n, 64)
        # inclusive scan over blocks: x_j <- x_{j-d} o x_j (earlier first)
        d = 1
        while d < lo:
            m_new = torch.clamp(m[:, :-d] @ m[:, d:], max=1.0)
            v_new = torch.clamp((v[:, :-d, :, None, :] @ m[:, d:])[..., 0, :] + v[:, d:],
                                max=1.0)
            m = torch.cat([m[:, :d], m_new], dim=1)
            v = torch.cat([v[:, :d], v_new], dim=1)
            d *= 2
        enter = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
        det_a = av.reshape(rb, lo, n, 64)
        hit = (enter * det_a).sum(-1) + bv.reshape(rb, lo, n) > 0  # [rb, Lo, N]
    return _pack_slots(hit.permute(0, 2, 1))[:, inverse]


def nfa_fused_verdict_plain(
    flags: torch.Tensor, lane_row: torch.Tensor, lane_slot: torch.Tensor,
    lane_b0: torch.Tensor, lane_b1: torch.Tensor,
) -> torch.Tensor:
    """The verdict half of `_run_fused` over K5's flags: the reference's
    cumulative block-sum gather (the plain version of the fused launch's
    keep bits, after `nfa_stream_plain`)."""
    bits = (flags[lane_slot.long() // 8, lane_row.long()].to(torch.int32)
            >> (lane_slot.long() % 8)[:, None].to(torch.int32)) & 1  # [N, Lo]
    csz = torch.nn.functional.pad(torch.cumsum(bits, dim=1), (1, 0))  # [N, Lo+1]
    ar = torch.arange(len(lane_row), device=flags.device)
    keep = csz[ar, lane_b1.long()] > csz[ar, lane_b0.long()]
    w = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=flags.device)
    return (keep.to(torch.int32).reshape(-1, 8) * w).sum(dim=1).to(torch.uint8)


def nfa_padded_plain(
    classes: torch.Tensor, gids: torch.Tensor, follow: torch.Tensor,
    accept: torch.Tensor, first: torch.Tensor, last: torch.Tensor,
) -> torch.Tensor:
    """Plain K6: the reference's float step over each lane's class ids, one
    Python step a position, a chunk of states meeting `last` in one
    product.  A verdict depends on the lane's rule and ids alone, so each
    distinct (rule, lane) is stepped once, with its rule's tensors
    gathered once."""
    g, bg, length = classes.shape
    lanes = torch.cat([gids.to(torch.int16)[:, None].expand(g, bg).reshape(-1, 1),
                       classes.reshape(-1, length).to(torch.int16)], dim=1)
    lanes, inverse = torch.unique(lanes, dim=0, return_inverse=True)
    rule, idx = lanes[:, 0].long(), lanes[:, 1:].long()
    n, dev = len(lanes), classes.device
    f, a = follow[rule], accept[rule]  # [n, 64, 64], [n, C, 64]
    fst, lst = first[rule][:, None, :], last[rule][:, :, None]
    state = torch.zeros((n, 1, 64), dtype=torch.float32, device=dev)
    chunk = torch.empty((n, STREAM_BLOCK, 64), dtype=torch.float32, device=dev)
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    ar = torch.arange(n, device=dev)
    with _no_tf32():
        for t0 in range(0, length, STREAM_BLOCK):
            steps = min(STREAM_BLOCK, length - t0)
            for i in range(steps):
                cmask = a[ar, idx[:, t0 + i]][:, None, :]  # [n, 1, 64]
                state = torch.baddbmm(fst, state, f).clamp_(max=1.0).mul_(cmask)
                chunk[:, i] = state[:, 0]
            matched |= (torch.bmm(chunk[:, :steps], lst)[..., 0] > 0).any(-1)
    return matched[inverse].reshape(g, bg)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_fn(symbol: str, signature: str):
    from trivy_tpu_torch.ops import _build

    return _build.function("nfa_verify", symbol, signature)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_device(name: str, t: torch.Tensor, *others: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    for o in others:
        if o.device != t.device:
            raise ValueError(f"{name}: operands on {o.device} and {t.device}")


def _check_stack_words(words: torch.Tensor) -> None:
    rb = words.shape[0] if words.dim() == 2 else 0
    if not 1 <= rb <= MAX_STACK or tuple(words.shape) != (rb, STREAM_WORDS) \
            or words.dtype != torch.int64:
        raise ValueError(f"rule stack words must be [rb <= {MAX_STACK}, "
                         f"{STREAM_WORDS}] int64, got {words.dtype} {tuple(words.shape)}")


def _check_table_words(words: torch.Tensor) -> None:
    if words.dim() != 2 or words.shape[1] != PADDED_WORDS or words.dtype != torch.int64:
        raise ValueError(f"rule words must be [R, {PADDED_WORDS}] int64")


def nfa_stream(rows: torch.Tensor, stack: NfaStack | torch.Tensor,
               assoc: bool = False) -> torch.Tensor:
    """K5 on `rows`' device over a rule stack (an `NfaStack`, or the words
    `nfa_stack` returns): the CUDA kernel on a card; on the CPU the plain
    version (`assoc` picks the associative-scan one) over the unpacked
    words."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] % STREAM_BLOCK:
        raise ValueError(f"rows must be [N, L] uint8 with L a multiple of "
                         f"{STREAM_BLOCK}, got {rows.dtype} {tuple(rows.shape)}")
    words = stack.words if isinstance(stack, NfaStack) else stack
    _check_stack_words(words)
    _check_device("nfa_stream", rows, words)
    if rows.device.type == "cpu":
        plain = nfa_stream_assoc_plain if assoc else nfa_stream_plain
        return plain(rows, *unpack_words(words))
    if not isinstance(stack, NfaStack):
        stack = NfaStack.from_words(words)
    return _stream_launch(rows, stack)


def _stream_launch(rows: torch.Tensor, stack: NfaStack, segments: int = 0) -> torch.Tensor:
    """Launch K5 on a card: each row split into `segments` (0: as many as
    `nfa_stream_segments` picks for the card) walked from the empty state,
    then the fix-up of the excess across their boundaries."""
    _check_device("nfa_stream", rows, stack.table)
    rows = _aligned(rows)
    n, length = rows.shape
    table = stack.table.contiguous()
    with torch.cuda.device(rows.device):
        if segments == 0:
            segments = _segments("nfa_stream_segments", rows.device.index, n, length,
                                 stack.width, stack.n_classes)
        out, buf = _word_padded((-(-stack.rb // 8), n, length // STREAM_BLOCK), torch.uint8,
                                rows.device)
        ends = torch.empty(((segments - 1) * n * stack.width,), dtype=torch.int64,
                           device=rows.device)
        err = _kernel_fn("nfa_stream", "piipiiiiippp")(
            rows.data_ptr(), n, length, table.data_ptr(), stack.width, stack.n_classes,
            stack.rb, int(stack.zero_dead), segments, ends.data_ptr(), buf.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _launched("nfa_stream", err)
    return out


@functools.lru_cache(maxsize=512)
def _segments(symbol: str, device_index: int, *shape: int) -> int:
    """The segment count `symbol` picks for a launch of `shape` on the
    current card (it depends on the shape and the card alone)."""
    got = _kernel_fn(symbol, "i" * len(shape))(*shape)
    if got < 1:
        raise RuntimeError(f"{symbol}{shape} failed")
    return got


def _word_padded(shape: tuple, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An uninitialised tensor of `shape` at the start of a buffer of whole
    32-bit words (the fix-up kernels set flag bits with 32-bit atomics):
    (tensor, buffer)."""
    n = int(np.prod(shape))
    buf = torch.empty((-(-n // 4) * 4,), dtype=dtype, device=device)
    return buf[:n].view(shape), buf


def nfa_stream_verdict(rows: torch.Tensor, stack: NfaStack | torch.Tensor,
                       lanes: LaneIndex | torch.Tensor | np.ndarray,
                       assoc: bool = False) -> torch.Tensor:
    """K5 in fused mode on `rows`' device: keep [N/8] uint8 for a lane table
    (a `LaneIndex`, or the [4, N] int32 table, N a multiple of 8, from which
    it is built).  On a card one launch (two when segmented) computes the
    verdict in the walk; on the CPU the plain flags (`assoc` picks the
    associative-scan version) and `nfa_fused_verdict_plain`.  A lane whose
    row, slot or blocks lie outside the launch keeps nothing."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] % STREAM_BLOCK:
        raise ValueError(f"rows must be [N, L] uint8 with L a multiple of "
                         f"{STREAM_BLOCK}, got {rows.dtype} {tuple(rows.shape)}")
    words = stack.words if isinstance(stack, NfaStack) else stack
    _check_stack_words(words)
    _check_device("nfa_stream_verdict", rows, words)
    n, length = rows.shape
    if rows.device.type == "cpu":
        table = lanes.lanes if isinstance(lanes, LaneIndex) else torch.as_tensor(lanes)
        if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != 4 \
                or table.shape[1] % 8:
            raise ValueError("lane table must be [4, N] int32, N a multiple of 8")
        # the plain version reads flags [ceil(rb/8), ...]: a slot past them
        # keeps nothing, as on the card
        keep = (table[1] >= 0) & (table[1] < 8 * -(-words.shape[0] // 8)) \
            & (table[0] >= 0) & (table[0] < n)
        table = torch.where(keep, table, torch.zeros_like(table))
        table[2:] = table[2:].clamp(0, length // STREAM_BLOCK)
        plain = nfa_stream_assoc_plain if assoc else nfa_stream_plain
        return nfa_fused_verdict_plain(plain(rows, *unpack_words(words)), *table)
    if not isinstance(stack, NfaStack):
        stack = NfaStack.from_words(words)
    if not isinstance(lanes, LaneIndex):
        lanes = LaneIndex.build(lanes, n, length // STREAM_BLOCK, stack.width, rows.device)
    if (lanes.n_rows, lanes.width) != (n, stack.width):
        raise ValueError(f"lane index for {lanes.n_rows} rows x {lanes.width} slots, "
                         f"launch of {n} rows x {stack.width}")
    return _verdict_launch(rows, stack, lanes)


def _verdict_launch(rows: torch.Tensor, stack: NfaStack, lanes: LaneIndex,
                    segments: int = 0) -> torch.Tensor:
    """Launch K5 in fused mode on a card (`segments` as `_stream_launch`)."""
    _check_device("nfa_stream_verdict", rows, stack.table, lanes.index)
    rows = _aligned(rows)
    n, length = rows.shape
    table = stack.table.contiguous()
    index = lanes.index.contiguous()
    n_keys, m = lanes.n_rows * lanes.width + 1, lanes.n_indexed
    ptrs = [index.data_ptr() + 4 * o for o in (0, n_keys, n_keys + m, n_keys + 2 * m,
                                               n_keys + 3 * m)]
    n_lanes = lanes.lanes.shape[1]
    with torch.cuda.device(rows.device):
        if segments == 0:
            segments = _segments("nfa_stream_segments", rows.device.index, n, length,
                                 stack.width, stack.n_classes)
        out, buf = _word_padded((n_lanes // 8,), torch.uint8, rows.device)
        ends = torch.empty(((segments - 1) * n * stack.width,), dtype=torch.int64,
                           device=rows.device)
        err = _kernel_fn("nfa_stream_verdict", "piipiiiiipppppppip")(
            rows.data_ptr(), n, length, table.data_ptr(), stack.width, stack.n_classes,
            stack.rb, int(stack.zero_dead), segments, ends.data_ptr(), *ptrs,
            buf.data_ptr(), buf.numel() // 4, torch.cuda.current_stream().cuda_stream,
        )
    _launched("nfa_fused", err)
    return out


def nfa_padded(classes: torch.Tensor, gids: torch.Tensor,
               tables: NfaTables | torch.Tensor) -> torch.Tensor:
    """K6 on `classes`' device over every rule's tables (an `NfaTables`, or
    the words `nfa_tables` returns): the CUDA kernel on a card, the plain
    version over the unpacked words on the CPU.  Class ids must be below 64
    and group ids below R, as the engine's are."""
    if classes.dtype != torch.uint8 or classes.dim() != 3 or classes.shape[2] % 16:
        raise ValueError(f"classes must be [G, Bg, L] uint8 with L a multiple of "
                         f"16, got {classes.dtype} {tuple(classes.shape)}")
    g = classes.shape[0]
    if gids.dtype != torch.int32 or tuple(gids.shape) != (g,):
        raise ValueError(f"gids must be [{g}] int32")
    words = tables.words if isinstance(tables, NfaTables) else tables
    _check_table_words(words)
    _check_device("nfa_padded", classes, gids, words)
    if classes.device.type == "cpu":
        return nfa_padded_plain(classes, gids, *unpack_words(words))
    if not isinstance(tables, NfaTables):
        tables = NfaTables.from_words(words)
    return _padded_launch(classes, gids, tables)


def _padded_launch(classes: torch.Tensor, gids: torch.Tensor, tables: NfaTables,
                   segments: int = 0) -> torch.Tensor:
    """Launch K6 on a card: each lane split into `segments` (0: as many as
    `nfa_padded_segments` picks for the card) walked from the empty state,
    then the fix-up of the excess across their boundaries."""
    _check_device("nfa_padded", classes, gids, tables.table)
    classes = _aligned(classes)
    gids = gids.contiguous()
    table = tables.table.contiguous()
    g, bg, length = classes.shape
    out = torch.empty((g, bg), dtype=torch.bool, device=classes.device)
    with torch.cuda.device(classes.device):
        if segments == 0:
            segments = _segments("nfa_padded_segments", classes.device.index, g, bg, length)
        scratch = g * bg * segments if segments > 1 else 0
        ends = torch.empty((scratch,), dtype=torch.int64, device=classes.device)
        info = torch.empty((scratch,), dtype=torch.int32, device=classes.device)
        err = _kernel_fn("nfa_padded", "piiippiipppp")(
            classes.data_ptr(), g, bg, length, gids.data_ptr(), table.data_ptr(),
            table.shape[0], segments, ends.data_ptr(), info.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _launched("nfa_padded", err)
    return out


def blocks_per_sm(kernel: str, stack: NfaStack | None = None) -> int:
    """Blocks of K5 ("nfa_stream", with `stack`'s image in shared memory)
    or K6 ("nfa_padded") one SM of the current card holds at once, from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    smem = stack.table.numel() * 8 if kernel == "nfa_stream" else 0
    got = _kernel_fn("nfa_blocks_per_sm", "ii")(0 if kernel == "nfa_stream" else 1, smem)
    if got < 0:
        raise RuntimeError(f"occupancy query for {kernel} failed")
    return got
