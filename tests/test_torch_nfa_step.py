"""The tables and arithmetic of the redesigned device NFA verify kernels K5
and K6 (`trivy_tpu_torch/csrc/nfa_verify.cu`, `csrc/nfa_step.cuh`), on the
CPU, through numpy evaluators that read `NfaStack.table` and
`NfaTables.table` exactly as the kernels do:

* the decomposed reach, `((S & fwd) << 1) | (S & self)` plus the residual
  rows of the live exception positions, against the OR of follow rows over
  the set bits of S (`_reach` of tests/test_torch_nfa_verify.py);
* K5's live-slot packing (lanes for the first `rb_live` slots, the ballot's
  bits written as flag bytes), its zero-chunk skip (a 16-byte chunk of
  zeros sets S = 0 without being stepped, only when `zero_dead`) and its
  class-compressed accept (byte -> class map, class words), against the
  ctz-reach evaluator `_bitwise_stream` and the plain float step;
* K6's two early exits (a lane stops once it has matched, and past its last
  non-zero 16-byte chunk at the first step that leaves S unchanged), against
  `_bitwise_padded` and the plain float step;
* the host builders' tables against the follow, accept, first and last
  words reconstructed from them, and `zero_dead` with and without a live
  byte 0.

Cases: the builtin ruleset's stacks at rb 4, 8, 16 and 32, 10 rules in a 16
bucket, a dense random follow (every position an exception), a random
accept with 256 distinct byte columns, a stack with a live byte 0,
hypothesis-drawn automata; rows with zero chunks at the head, middle (across
a 32-byte flag block) and tail, and all-zero rows; K6 lanes that match
early, lanes of padding only, NUL in mid-data, and a rule whose padding
orbit has period 2.  Tolerance: exact (bit patterns and booleans).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_nfa_verify import (
    _bitwise_padded,
    _bitwise_stream,
    _builtin_verifier,
    _random_stack,
    _reach,
    _real_stack,
    _rows,
)

from trivy_tpu_torch.ops import nfa_verify as nv

MASK64 = (1 << 64) - 1
POS = np.arange(64, dtype=np.uint64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# -- numpy evaluators of the kernels' arithmetic -----------------------------


def _reach_decomposed(s, fwd, own, exc, residual):
    """((S & fwd) << 1) | (S & self) | OR_{p in S & exc} residual[p]; s, fwd,
    own, exc broadcast together, residual [..., 64] beside them."""
    r = ((s & fwd) << np.uint64(1)) | (s & own)
    on = ((s & exc)[..., None] >> POS) & np.uint64(1)
    return r | np.bitwise_or.reduce(np.where(on == 1, residual, np.uint64(0)), axis=-1)


def _k5_sections(stack: nv.NfaStack):
    """The stack image's sections as K5 reads them from shared memory."""
    img = stack.table.numpy().view(np.uint64)
    w, c = stack.width, stack.n_classes
    assert len(img) == (nv.RULE_WORDS + c) * w + nv.MAP_WORDS
    step = img[: nv.STEP_WORDS * w].reshape(nv.STEP_WORDS, w)  # [5, W]
    residual = img[nv.STEP_WORDS * w : nv.RULE_WORDS * w].reshape(64, w).T  # [W, 64]
    ctab = img[nv.RULE_WORDS * w : (nv.RULE_WORDS + c) * w].reshape(c, w)  # [C, W]
    cmap = img[(nv.RULE_WORDS + c) * w :].view(np.uint8)  # [256]
    return step, residual, ctab, cmap


def _k5_eval(rows: np.ndarray, stack: nv.NfaStack, counts: dict | None = None,
             segments: int = 1, fix: bool = True) -> np.ndarray:
    """K5 on `rows` [N, L]: lanes (row, slot < width), two 16-byte chunks a
    32-byte block, a chunk of zeros skipped (S = 0) when `zero_dead`, the
    block's states ORed and met with `last`, the row's ballot bits written
    as flag bytes p < ceil(rb/8).  Each row is walked as `segments` segments
    from the empty state (phase 1), then the excess over each later
    segment's empty start is carried across the boundaries (phase 2).
    `counts` gets the lane-steps phase 1 stepped and the bytes phase 2 did
    (`fix` False leaves phase 2 out)."""
    step, residual, ctab, cmap = _k5_sections(stack)
    fwd, own, exc, first, last = (step[k][:, None] for k in range(5))  # [W, 1]
    res = residual[:, None, :]  # [W, 1, 64]
    w = stack.width
    n, length = rows.shape
    lo = length // 32
    seg_blocks = lo // segments
    hit = np.zeros((w, n, lo), bool)
    ends = []
    stepped = 0
    for k in range(segments):
        s = np.zeros((w, n), np.uint64)  # every segment starts empty
        j1 = (k + 1) * seg_blocks if k + 1 < segments else lo
        for j in range(k * seg_blocks, j1):
            seen = np.zeros((w, n), np.uint64)
            for h in range(2):
                chunk = rows[:, 32 * j + 16 * h : 32 * j + 16 * h + 16]
                skip = stack.zero_dead & ~chunk.any(axis=1)  # [N]
                stepped += 16 * w * int((~skip).sum())
                for i in range(16):
                    acc = ctab[cmap[chunk[:, i]]].T  # [W, N]
                    s2 = (_reach_decomposed(s, fwd, own, exc, res) | first) & acc
                    s = np.where(skip, s, s2)
                    seen |= np.where(skip, np.uint64(0), s2)
                s = np.where(skip, np.uint64(0), s)
            hit[:, :, j] = (seen & last) != 0
        ends.append(s)
    fixed = 0
    seg_len = 32 * seg_blocks
    for slot in range(w if fix else 0):  # phase 2: a thread per (row, slot)
        row = [int(x) for x in step[:, slot]] + [int(x) for x in residual[slot]]
        for r in range(n):
            g = int(ends[0][slot, r])
            for k in range(1, segments):
                t1 = (k + 1) * seg_len if k + 1 < segments else length
                t = k * seg_len
                while g and t < t1:
                    g = _py_reach(g, row) & int(ctab[cmap[rows[r, t]], slot])
                    if g & row[4]:
                        hit[slot, r, t // 32] = True
                    t += 1
                    fixed += 1
                if k + 1 < segments:
                    g |= int(ends[k][slot, r])
    # the ballot: bit `slot` of a row's word; byte p of the word is flag byte p
    bits = (hit.astype(np.uint64) << np.arange(w, dtype=np.uint64)[:, None, None]).sum(
        axis=0, dtype=np.uint64)
    out = np.stack([(bits >> np.uint64(8 * p)) & np.uint64(0xFF)
                    for p in range(-(-stack.rb // 8))]).astype(np.uint8)
    if counts is not None:
        counts["stepped"], counts["fixed"] = stepped, fixed
    return out


def _py_reach(s: int, row: list[int]) -> int:
    fwd, own, exc = row[0], row[1], row[2]
    r = ((s & fwd) << 1) & MASK64 | (s & own)
    e = s & exc
    while e:
        low = e & -e
        r |= row[nv.STEP_WORDS + low.bit_length() - 1]
        e ^= low
    return r


def _k6_segment(row: list[int], ids: np.ndarray) -> tuple[bool, int, int, str]:
    """One K6 segment walked from the empty state over its class ids:
    (matched, state at its end, local end in 16-byte chunks, exit), exit one
    of "matched" (inside its data), "matched-tail" (past its local end),
    "fixed" (a fixed point past it), "walked" (to the segment's end)."""
    first, last = row[3], row[4]
    cm = row[nv.RULE_WORDS :]
    n16 = len(ids) // 16
    nz = np.flatnonzero(ids.reshape(n16, 16).any(axis=1))
    end = int(nz[-1]) + 1 if len(nz) else 0
    s = seen = 0
    for t in range(end):
        for c in ids[16 * t : 16 * t + 16].tolist():
            s = (_py_reach(s, row) | first) & (cm[c] if c < 64 else 0)
            seen |= s
        if seen & last:
            return True, s, end, "matched"
    for _ in range(16 * end, len(ids)):
        nxt = (_py_reach(s, row) | first) & cm[0]
        if nxt & last:
            return True, nxt, end, "matched-tail"
        if nxt == s:
            return False, s, end, "fixed"
        s = nxt
    return False, s, end, "walked"


def _k6_walk(row: list[int], lane: np.ndarray, segments: int = 1,
             counts: dict | None = None) -> tuple[bool, str]:
    """One K6 lane as the kernel walks it: `segments` segments from the
    empty state (phase 1), then, unless one matched, the excess over each
    later segment's empty start across the boundaries (phase 2): until it
    dies, reaches a fixed point past the segment's local end, or the segment
    ends.  (matched, the exit of the first segment that decided it)."""
    seg_len = len(lane) // 16 // segments * 16
    walks = []
    for k in range(segments):
        t1 = (k + 1) * seg_len if k + 1 < segments else len(lane)
        walks.append(_k6_segment(row, lane[k * seg_len : t1]))
    for m, _, _, how in walks:
        if m:
            return True, how
    last, cm = row[4], row[nv.RULE_WORDS :]
    x = walks[0][1]
    for k in range(1, segments):
        t0 = k * seg_len
        t1 = t0 + seg_len if k + 1 < segments else len(lane)
        zeros_from = t0 + 16 * walks[k][2]
        t = t0
        while x and t < t1:
            c = int(lane[t])
            nxt = _py_reach(x, row) & (cm[c] if c < 64 else 0)
            if counts is not None:
                counts["fixed"] = counts.get("fixed", 0) + 1
            if nxt & last:
                return True, "matched-excess"
            if t >= zeros_from and nxt == x:
                break
            x = nxt
            t += 1
        x |= walks[k][1]
    return False, walks[-1][3] if segments == 1 else "segments"


def _k6_eval(classes: np.ndarray, gids: np.ndarray, tables: nv.NfaTables,
             segments: int = 1, counts: dict | None = None):
    """K6 on class ids [G, Bg, L]: matched [G, Bg] and each lane's exit."""
    rows = tables.table.numpy().view(np.uint64)
    g, bg, _ = classes.shape
    matched = np.zeros((g, bg), bool)
    exits = np.empty((g, bg), object)
    for gi in range(g):
        r = int(gids[gi])
        row = [int(x) for x in rows[r]] if 0 <= r < len(rows) else [0] * nv.PADDED_TABLE_WORDS
        for b in range(bg):
            matched[gi, b], exits[gi, b] = _k6_walk(row, classes[gi, b], segments, counts)
    return matched, exits


# -- stacks and rows ----------------------------------------------------------


def _dense_stack(rng, rb: int):
    """Dense random automata: every position has edges besides p -> p + 1
    and p -> p, so every position is an exception; byte 0 dead."""
    follow = (rng.random((rb, 64, 64)) < 0.4).astype(np.float32)
    accept_b = (rng.random((rb, 256, 64)) < 0.3).astype(np.float32)
    first = (rng.random((rb, 64)) < 0.2).astype(np.float32)
    last = (rng.random((rb, 64)) < 0.05).astype(np.float32)
    accept_b[:, 0] = 0.0
    return follow, accept_b, first, last


def _wide_accept_stack(rng, rb: int):
    """A sparse stack whose accept words give 256 distinct byte columns."""
    follow, _, first, last = _random_stack(rng, rb)
    accept_b = (rng.random((rb, 256, 64)) < 0.5).astype(np.float32)
    accept_b[:, 0] = 0.0
    accept_b[:, 1:, 0] = 1.0  # no other column is all zero
    return follow, accept_b, first, last


def _padded_stack(arrays, rb: int):
    """`arrays` of fewer rules in an rb-slot stack: the last slots zero."""
    out = []
    for a in arrays:
        z = np.zeros((rb,) + a.shape[1:], np.float32)
        z[: len(a)] = a
        out.append(z)
    return tuple(out)


def _chunky_rows(rng, n: int, length: int) -> np.ndarray:
    """`_rows`' secrets and separators with zero 16-byte chunks at a row's
    head, middle (16..48, across the first flag block), tail, and whole
    zero rows (row 1 and the last)."""
    rows = _rows(rng, n, length)
    rows[0, :48] = 0
    rows[2, 16:48] = 0
    rows[3, length - 80 :] = 0
    rows[4, 96:112] = 0
    rows[-1] = 0
    sec = np.frombuffer(b"ghp_" + b"a1B2" * 9, np.uint8)
    rows[5, 48 : 48 + len(sec)] = sec  # right after a zero chunk
    rows[5, 32:48] = 0
    return rows


def _stack_case(kind: str, rb: int):
    rng = np.random.default_rng(rb + len(kind))
    if kind == "real":
        return _real_stack(rb)
    if kind == "real10in16":
        return _padded_stack(_real_stack(10), 16)
    if kind == "dense":
        return _dense_stack(rng, rb)
    if kind == "wide":
        return _wide_accept_stack(rng, rb)
    return _random_stack(rng, rb)  # "live0": byte 0 live in some slots


STACK_CASES = [("real", 4), ("real", 8), ("real", 16), ("real", 32), ("real10in16", 16),
               ("dense", 3), ("wide", 8), ("live0", 5)]


# -- the host tables ----------------------------------------------------------


def _rebuild_follow(fwd, own, residual) -> np.ndarray:
    """follow[p] from the decomposed step words (uint64)."""
    nxt = np.where(POS < 63, np.uint64(1) << np.minimum(POS + np.uint64(1), np.uint64(63)),
                   np.uint64(0))
    fb = ((fwd[:, None] >> POS) & np.uint64(1)) == 1
    sb = ((own[:, None] >> POS) & np.uint64(1)) == 1
    return (np.where(fb, nxt, np.uint64(0)) | np.where(sb, np.uint64(1) << POS, np.uint64(0))
            | residual)


@pytest.mark.parametrize("kind,rb", STACK_CASES)
def test_stack_tables_rebuild_the_words(kind, rb):
    arrays = _stack_case(kind, rb)
    stack = nv.NfaStack.build(*arrays, device="cpu")
    words = stack.words.numpy().view(np.uint64)
    assert stack.rb == rb and torch.equal(stack.words, nv.nfa_stack(*arrays, device="cpu"))
    live = [s for s in range(rb) if words[s].any()]
    assert stack.rb_live == live[-1] + 1 and stack.width == stack.rb_live
    assert stack.rb_live == (10 if kind == "real10in16" else rb)
    step, residual, ctab, cmap = _k5_sections(stack)
    w = stack.width
    fwd, own, exc, first, last = step
    np.testing.assert_array_equal(_rebuild_follow(fwd, own, residual), words[:w, :64])
    np.testing.assert_array_equal(exc, nv.pack_bits64(residual != 0).view(np.uint64))
    nxt_edge = ((residual >> np.minimum(POS + np.uint64(1), np.uint64(63))) & np.uint64(1)) == 1
    own_edge = ((residual >> POS) & np.uint64(1)) == 1
    fb = ((fwd[:, None] >> POS) & np.uint64(1)) == 1
    sb = ((own[:, None] >> POS) & np.uint64(1)) == 1
    assert not (nxt_edge & fb).any() and not (own_edge & sb).any()  # no edge twice
    assert not (fwd >> np.uint64(63)).any()
    np.testing.assert_array_equal(first, words[:w, 320])
    np.testing.assert_array_equal(last, words[:w, 321])
    # class-compressed accept: the class word of each byte is its accept word
    np.testing.assert_array_equal(ctab[cmap].T, words[:w, 64:320])
    assert stack.n_classes == len(np.unique(words[:w, 64:320].T, axis=0)) <= 256
    if kind == "wide":
        assert stack.n_classes == 256
    if kind == "dense":
        assert (exc == np.uint64(MASK64)).all()  # every position an exception
    assert stack.zero_dead == (kind != "live0")
    assert stack.nbytes == stack.words.nbytes + stack.table.nbytes


def test_zero_dead_needs_byte_0_dead_in_every_live_slot():
    follow, accept_b, first, last = _real_stack(4)
    assert nv.NfaStack.build(follow, accept_b, first, last, "cpu").zero_dead
    live0 = accept_b.copy()
    live0[2, 0, 5] = 1.0
    assert not nv.NfaStack.build(follow, live0, first, last, "cpu").zero_dead
    # byte 0 live only in a slot past rb_live: no such slot has any word
    stack = nv.NfaStack.build(*_padded_stack((follow, accept_b, first, last), 8), "cpu")
    assert stack.zero_dead and stack.rb_live == 4


def test_empty_stack_keeps_one_slot():
    zeros = (np.zeros((3, 64, 64), np.float32), np.zeros((3, 256, 64), np.float32),
             np.zeros((3, 64), np.float32), np.zeros((3, 64), np.float32))
    stack = nv.NfaStack.build(*zeros, "cpu")
    assert (stack.rb_live, stack.width, stack.n_classes) == (0, 1, 1) and stack.zero_dead
    rows = _chunky_rows(np.random.default_rng(0), 6, 128)
    assert not _k5_eval(rows, stack).any()


def test_padded_tables_rebuild_the_words():
    ver = _builtin_verifier()
    arrays = (ver.follow, ver.accept, ver.first, ver.last)
    tables = nv.NfaTables.build(*arrays, device="cpu")
    assert torch.equal(tables.words, nv.nfa_tables(*arrays, device="cpu"))
    t = tables.table.numpy().view(np.uint64)
    w = tables.words.numpy().view(np.uint64)
    assert t.shape == (ver.num_rules, nv.PADDED_TABLE_WORDS)
    np.testing.assert_array_equal(
        _rebuild_follow(t[:, 0], t[:, 1], t[:, nv.STEP_WORDS : nv.RULE_WORDS]), w[:, :64])
    np.testing.assert_array_equal(t[:, 2], nv.pack_bits64(
        t[:, nv.STEP_WORDS : nv.RULE_WORDS] != 0).view(np.uint64))
    np.testing.assert_array_equal(t[:, 3], w[:, 128])
    np.testing.assert_array_equal(t[:, 4], w[:, 129])
    np.testing.assert_array_equal(t[:, nv.RULE_WORDS :], w[:, 64:128])
    # the builtin rules: most edges are p -> p + 1, and many rules need no
    # residual row at all
    has = ver.has_nfa
    assert (t[has, 2] == 0).sum() > has.sum() // 4


@pytest.mark.parametrize("kind,rb", [("real", 32), ("dense", 4), ("live0", 6)])
def test_decomposed_reach_equals_ctz_reach(kind, rb):
    arrays = _stack_case(kind, rb)
    words = nv.nfa_stack(*arrays, device="cpu").numpy().view(np.uint64)
    fwd, own, exc, residual = nv.step_words(words[:, :64])
    rng = np.random.default_rng(rb)
    for density in (0.02, 0.2, 0.6, 1.0):
        bits = rng.random((rb, 50, 64)) < density
        s = nv.pack_bits64(bits).view(np.uint64)  # [rb, 50]
        got = _reach_decomposed(s, fwd[:, None], own[:, None], exc[:, None],
                                residual[:, None, :])
        np.testing.assert_array_equal(got, _reach(words[:, None, :64], s))


# -- K5 -----------------------------------------------------------------------


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("kind,rb", STACK_CASES)
def test_k5_evaluator_equals_ctz_evaluator_and_plain(kind, rb, segments):
    arrays = _stack_case(kind, rb)
    stack = nv.NfaStack.build(*arrays, device="cpu")
    rows = _chunky_rows(np.random.default_rng(rb + 17), 8, 256)
    counts: dict = {}
    got = _k5_eval(rows, stack, counts, segments)
    want = _bitwise_stream(rows, stack.words.numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, nv.nfa_stream_plain(_t(rows), *map(_t, arrays)).numpy())
    # the wrapper takes the object or the words alike
    np.testing.assert_array_equal(got, nv.nfa_stream(_t(rows), stack).numpy())
    assert got.shape == (-(-rb // 8), 8, 8)
    assert got.any() or kind == "dense"
    # live-slot packing: no bit for a slot past rb_live
    slot_bits = np.unpackbits(got[..., None], axis=-1, bitorder="little")  # [P, N, Lo, 8]
    per_slot = slot_bits.transpose(0, 3, 1, 2).reshape(-1, 8, 8)[:rb]
    assert not per_slot[stack.rb_live :].any()
    # the zero-chunk skip: what a zero_dead stack steps, what the others do
    chunks = rows.reshape(8, -1, 16).any(axis=2)
    if stack.zero_dead:
        assert counts["stepped"] == 16 * stack.width * int(chunks.sum())
        assert not got[:, [1, -1]].any()
    else:
        assert counts["stepped"] == stack.width * rows.size


@pytest.mark.parametrize("segments", [2, 8])
def test_k5_segments_carry_the_excess_across_boundaries(segments):
    """Secrets straddling every segment boundary: the speculative walk of
    the later segment misses them, the fix-up's excess finds them; a dense
    stack keeps its excess alive across whole segments."""
    rows = _chunky_rows(np.random.default_rng(segments), 8, 512)
    seg_len = 512 // segments
    sec = np.frombuffer(b"ghp_" + b"a1B2" * 9, np.uint8)
    for k in range(1, segments):
        rows[6, k * seg_len - 20 : k * seg_len - 20 + len(sec)] = sec
    for kind, rb in (("real", 8), ("dense", 3)):
        stack = nv.NfaStack.build(*_stack_case(kind, rb), device="cpu")
        counts: dict = {}
        got = _k5_eval(rows, stack, counts, segments)
        want = _bitwise_stream(rows, stack.words.numpy())
        np.testing.assert_array_equal(got, want)
        assert counts["fixed"] > 0  # the fix-up walked an excess
        if kind == "real":  # without the fix-up the straddling secrets are lost
            assert not np.array_equal(_k5_eval(rows, stack, None, segments, fix=False), want)


def test_k5_live_byte_0_is_stepped_through_zero_chunks():
    """A live byte 0 carries state through a zero chunk: skipping it would
    change the flags, so such a stack steps every byte."""
    follow = np.zeros((2, 64, 64), np.float32)
    accept_b = np.zeros((2, 256, 64), np.float32)
    first = np.zeros((2, 64), np.float32)
    last = np.zeros((2, 64), np.float32)
    # slot 0: "a" then any run of zeros then "b"; slot 1 the same with byte 0 dead
    for s in range(2):
        first[s, 0] = 1.0
        follow[s, 0, 1] = follow[s, 0, 2] = follow[s, 1, 1] = follow[s, 1, 2] = 1.0
        accept_b[s, ord("a"), 0] = accept_b[s, ord("b"), 2] = 1.0
        last[s, 2] = 1.0
    accept_b[0, 0, 1] = 1.0
    stack = nv.NfaStack.build(follow, accept_b, first, last, "cpu")
    assert not stack.zero_dead
    rows = np.zeros((2, 64), np.uint8)
    rows[0, 15], rows[0, 40] = ord("a"), ord("b")  # a, 24 zeros (a zero chunk), b
    rows[1, 0], rows[1, 1] = ord("a"), ord("b")
    got = _k5_eval(rows, stack)
    np.testing.assert_array_equal(got, _bitwise_stream(rows, stack.words.numpy()))
    assert got[0, 0, 1] == 0b01 and got[0, 1, 0] == 0b11
    skipped = nv.NfaStack(**{**stack.__dict__, "zero_dead": True})  # a wrong skip
    assert _k5_eval(rows, skipped)[0, 0, 1] == 0


# -- K6 -----------------------------------------------------------------------


def _period2_rule(classes_rule: int, r: int):
    """Rule tensors [r, ...] where rule `classes_rule` has a padding orbit
    of period 2: class 1 enters position 2, 2 -> 0 -> 1 -> 0 ... under class
    0, and nothing reaches the final position 3 without class 2."""
    follow = np.zeros((r, 64, 64), np.float32)
    accept = np.zeros((r, 64, 64), np.float32)
    first = np.zeros((r, 64), np.float32)
    last = np.zeros((r, 64), np.float32)
    i = classes_rule
    first[i, 2] = 1.0
    follow[i, 2, 0] = follow[i, 0, 1] = follow[i, 1, 0] = follow[i, 1, 3] = 1.0
    accept[i, 1, 2] = accept[i, 0, 0] = accept[i, 0, 1] = accept[i, 2, 3] = 1.0
    last[i, 3] = 1.0
    return follow, accept, first, last


@pytest.mark.parametrize("segments", [1, 8])
def test_k6_evaluator_equals_ctz_evaluator_and_plain_on_builtin_rules(segments):
    ver = _builtin_verifier()
    arrays = (ver.follow, ver.accept, ver.first, ver.last)
    tables = nv.NfaTables.build(*arrays, device="cpu")
    rng = np.random.default_rng(11)
    # github-pat, slack-access-token, stripe-secret-token (secrets in `_rows`),
    # then a padding group: rule 0 over zeros
    gids = np.array([2, 11, 13, 0], np.int32)
    assert ver.has_nfa[gids].all()
    length = 256
    classes = np.zeros((4, 8, length), np.uint8)
    for g, r in enumerate(gids[:3]):
        data = _rows(rng, 8, length)
        data[:, length // 2 :] = 0  # windows shorter than their bucket
        data[2, 40:60] = 0  # NUL in mid-data
        classes[g] = ver.luts[r][data]
        classes[g, 5] = 0  # a lane of padding only
    got, exits = _k6_eval(classes, gids, tables, segments)
    np.testing.assert_array_equal(got, _bitwise_padded(classes, gids, tables.words.numpy()))
    np.testing.assert_array_equal(
        got, nv.nfa_padded_plain(_t(classes), _t(gids), *map(_t, arrays)).numpy())
    np.testing.assert_array_equal(got, nv.nfa_padded(_t(classes), _t(gids), tables).numpy())
    kinds = set(exits.ravel())
    assert "matched" in kinds and ("fixed" in kinds or segments > 1)
    assert got.any() and not got.all()


def test_k6_early_exits_keep_the_answer():
    """Random rules with a live class 0: lanes that match at step 0, lanes
    of padding only, lanes whose padding keeps the state moving, and a rule
    whose padding orbit has period 2 (it walks to the length)."""
    rng = np.random.default_rng(5)
    r = 4
    follow, accept_b, first, last = _random_stack(rng, r)
    accept = accept_b[:, :64].copy()
    p2 = _period2_rule(3, r)
    for a, b in zip((follow, accept, first, last), p2):
        a[3] = b[3]
    accept[0, 0, :] = 1.0  # rule 0: class 0 accepts every position
    accept[:3, 62, 62:] = 1.0  # class ids 62 62 match rules 0-2 ("zz")
    tables = nv.NfaTables.build(follow, accept, first, last, "cpu")
    length = 128
    classes = rng.integers(0, 64, size=(4, 8, length), dtype=np.uint8)
    classes[:, 1] = 0  # padding only
    classes[:, 2, length // 4 :] = 0  # short window
    classes[:, 3, :] = 0
    classes[:, 3, 0:2] = (62, 62)  # a match at once for rules 0-2 ("zz")
    classes[3] = 0
    classes[3, :, 3] = 1  # rule 3: enter the period-2 orbit, then padding
    classes[3, 4, 6] = 2  # ... and a lane that leaves it to match
    gids = np.array([0, 1, 2, 3], np.int32)
    got, exits = _k6_eval(classes, gids, tables)
    np.testing.assert_array_equal(got, _bitwise_padded(classes, gids, tables.words.numpy()))
    np.testing.assert_array_equal(got, nv.nfa_padded_plain(
        _t(classes), _t(gids), *map(_t, (follow, accept, first, last))).numpy())
    assert got[:3, 3].all() and exits[0, 3] == "matched"
    assert exits[3, 0] == "walked" and not got[3, 0]  # the orbit never settles
    assert got[3, 4]
    assert "fixed" in set(exits.ravel())


@pytest.mark.parametrize("segments", [2, 4, 16])
def test_k6_segments_carry_the_excess_across_boundaries(segments):
    """A match straddling a segment boundary (found only by the fix-up's
    excess), the period-2 orbit across boundaries, and random lanes."""
    rng = np.random.default_rng(segments)
    r = 4
    follow, accept_b, first, last = _random_stack(rng, r)
    accept = accept_b[:, :64].copy()
    accept[:3, 62, 62:] = 1.0  # class ids 62 62 match rules 0-2
    accept[:3, 0] = 0.0
    first[:, 63], last[:, 63] = 0.0, 1.0
    for a, b in zip((follow, accept, first, last), _period2_rule(3, r)):
        a[3] = b[3]
    tables = nv.NfaTables.build(follow, accept, first, last, "cpu")
    length = 512
    seg_len = length // segments
    classes = rng.integers(0, 64, size=(4, 8, length), dtype=np.uint8)
    classes[:, 0] = 0
    classes[:, 0, seg_len - 1 : seg_len + 1] = 62  # across the first boundary
    classes[:, 1, length // 3 :] = 0
    classes[3] = 0
    classes[3, :, 3] = 1  # rule 3's orbit runs through every later segment
    gids = np.arange(4, dtype=np.int32)
    counts: dict = {}
    got, exits = _k6_eval(classes, gids, tables, segments, counts)
    np.testing.assert_array_equal(got, _bitwise_padded(classes, gids, tables.words.numpy()))
    assert got[:3, 0].all() and exits[0, 0] == "matched-excess"
    assert not got[3].any() and counts["fixed"] >= length - seg_len - 16


# -- hypothesis-drawn automata -------------------------------------------------


def _drawn_stack(seed: int, rb: int, n_pos: int, chain: float, extra: float, loop: float):
    """rb automata over n_pos positions: chains p -> p + 1 at rate `chain`,
    self loops at `loop`, other edges at `extra`; accept over a small
    alphabet ("abz" and 0x00, live in a few slots)."""
    rng = np.random.default_rng(seed)
    follow = np.zeros((rb, 64, 64), np.float32)
    p = np.arange(n_pos - 1)
    follow[:, p, p + 1] = rng.random((rb, n_pos - 1)) < chain
    q = np.arange(n_pos)
    follow[:, q, q] = rng.random((rb, n_pos)) < loop
    follow[:, :n_pos, :n_pos] = np.maximum(
        follow[:, :n_pos, :n_pos], rng.random((rb, n_pos, n_pos)) < extra)
    accept_b = np.zeros((rb, 256, 64), np.float32)
    for byte in (0, ord("a"), ord("b"), ord("z")):
        accept_b[:, byte, :n_pos] = rng.random((rb, n_pos)) < 0.5
    accept_b[: rb // 2, 0] = 0.0  # byte 0 dead in some slots, live in others
    first = np.zeros((rb, 64), np.float32)
    last = np.zeros((rb, 64), np.float32)
    first[:, :n_pos] = rng.random((rb, n_pos)) < 0.3
    last[:, :n_pos] = rng.random((rb, n_pos)) < 0.2
    return follow, accept_b, first, last


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rb=st.integers(1, 9), n_pos=st.integers(2, 64),
       chain=st.floats(0.0, 1.0), extra=st.sampled_from([0.0, 0.02, 0.2]),
       loop=st.floats(0.0, 0.5), dead0=st.booleans(), segments=st.sampled_from([1, 2, 4]))
def test_drawn_automata_k5_and_k6_equal_ctz_evaluators(seed, rb, n_pos, chain, extra, loop,
                                                       dead0, segments):
    arrays = _drawn_stack(seed, rb, n_pos, chain, extra, loop)
    if dead0:
        arrays[1][:, 0] = 0.0
    stack = nv.NfaStack.build(*arrays, device="cpu")
    assert stack.zero_dead == (dead0 or not arrays[1][:, 0].any())
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abz\x00", np.uint8)
    rows = rng.choice(alphabet, size=(6, 64))
    rows[0, :16] = 0
    rows[1, 16:48] = 0
    rows[2] = 0
    np.testing.assert_array_equal(_k5_eval(rows, stack, None, segments),
                                  _bitwise_stream(rows, stack.words.numpy()))
    # the same automata as K6 rules over class ids: byte 0 class 0, "a" 1,
    # "b" 2, "z" 3
    lut = np.zeros(256, np.uint8)
    accept = np.zeros((rb, 64, 64), np.float32)
    for c, byte in enumerate((0, ord("a"), ord("b"), ord("z"))):
        lut[byte] = c
        accept[:, c] = arrays[1][:, byte]
    tables = nv.NfaTables.build(arrays[0], accept, arrays[2], arrays[3], "cpu")
    classes = np.broadcast_to(lut[rows], (rb, 6, 64)).copy()
    gids = np.arange(rb, dtype=np.int32)
    got, _ = _k6_eval(classes, gids, tables, segments)
    np.testing.assert_array_equal(got, _bitwise_padded(classes, gids, tables.words.numpy()))


# -- the engine builds the objects ---------------------------------------------


def test_engine_builds_the_tables_once():
    from trivy_tpu_torch.engine.nfa_device import GpuNfaVerifier
    from trivy_tpu_torch.rules.model import build_ruleset

    ver = GpuNfaVerifier(build_ruleset(None).rules, device="cpu")
    tables = ver._device_tables()
    assert isinstance(tables, nv.NfaTables) and ver._device_tables() is tables
    assert torch.equal(tables.words, nv.nfa_tables(ver.follow, ver.accept, ver.first,
                                                   ver.last, device="cpu"))
