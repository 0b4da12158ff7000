"""The device verify's span assembly (`trivy_tpu_torch/engine/nfa_device.py`
`assemble_spans`, `native/span_assemble.cpp`) against a plain Python
assembly, the per-file loop `GpuNfaVerifier` ran before the native routine:

* per-tier row bytes, lane placement (lane id, tier, row, slot, first and
  last 32-byte block), the overflow lanes in order, and `span_bytes`;
* on seeded random lanes and on inputs built for one rule each: spans holding
  0x00, spans past the largest tier, a span that fills a row exactly, a span
  that ends a row at `cpos + len == length`, more than 32 distinct rules
  (rules spilled to the overflow), empty files, one file's lanes spread over
  several tiers' worth of windows, windows past the file's end;
* bad lanes refused before any pointer reaches the library.

Tolerance: exact.
"""

import numpy as np
import pytest

from trivy_tpu_torch.engine.nfa_device import (
    RULE_STACK_BUCKETS,
    STREAM_TIERS,
    assemble_spans,
)
from trivy_tpu_torch.ops.nfa_verify import STREAM_BLOCK


def plain_assembly(contents, pairs, start, stop, order, rule_slot):
    """The loop the verifier ran: (rows a tier, placed lanes as (lane, tier,
    row, slot, b0, b1) in placement order, overflow lanes, span bytes)."""
    tiers = STREAM_TIERS
    rows_buf: list[list[np.ndarray]] = [[] for _ in tiers]
    placed: list[tuple] = []
    overflow: list[int] = []
    open_row = [(-1, ln + 1) for ln in tiers]
    span_bytes = 0
    pos = 0
    while pos < len(order):
        end = pos
        f0 = pairs[order[pos], 0]
        while end < len(order) and pairs[order[end], 0] == f0:
            end += 1
        lanes_f = [int(li) for li in order[pos:end] if int(pairs[li, 1]) in rule_slot]
        overflow.extend(int(li) for li in order[pos:end]
                        if int(pairs[li, 1]) not in rule_slot)
        pos = end
        if not lanes_f:
            continue
        content = np.frombuffer(contents[int(pairs[lanes_f[0], 0])], dtype=np.uint8)
        s = int(min(start[li] for li in lanes_f))
        e = int(max(stop[li] for li in lanes_f))
        span = content[s:e]
        tier = next((t for t, ln in enumerate(tiers) if len(span) <= ln), -1)
        if tier < 0 or (span == 0).any():
            overflow.extend(lanes_f)
            continue
        length = tiers[tier]
        cur, cpos = open_row[tier]
        if cur < 0 or cpos + len(span) > length:
            rows_buf[tier].append(np.zeros(length, np.uint8))
            cur, cpos = len(rows_buf[tier]) - 1, 0
        rows_buf[tier][cur][cpos : cpos + len(span)] = span
        for li in lanes_f:
            rs0 = cpos + int(start[li]) - s
            rs1 = cpos + int(stop[li]) - s
            placed.append((li, tier, cur, rule_slot[int(pairs[li, 1])],
                           rs0 // STREAM_BLOCK, -(-rs1 // STREAM_BLOCK)))
        open_row[tier] = (cur, cpos + len(span) + 1)
        span_bytes += len(span)
    rows = [np.stack(b) if b else np.zeros((0, ln), np.uint8) for b, ln in zip(rows_buf, tiers)]
    return rows, placed, overflow, span_bytes


def _text(rng, n: int) -> bytes:
    return bytes(rng.integers(32, 127, n).astype(np.uint8))


def _random(seed: int):
    """Files of 0 to ~20 KB (some holding 0x00), 1-8 lanes each over up to
    40 rules, windows anywhere in the file."""
    rng = np.random.default_rng(seed)
    contents, lanes = [], []
    for f in range(int(rng.integers(40, 120))):
        n = int(rng.choice([0, 1, 200, 511, 512, 513, 3000, 4096, 9000, 16384, 20000]))
        n = max(0, n + int(rng.integers(-3, 4)))
        body = bytearray(_text(rng, n))
        if n and rng.random() < 0.1:
            body[int(rng.integers(0, n))] = 0
        contents.append(bytes(body))
        for _ in range(int(rng.integers(1, 9))):
            a, b = sorted(int(x) for x in rng.integers(0, n + 1, 2))
            if rng.random() < 0.5:  # a trimmed window, as the walk's clip makes
                a, b = a, min(b, a + int(rng.integers(0, 600)))
            lanes.append((f, int(rng.integers(0, 40)), a, b))
    return contents, lanes


def _built(case: str):
    """(contents, lanes (file, rule, start, stop)) for one named case."""
    rng = np.random.default_rng(7)
    t0, t1, t2 = STREAM_TIERS
    if case == "nul-spans":
        return ([_text(rng, 300), b"ab\x00cd" + _text(rng, 100), _text(rng, 50) + b"\x00",
                 _text(rng, 40)],
                [(0, 1, 0, 300), (1, 1, 0, 50), (1, 2, 4, 20), (2, 3, 0, 51),
                 (2, 3, 0, 10), (3, 1, 5, 9)])
    if case == "over-largest-tier":
        big = _text(rng, t2 + 10)
        return ([big, big, _text(rng, 100)],
                [(0, 1, 0, t2 + 1), (0, 2, 5, 10), (1, 1, 0, t2), (2, 4, 0, 100)])
    if case == "row-filled-exactly":
        return ([_text(rng, t0), _text(rng, t1), _text(rng, 10), _text(rng, t0)],
                [(0, 1, 0, t0), (1, 2, 0, t1), (2, 1, 0, 10), (3, 1, 0, t0)])
    if case == "row-ended-by-span":
        # cpos + len == length: 100 + 1 + 411 fills a 512 row, the next opens
        return ([_text(rng, 100), _text(rng, t0 - 101), _text(rng, 1), _text(rng, 1)],
                [(0, 1, 0, 100), (1, 1, 0, t0 - 101), (2, 2, 0, 1), (3, 2, 0, 0)])
    if case == "more-than-32-rules":
        body = _text(rng, 2000)
        lanes = [(i % 5, r, 10 * (r % 7), 10 * (r % 7) + 60)
                 for i, r in enumerate(range(45)) for _ in range(1 + (r < 20))]
        return [body] * 5, lanes
    if case == "empty-files":
        return ([b"", _text(rng, 30), b"", b""],
                [(0, 1, 0, 0), (1, 1, 0, 30), (2, 2, 0, 0), (2, 3, 0, 0), (3, 1, 0, 0)])
    if case == "lanes-over-several-tiers":
        body = _text(rng, t2)
        return ([body, _text(rng, 600), body],
                [(0, 1, 0, 100), (0, 2, 3000, 3100), (0, 3, 10000, 10100),
                 (1, 1, 0, 40), (1, 2, 500, 600), (2, 5, 100, 300), (2, 6, 4000, 4050)])
    if case == "windows-past-file-end":
        # clipped as a slice clips: the span ends at the file's end, or is
        # empty where every window starts past it
        return ([_text(rng, 20), _text(rng, 20), _text(rng, 20)],
                [(0, 1, 5, 40), (1, 1, 30, 50), (1, 2, 25, 26), (2, 1, 0, 20)])
    raise ValueError(case)


CASES = [f"random-{s}" for s in (1, 2, 3, 4)] + [
    "nul-spans", "over-largest-tier", "row-filled-exactly", "row-ended-by-span",
    "more-than-32-rules", "empty-files", "lanes-over-several-tiers", "windows-past-file-end"]


@pytest.mark.parametrize("case", CASES)
def test_native_assembly_equals_plain_loop(case):
    contents, lanes = (_random(int(case.split("-")[1])) if case.startswith("random")
                       else _built(case))
    pairs = np.asarray(lanes, dtype=np.int32)
    start, stop = pairs[:, 2].astype(np.int64), pairs[:, 3].astype(np.int64)
    # the verifier's rule slots: the 32 most-claimed rules, sorted
    rvals, rcounts = np.unique(pairs[:, 1], return_counts=True)
    keep_rules = np.sort(rvals[np.argsort(-rcounts, kind="stable")[: RULE_STACK_BUCKETS[-1]]])
    rule_slot = {int(r): i for i, r in enumerate(keep_rules)}
    slot_of = np.full(int(rvals[-1]) + 1, -1, dtype=np.int32)
    slot_of[keep_rules] = np.arange(len(keep_rules), dtype=np.int32)
    order = np.argsort(pairs[:, 0], kind="stable")

    want_rows, want_placed, want_overflow, want_bytes = plain_assembly(
        contents, pairs, start, stop, order, rule_slot)
    slots = slot_of[pairs[order, 1]]
    got = assemble_spans(contents, pairs[order, 0], slots, start[order], stop[order])

    for tier, (g, w) in enumerate(zip(got.rows, want_rows)):
        assert g.dtype == np.uint8 and g.shape == w.shape, tier
        np.testing.assert_array_equal(g, w, err_msg=f"tier {tier}")
    m = got.tier >= 0
    got_placed = list(zip(order[m].tolist(), got.tier[m].tolist(), got.row[m].tolist(),
                          slots[m].tolist(), got.b0[m].tolist(), got.b1[m].tolist()))
    assert got_placed == want_placed
    assert order[got.overflow].tolist() == want_overflow
    assert got.span_bytes == want_bytes
    assert len(want_placed) + len(want_overflow) == len(lanes)
    if case in ("nul-spans", "over-largest-tier", "more-than-32-rules"):
        assert want_overflow
    if case == "row-filled-exactly":
        assert [len(r) for r in want_rows] == [3, 1, 0]
    if case == "row-ended-by-span":
        assert len(want_rows[0]) == 2 and want_rows[0][0, -1] != 0
    if case == "lanes-over-several-tiers":
        assert all(len(r) for r in want_rows[1:])


@pytest.mark.parametrize("bad", ["file-past-contents", "negative-start", "stop-before-start",
                                 "unequal-columns"])
def test_bad_lanes_refused(bad):
    contents = [b"abc", b"defg"]
    files, slots = np.array([0, 1]), np.array([0, 0])
    start, stop = np.array([0, 1]), np.array([3, 4])
    if bad == "file-past-contents":
        files = np.array([0, 2])
    elif bad == "negative-start":
        start = np.array([-1, 1])
    elif bad == "stop-before-start":
        stop = np.array([3, 0])
    else:
        slots = np.array([0])
    with pytest.raises(ValueError):
        assemble_spans(contents, files, slots, start, stop)


def test_no_lanes():
    got = assemble_spans([b"abc"], np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0))
    assert [r.shape for r in got.rows] == [(0, ln) for ln in STREAM_TIERS]
    assert got.span_bytes == 0 and len(got.overflow) == 0 and len(got.tier) == 0
