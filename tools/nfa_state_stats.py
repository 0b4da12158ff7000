#!/usr/bin/env python3
"""How sparse the device NFA verify's states are on the hit-dense corpus,
and how far the excess of a speculative segment walks (CPU, numpy).

    python3 tools/nfa_state_stats.py [N_FILES]

Scans `bench_corpus.make_hitdense_corpus(N_FILES, seed=13)` plus four
NUL-bracketed and four ~49 KB files (as `chip_smoke.py` does) through
`GpuHybridSecretEngine(device="cpu", verify="fused")`, keeps the verifier's
K5 and K6 calls, and prints one JSON line each:

* K5, on (up to 90 non-zero rows of) the largest stream dispatch and its
  rule stack: the mean set bits of the state S and of S & exc (the live
  exception positions, which the decomposed step loops over) per
  lane-step, and their maxima over the lanes of a 3-row warp, averaged
  over warp-steps (what a warp's loop runs);
* K6, on the 32,768-id padded dispatch: the lanes with data, and the steps
  the excess walks in the fix-up when each lane is cut into 16 and 128
  segments (`csrc/nfa_verify.cu`, "Segments").

Each evaluation steps the automata bitwise from the words the kernels
read; the corpus is small (default 1,500 files) so it runs in a minute.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POS = np.arange(64, dtype=np.uint64)


def _popcount(x: np.ndarray) -> np.ndarray:
    return ((x[..., None] >> POS) & np.uint64(1)).sum(-1)


def stream_stats(nv, rows: np.ndarray, words: np.ndarray) -> dict:
    w = words.view(np.uint64)
    w = w[: 1 + int(np.flatnonzero(w.any(axis=1))[-1])]
    _fwd, _own, exc, _res = nv.step_words(w[:, :64])
    fol, acc, first = w[:, :64], w[:, 64:320], w[:, 320]
    rows = rows[rows.any(axis=1)][:90]
    n, length = rows.shape
    width = len(w)
    s = np.zeros((width, n), np.uint64)
    tot_s = tot_e = steps = warp_s = warp_e = warp_steps = 0
    for t in range(length):
        b = rows[:, t]
        on = ((s[..., None] >> POS) & np.uint64(1)) == 1
        reach = np.bitwise_or.reduce(np.where(on, fol[:, None, :], np.uint64(0)), axis=-1)
        ps, pe = _popcount(s), _popcount(s & exc[:, None])
        live = b != 0
        tot_s += int(ps[:, live].sum())
        tot_e += int(pe[:, live].sum())
        steps += int(live.sum()) * width
        for g in range(0, n - 2, 3):
            warp_s += int(ps[:, g : g + 3].max())
            warp_e += int(pe[:, g : g + 3].max())
            warp_steps += 1
        s = (reach | first[:, None]) & acc[np.arange(width)[:, None], b[None, :]]
    return {"kernel": "K5", "rows": n, "length": length, "slots": width,
            "exc_positions": [bin(int(e)).count("1") for e in exc],
            "mean_bits_S": tot_s / steps, "mean_bits_S_and_exc": tot_e / steps,
            "warp_max_bits_S": warp_s / warp_steps,
            "warp_max_bits_S_and_exc": warp_e / warp_steps}


def _reach(s: int, row: list[int]) -> int:
    r = ((s & row[0]) << 1) & ((1 << 64) - 1) | (s & row[1])
    e = s & row[2]
    while e:
        low = e & -e
        r |= row[5 + low.bit_length() - 1]
        e ^= low
    return r


def _segment(row: list[int], ids: list[int]) -> tuple[bool, int]:
    """A segment from the empty state: (matched, state at its end)."""
    s = 0
    for c in ids:
        s = (_reach(s, row) | row[3]) & (row[69 + c] if c < 64 else 0)
        if s & row[4]:
            return True, s
    return False, s


def excess_steps(row: list[int], lane: np.ndarray, segments: int) -> int:
    """Steps the fix-up walks the excess across the lane's boundaries."""
    seg = len(lane) // 16 // segments * 16
    walks = [_segment(row, lane[k * seg : (k + 1) * seg].tolist()) for k in range(segments)]
    if any(m for m, _ in walks):
        return 0
    x, n = walks[0][1], 0
    for k in range(1, segments):
        for c in lane[k * seg : (k + 1) * seg].tolist():
            if not x:
                break
            x = _reach(x, row) & (row[69 + c] if c < 64 else 0)
            n += 1
        x |= walks[k][1]
    return n


def main(n_files: int) -> int:
    import torch

    import bench_corpus
    from trivy_tpu_torch.engine import nfa_device as nd
    from trivy_tpu_torch.engine.hybrid import GpuHybridSecretEngine
    from trivy_tpu_torch.ops import nfa_verify as nv

    torch.set_num_threads(1)
    kept: list = []
    originals = {k: getattr(nd, k) for k in ("nfa_stream", "nfa_padded")}
    for name, fn in originals.items():
        setattr(nd, name, lambda *a, _n=name, _f=fn, **k: (kept.append((_n, a)), _f(*a, **k))[1])
    corpus = bench_corpus.make_hitdense_corpus(n_files, seed=13)
    rng = np.random.default_rng(7)
    alnum = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789",
                          np.uint8)
    for i in range(4):
        sec = b"ghp_" + rng.choice(alnum, 36).tobytes()
        corpus.append((f"extra/nul{i}.bin", b"\x00" * 200 + sec + b"\x00" * 50))
        corpus.append((f"extra/big{i}.txt", rng.choice(alnum, 40000).tobytes() + b"\nt "
                       + sec + b"\n" + rng.choice(alnum, 9000).tobytes()))
    GpuHybridSecretEngine(device="cpu", verify="fused").scan_batch(corpus)
    streams = [a for n, a in kept if n == "nfa_stream"]
    rows, stack = max(streams, key=lambda a: a[0].numel())
    print(json.dumps(stream_stats(nv, rows.numpy(), stack.words.numpy())), flush=True)
    for name, (classes, gids, tables) in ((n, a) for n, a in kept if n == "nfa_padded"):
        if classes.shape[2] != 32768:
            continue
        table = tables.table.numpy().view(np.uint64)
        lanes = classes.numpy().reshape(-1, classes.shape[2])
        rules = np.repeat(gids.numpy(), classes.shape[1])
        real = [i for i in range(len(lanes)) if lanes[i].any()]
        steps = {seg: sum(excess_steps([int(x) for x in table[rules[i]]], lanes[i], seg)
                          for i in real) for seg in (16, 128)}
        print(json.dumps({"kernel": "K6", "shape": list(classes.shape), "lanes_with_data":
                          len(real), "excess_steps_by_segments": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1500))
