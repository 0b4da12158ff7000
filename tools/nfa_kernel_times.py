#!/usr/bin/env python3
"""Time one tree's device NFA verify kernels (K5, its fused mode, K6) on the
inputs that `chip_smoke.py --keep-inputs PATH` kept: the shapes its phase
`nfa` timed and every dispatch of the default hit-dense scan.

    PYTHONPATH=<tree> python3 tools/nfa_kernel_times.py PATH LABEL

`trivy_tpu_torch` comes from <tree> (this checkout, or an earlier commit
unpacked with `git archive`), which builds its own kernels.  A tree whose
wrappers take the host-built tables (`NfaStack`, `NfaTables`, `LaneIndex`)
gets them built once, outside the timing.  A fused input (rows, stack words,
lane table) is timed two ways: "fused", the tree's fused verify (one
`nfa_stream_verdict` launch where the tree has it, else `nfa_stream` then
the separate verdict kernel `nfa_fused_verdict`), and "stream_only", the
flag-writing `nfa_stream` on the same rows.  Its host side is timed too,
on the host's clock through a synchronize (median of 20): "host_prep", what
the tree's engine does to put the lane table on the card (`LaneIndex.build`
where the tree has it, else the table's upload), and "prep_and_fused", that
and the fused verify together, so a tree that moves work from the card to
the host shows it.  One JSON line per input and
way: the kernel, its shape, the CUDA-event median of 20 calls (host launch
work included), the profiler's device time per call (the tree's kernels
and memsets) and a digest of the output (after a second of matrix products,
so the card's clock is up), so two trees can be compared on one card in
one call (run them in turns: old, new, new, old) and their outputs checked
equal; then one line of per-kernel sums over the scan's dispatches.  Needs
a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import sys
import time

import torch

REPS = 20
NAMES = ("nfa_stream_kernel", "nfa_stream_fix_kernel", "nfa_fused_verdict_kernel",
         "nfa_padded_kernel", "nfa_padded_fix_kernel", "Memset")


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, names=NAMES):
    """Device time per call of the kernels named `names` that `fn` launches,
    from the profiler; None when it sees none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                if any(k in e.key for k in names))
    return total / REPS / 1e3 if total else None


def warm_up() -> None:
    """An idle card runs at a low clock: keep it busy for a second."""
    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        x = (x @ x).clamp_(-1.0, 1.0)
    torch.cuda.synchronize()


def main(path: str, label: str) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from trivy_tpu_torch.ops import nfa_verify as nv

    kept = torch.load(path)
    warm_up()
    sums: dict[str, float] = {}
    host_sums: dict[str, float] = {}
    for key, value in kept.items():
        if key.startswith("sieve_"):  # B5's and B6's: tools/sieve_kernel_times.py
            continue
        if key.startswith("dispatch_"):
            name, args = value
        elif key.startswith("nfa_padded"):
            name, args = "nfa_padded", value
        elif key == "nfa_fused":
            name, args = "nfa_stream_verdict", value
        else:
            name, args = key, value
        args = [a.cuda() for a in args]
        if name in ("nfa_stream", "nfa_stream_verdict") and hasattr(nv, "NfaStack"):
            args[1] = nv.NfaStack.from_words(args[1])
        if name == "nfa_padded" and hasattr(nv, "NfaTables"):
            args[2] = nv.NfaTables.from_words(args[2])
        ways = [(name, getattr(nv, name, None))]
        host = []
        if name == "nfa_stream_verdict":
            rows, stack, table = args
            table_np = table.cpu().numpy()
            if hasattr(nv, "nfa_stream_verdict"):
                width = stack.width if hasattr(stack, "width") else stack.shape[0]

                def prep(rows=rows, width=width, table_np=table_np):
                    return nv.LaneIndex.build(table_np, rows.shape[0], rows.shape[1] // 32,
                                              width, rows.device)

                def dispatch(rows=rows, stack=stack, prep=prep):
                    return nv.nfa_stream_verdict(rows, stack, prep())
                args = [rows, stack, prep()]
                fused = nv.nfa_stream_verdict
            else:
                lanes = list(table)

                def fused(r, s, _lanes, lanes=lanes):
                    return nv.nfa_fused_verdict(nv.nfa_stream(r, s), *lanes)

                def prep(rows=rows, table_np=table_np):
                    return torch.from_numpy(table_np).to(rows.device)

                def dispatch(rows=rows, stack=stack, prep=prep):
                    return nv.nfa_fused_verdict(nv.nfa_stream(rows, stack), *prep())
            ways = [("fused", fused), ("stream_only", lambda r, s, _l: nv.nfa_stream(r, s))]
            host = [("host_prep", prep), ("prep_and_fused", dispatch)]
        for way, fn in host:
            ms = host_ms(fn)
            if key.startswith("dispatch_"):
                host_sums[way] = host_sums.get(way, 0.0) + ms
            print(json.dumps({"tree": label, "input": key, "kernel": way,
                              "shape": list(args[0].shape), "host_ms": round(ms, 5)}),
                  flush=True)
        for way, fn in ways:
            out = fn(*args)
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            ms, dev = event_ms(lambda: fn(*args)), device_ms(lambda: fn(*args))
            if key.startswith("dispatch_") and dev is not None:
                sums[way] = sums.get(way, 0.0) + dev
            print(json.dumps({"tree": label, "input": key, "kernel": way,
                              "shape": list(args[0].shape), "ms": round(ms, 5),
                              "device_ms": None if dev is None else round(dev, 5),
                              "out": digest}), flush=True)
    print(json.dumps({"tree": label, "dispatch_device_ms_sums":
                      {k: round(v, 5) for k, v in sums.items()},
                      "dispatch_host_ms_sums": {k: round(v, 5) for k, v in host_sums.items()},
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
