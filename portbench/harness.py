"""The port's benchmark harness: one run of one cell.

A cell (`BENCHMARK.json` `workloads`) names a configuration and a traffic
mix; both are files found by name, `portbench/configs/<config>.json` and
`portbench/traffic/<traffic>.json`, and each metric the cell reports is a
reader found by name, `portbench/metrics/<metric>.py`, with a `read(run)`
that returns the number or None (nothing to read) and, where it needs the
engine's per-batch state, an `on_batch(run, engine)`.  The configuration
names in turn the entry that builds and drives the program
(`portbench/entries/<entry>.py`, `secret` by default) and its plain
reference (`compare.py`); the traffic file names its tree's shape
(`corpus.py`).  A new cell, configuration, traffic mix or metric is new
files and a new manifest entry; this file stays.

One run:

1. set-up (counted in `setup_s` from the process's start): the card check,
   the tree from the traffic file and `--seed`, the engine from the
   configuration (its entry's `build`, warm-up included), and the first
   batch of the tree through the engine, the largest the window sends, so
   the engine's buffers and pools reach their size before the clock starts
   (the engines' kernels are built ahead, and their row buckets differ only
   in size: no batch of the window compiles anything);
2. the window: one client in a closed loop sends the tree again and again,
   pass after pass, in batches cut in tree order at `batch_max_bytes`, each
   after the previous one returned, until `--seconds` have passed and the
   batch in flight has returned.  Pass p starts at file
   `p * pass_offset_stride * n_files` (mod n_files), so no pass repeats an
   earlier pass's batches: the engine's digest-keyed chunk caches see new
   chunks, as a job's next checkout would give them;
3. with `--trace 1`, the window's first pass runs under `torch.profiler`
   with the program's host spans on (`portbench/devtrace.py`), and the
   per-layer readers count from the batches after it;
4. `correct`: every answer of the window against the configuration's plain
   reference (`portbench/compare.py`), once the window has closed, the peak
   memory has been read and the engine freed;
5. the result: the numbers compared, beside their limits, as the last lines
   of standard error; the JSON line as the last line of standard output.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from portbench import compare, loader
from portbench.corpus import make_tree

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "_out"
RULES_CACHE = BENCH / "_cache" / "rules"
FORBIDDEN = ("jax", "jaxlib", "flax", "trivy_tpu")
LIMITS = {"mismatched_files": 0, "missing_files": 0}


def load_cell(workload: str, root: Path = ROOT, bench: Path = BENCH) -> SimpleNamespace:
    """The cell's manifest entry, configuration, traffic and metrics."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    end_to_end = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return SimpleNamespace(
        workload=wl,
        config=json.loads((bench / "configs" / f"{wl['config']}.json").read_text()),
        traffic=json.loads((bench / "traffic" / f"{wl['traffic']}.json").read_text()),
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def reader(name: str, bench: Path = BENCH):
    """The reader module of metric `name`, `portbench/metrics/<name>.py`."""
    return loader.load("metrics", name, bench)


def entry(config: dict, bench: Path = BENCH):
    """The entry module of a configuration, `portbench/entries/<entry>.py`."""
    return loader.load("entries", config.get("entry", "secret"), bench)


def byte_bounded(sizes, max_bytes: int, big_bytes: int) -> list[list[int]]:
    """Positions cut into consecutive groups of at most `max_bytes`, a file
    over `big_bytes` in a group of its own while the open group goes on: the
    cut the runner's analyzer makes before each engine call
    (`analyzer/core.py` `_byte_bounded`)."""
    groups: list[list[int]] = []
    group: list[int] = []
    total = 0
    for pos, size in enumerate(sizes):
        if size > big_bytes:
            groups.append([pos])
            continue
        if group and total + size > max_bytes:
            groups.append(group)
            group, total = [], 0
        group.append(pos)
        total += size
    if group:
        groups.append(group)
    return groups


def pass_batches(sizes: list[int], traffic: dict, p: int) -> list[list[int]]:
    """File indices of each batch of pass `p`."""
    n = len(sizes)
    start = int(p * traffic["pass_offset_stride"] * n) % n
    order = list(range(start, n)) + list(range(start))
    cuts = byte_bounded([sizes[i] for i in order], int(traffic["batch_max_bytes"]),
                        int(traffic["big_file_bytes"]))
    return [[order[pos] for pos in group] for group in cuts]


def card_line() -> str:
    """The card's name, power limit and top SM clock, from nvidia-smi."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not measured ({exc.__class__.__name__})"
    return done.stdout.strip() or f"not measured (exit {done.returncode})"


def _stats(engine) -> dict:
    stats = getattr(engine, "stats", None)
    return dataclasses.asdict(stats) if dataclasses.is_dataclass(stats) else {}


def _launches() -> dict:
    from trivy_tpu_torch.ops.gram_sieve import LAUNCHES

    return dict(LAUNCHES)


def _usage() -> dict:
    """This process's CPU seconds so far, user and system: beside the
    window's wall time they tell a slower core from a process that waits."""
    t = os.times()
    return {"user_s": t.user, "system_s": t.system}


def _log(text: str) -> None:
    print(text, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
        device: str = "cuda", traffic_overrides: dict | None = None, program=None,
        reference_workers: int | None = None) -> int:
    """One run of `workload`; returns the exit code.  `device`, the traffic
    overrides, `program` (an entry in the place of the configuration's) and
    `reference_workers` are for the CPU tests and the control, which drive
    everything but the card."""
    cell = load_cell(workload)
    traffic = {**cell.traffic, **(traffic_overrides or {})}
    if int(traffic.get("clients", 1)) != 1:
        raise SystemExit("the harness drives one closed-loop client; a traffic file "
                         "with more clients needs a harness that sends them")
    import torch

    if device == "cuda":
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        kind = torch.cuda.get_device_name(0)
    else:
        kind = device
    if os.environ.get("TRIVY_TPU_SYNC_TIMING"):
        raise SystemExit("TRIVY_TPU_SYNC_TIMING adds synchronisations: no timed run sets it")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    ent = program or entry(cell.config)
    from trivy_tpu_torch.obs import trace as obs_trace

    t = time.perf_counter()
    tree = make_tree(traffic, seed)
    sizes = [len(c) for _, c in tree]
    tree_s = time.perf_counter() - t

    t = time.perf_counter()
    engine = ent.build(cell.config, device, RULES_CACHE)
    build_s = time.perf_counter() - t

    t = time.perf_counter()
    ent.scan(engine, [tree[i] for i in pass_batches(sizes, traffic, 0)[0]])
    sync()
    warm_s = time.perf_counter() - t

    readers = {m["name"]: reader(m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}
    hooks = [r.on_batch for r in readers.values() if hasattr(r, "on_batch")]
    run_ = SimpleNamespace(
        workload=cell.workload["name"], config=cell.config, traffic=traffic, seed=seed,
        card=kind, n_files=len(tree), build_s=build_s, state={}, devtrace=None,
        gate=getattr(engine, "gate_decision", None))

    batches: list[tuple] = []  # the entry's `keep` record of each batch
    window0 = time.perf_counter()
    run_.setup_s = window0 - t0
    p = 1
    if trace:
        run_.devtrace = _profiled_pass(ent, engine, tree, sizes, traffic, p, batches,
                                       device, obs_trace, torch)
        p += 1
    counted0 = len(batches)
    stats0, launches0 = _stats(engine), _launches()
    batch_s: list[float] = []
    usage0 = _usage()
    done = False
    while not done:
        for idx in pass_batches(sizes, traffic, p):
            t = time.perf_counter()
            res = ent.scan(engine, [tree[i] for i in idx])
            batch_s.append(time.perf_counter() - t)
            batches.append(ent.keep(idx, res))
            del res
            for hook in hooks:
                hook(run_, engine)
            done = time.perf_counter() - window0 >= seconds
            if done:
                break
        p += 1
    sync()
    end = time.perf_counter()
    usage = {k: v - usage0[k] for k, v in _usage().items()}
    run_.window_s = end - window0
    run_.window_files = sum(len(b[0]) for b in batches)
    run_.window_bytes = sum(sizes[i] for b in batches for i in b[0])
    run_.count_files = sum(len(b[0]) for b in batches[counted0:])
    run_.scans = run_.count_files / len(tree)
    run_.stats = {k: v - stats0.get(k, 0) for k, v in _stats(engine).items()
                  if isinstance(v, (int, float))}
    run_.launches = {k: v - launches0[k] for k, v in _launches().items()}
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        _log(f"card: {kind} count={torch.cuda.device_count()} nvidia-smi: {card_line()}")
    _log(f"window: passes={p - 1} batches={len(batches)} files={run_.window_files} "
         f"bytes={run_.window_bytes} seconds={run_.window_s} setup_s={run_.setup_s} "
         f"(tree {tree_s}, engine {build_s}, warm-up batch {warm_s})")
    _log(f"host: counted batches' seconds {[round(x, 4) for x in batch_s]}; over them "
         f"this process's usage {json.dumps(usage)}")
    _log(f"engine: verify gate {json.dumps(run_.gate, default=str)} megakernel="
         f"{getattr(engine, 'megakernel_active', None)}")
    _log(f"engine: launches {json.dumps(run_.launches)} stats {json.dumps(run_.stats)}")
    _log(f"device: memory_peak_bytes={memory_peak} (torch.cuda.max_memory_allocated)")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del engine, hooks
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    expected = compare.reference_answers(cell.config, traffic, seed, tree, reference_workers)
    verdict = compare.compare(expected, batches, ent.answer)
    _log(f"reference: seconds={time.perf_counter() - t} compared={verdict['compared']} "
         f"examples={json.dumps(verdict['examples'])}")
    numbers = {"mismatched_files": verdict["mismatched"], "missing_files": verdict["missing"]}
    correct = verdict["compared"] > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)

    held = compare.loaded(FORBIDDEN)
    if held:
        print(f"portbench: the run loaded {held}", file=sys.stderr)
        return 4

    device_doc = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                  "count": int(cell.workload["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": run_.window_files,
              "failed": verdict["missing"] + verdict["mismatched"], "metrics": metrics,
              "device": device_doc}
    if trace and run_.devtrace is not None:
        device_doc["busy_s"] = run_.devtrace["busy_s"]
        device_doc["window_s"] = run_.devtrace["window_s"]
        result["breakdown"] = {"device_ops": run_.devtrace["device_ops"],
                               "idle_gaps": run_.devtrace["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"compared: {k}={v} limit={LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _profiled_pass(ent, engine, tree, sizes, traffic, p, batches, device, obs_trace, torch):
    """Pass `p` under `torch.profiler`, host spans on: its batches join the
    window's; returns `devtrace.reduce_trace`'s reading (None on the CPU)."""
    if device != "cuda":
        for idx in pass_batches(sizes, traffic, p):
            batches.append(ent.keep(idx, ent.scan(engine, [tree[i] for i in idx])))
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    import trivy_tpu_torch
    from portbench import devtrace

    launches0 = sum(_launches().values())
    hits0 = _stats(engine).get("resident_hits", 0)
    starts: list[float] = []
    obs_trace.clear()
    obs_trace.enable(ring=1 << 20)  # every span of the pass, none pushed out
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev0.record()
            for idx in pass_batches(sizes, traffic, p):
                starts.append(time.perf_counter())
                with record_function(devtrace.ANNOTATION):
                    res = ent.scan(engine, [tree[i] for i in idx])
                batches.append(ent.keep(idx, res))
            ev1.record()
            torch.cuda.synchronize()
    finally:
        obs_trace.disable()
    spans = obs_trace.snapshot()
    obs_trace.clear()
    OUT.mkdir(parents=True, exist_ok=True)
    trace_file = OUT / "trace.json"
    prof.export_chrome_trace(str(trace_file))
    try:
        reading = devtrace.reduce_trace(
            trace_file, starts, spans, sum(_launches().values()) - launches0,
            devtrace.program_kernel_names(Path(trivy_tpu_torch.__file__).parent / "csrc"),
            ev0.elapsed_time(ev1) / 1e3, threading.get_ident())
    finally:
        trace_file.unlink(missing_ok=True)
    reading["files"] = len(tree)
    reading["resident_hits"] = _stats(engine).get("resident_hits", 0) - hits0
    _log(f"devtrace: {json.dumps({k: v for k, v in reading.items() if k not in ('device_ops', 'idle_gaps')})}")
    return reading
