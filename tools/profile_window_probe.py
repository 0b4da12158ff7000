#!/usr/bin/env python3
"""Probe the scan server's `/admin/profile` window over a process's life:
which kernels of a device-backend server (`make_secret_engine(backend=
"device")`, K3 once a batch) the window's exported Chrome trace keeps, two
windows in a row, after other profiler sessions, and as the process ages.

    python3 tools/profile_window_probe.py
        [lifetime [AGES] | threads [N] | sessions [N]]

run from the repository root on a CUDA card.  Each window is opened and
closed over HTTP on handler threads, as an operator does, while the
scheduler's owner thread launches the kernels: start, a pad, one
ScanSecrets request of 8 files, the pad again, stop.  A narrow window
has no pad, a wide one 2 s.

`lifetime` (the default): at start a narrow, a second narrow and a wide
window; then five CUDA-only sessions on the main thread (as
`chip_smoke.py`'s `device_ms` opens them) and a narrow and a wide window;
then a narrow and a wide window at each process age of AGES (a comma
list of seconds, default 60,180,300).

`threads`: N rounds (default 12), 3 s apart, each of two narrow windows:
one over HTTP (start and stop each on a new handler thread), one whose
start and stop the main thread calls on the server object directly (one
thread for every start and stop, the thread that imported torch); the
five CUDA-only sessions run after the first round.

`sessions`: a narrow window, then N CUDA-only sessions on the main thread
(default 40, as many as a long process such as `chip_smoke.py` opens),
then six narrow windows.

One JSON line a window: its label, the
process age at its start (s), the K3 launches its request made (the
wrapper's count) and the engine's resident row-store hits (a chunk whose
coded rows were sieved before is served from the store, launching
nothing), the kernel events in its trace, those of K3
(`mega_count_kernel`), and the offset of CUPTI's clock against the
host's (`chip_smoke.py` `trace_stats`; kineto drops a CUDA record whose
CUPTI time falls outside the window's host bounds).  Each request is the same 8
files with a comment `// N` appended, N the request's serial: under the
engine's byte classes some N code alike, so some requests hit the store.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.monotonic()
N_FILES = 8  # a request of bench.py `bench_serve`'s mix


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_window_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import bench_corpus
    from chip_smoke import trace_stats
    from trivy_tpu_torch.cache.store import MemoryCache
    from trivy_tpu_torch.engine.hybrid import make_secret_engine
    from trivy_tpu_torch.ops import gram_sieve
    from trivy_tpu_torch.rpc.client import RpcClient
    from trivy_tpu_torch.rpc.server import start_background

    mode = argv[0] if argv else "lifetime"
    if mode not in ("lifetime", "threads", "sessions"):
        print(f"profile_window_probe: unknown sequence {mode!r}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card}), flush=True)
    files = bench_corpus.make_kernel_corpus(n_files=N_FILES, seed=8)
    httpd, _ = start_background(
        "localhost:0", MemoryCache(), device="cuda",
        profile_dir=tempfile.mkdtemp(prefix="profile-probe-"),
        secret_engine_factory=lambda: make_secret_engine(backend="device", device="cuda"))
    addr = f"{httpd.server_address[0]}:{httpd.server_address[1]}"
    client = RpcClient(addr)
    serial = [0]

    def request():
        serial[0] += 1
        n = serial[0]
        client.scan_secrets([(f"w{n}/{p}", c + f"\n// {n}\n".encode()) for p, c in files])

    def window(label: str, pad_s: float, http: bool = True) -> None:
        age = time.monotonic() - T0
        engine = httpd.scan_server.scheduler.manager.active
        launches, hits = gram_sieve.LAUNCHES["mega"], engine.stats.resident_hits
        if http:
            client.call("/admin/profile/start", {})
        else:
            httpd.scan_server.profile_start({})
        time.sleep(pad_s)
        request()
        time.sleep(pad_s)
        if http:
            out = client.call("/admin/profile/stop", {})
        else:
            out = httpd.scan_server.profile_stop({})
        rec = {"label": label, "age_s": round(age, 3), "pad_s": pad_s,
               "k3_launches": gram_sieve.LAUNCHES["mega"] - launches,
               "resident_hits": engine.stats.resident_hits - hits,
               **trace_stats(out["DeviceTrace"])}
        print(json.dumps(rec), flush=True)

    def cuda_only_sessions(n: int = 5) -> None:
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(n):
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(50):
                    x.add_(1)
                torch.cuda.synchronize()
            prof.key_averages()

    try:
        request()  # the engine is built and its kernels loaded
        if mode == "lifetime":
            ages = [float(a) for a in (argv[1] if len(argv) > 1 else "60,180,300").split(",")]
            window("first narrow", 0.0)
            window("second narrow", 0.0)
            window("first wide", 2.0)
            cuda_only_sessions()
            window("narrow after CUDA-only sessions", 0.0)
            window("wide after CUDA-only sessions", 2.0)
            for age in ages:
                time.sleep(max(0.0, age - (time.monotonic() - T0)))
                window(f"narrow at age {age:g}", 0.0)
                window(f"wide at age {age:g}", 2.0)
        elif mode == "sessions":
            n = int(argv[1]) if len(argv) > 1 else 40
            window("narrow before the sessions", 0.0)
            cuda_only_sessions(n)
            for i in range(6):
                window(f"narrow {i} after {n} CUDA-only sessions", 0.0)
        else:
            for r in range(int(argv[1]) if len(argv) > 1 else 12):
                if r == 1:
                    cuda_only_sessions()
                for http in (True, False):
                    window(f"round {r} {'handler threads' if http else 'main thread'}",
                           0.0, http=http)
                    time.sleep(3.0)
    finally:
        httpd.scan_server.scheduler.close()
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
