"""The control of `correct`: the plain reference with one of the
configuration's guarantees broken, put in the program's place, at a cell's
own size, through the path that decides `correct` in every run.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The broken guarantee is `secret_group`: where a rule names a secret group,
the control reports the whole match's span, as a verifier that knows only
where a match ends would.  For each seed it makes one run of the cell
(`harness.run`) with the engine's answers replaced by the control's, so the
control's answers go through the window, `compare.keep`, the comparison's
order and text checks and the limits, and prints that run's result line;
the control has to come out not correct on every seed.  The benchmark's
own runs never run it.
"""

import argparse
import contextlib
import io
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent


def _control_findings(items) -> list[list[tuple]]:
    from portbench.reference.secret_scan import SecretScanner

    scanner = SecretScanner(secret_group_spans=False)
    return [scanner.findings(path, content) for path, content in items]


def _secret(path: str, rows: list[tuple]) -> SimpleNamespace:
    """The control's findings of one file in the shape of the program's
    `Secret`, in Go's order (RuleID, then the raw match line)."""
    findings = []
    for rule_id, category, severity, title, start, end, match, code in sorted(
            rows, key=lambda f: (f[0], f[6], f)):
        lines = [SimpleNamespace(number=n, content=c, highlighted=h, is_cause=a,
                                 first_cause=b, last_cause=z) for n, c, h, a, b, z in code]
        findings.append(SimpleNamespace(
            rule_id=rule_id, category=category, severity=severity, title=title,
            start_line=start, end_line=end, match_bytes=match,
            match=match.decode("utf-8", errors="replace"),
            code=SimpleNamespace(lines=lines)))
    return SimpleNamespace(file_path=path, findings=findings)


class ControlEngine:
    """An engine whose every answer is the control's, computed over
    `n_workers` spawned processes that load nothing of the program."""

    def __init__(self, n_workers: int | None = None):
        from portbench import compare

        self.n_workers = n_workers or compare.workers()

    def scan_batch(self, items):
        k = max(1, min(self.n_workers, len(items)))
        bounds = [len(items) * j // k for j in range(k + 1)]
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=k, mp_context=ctx) as pool:
            parts = list(pool.map(_control_findings,
                                  [items[lo:hi] for lo, hi in zip(bounds, bounds[1:])]))
        rows = [r for part in parts for r in part]
        return [_secret(path, r) for (path, _), r in zip(items, rows)]


def control_run(workload: str, seed: int, seconds: float, n_workers: int | None = None,
                **run_kwargs) -> dict:
    """One run of `workload` with the control in the program's place; its
    result line."""
    from portbench import harness

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(workload, seed, seconds, False, t0=time.perf_counter(),
                         wrap_engine=lambda engine: ControlEngine(n_workers), **run_kwargs)
    if rc != 0:
        raise RuntimeError(f"the control's run exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH.parent))
    from portbench.run import cache_environment

    cache_environment()
    failed_all = True
    for seed in args.seeds:
        result = control_run(args.workload, seed, args.seconds)
        failed_all &= not result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "compared": result["compared"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
