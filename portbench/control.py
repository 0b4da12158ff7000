"""The control of `correct`: the plain reference with one of the
configuration's guarantees broken, put in the program's place, at a cell's
own size, through the path that decides `correct` in every run.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the configuration's reference module with `control` set
(`answers(config, items, control=True)`); for `secret-default` the broken
guarantee is `secret_group`: where a rule names a secret group, the control
reports the whole match's span, as a verifier that knows only where a match
ends would.  For each seed it makes one run of the cell (`harness.run`)
with the control's answers in the engine's place, so they go through the
window, the batch records and the comparison with its limits, and prints
that run's result line; the control has to come out not correct on every
seed.  The benchmark's own runs never run it.
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

BENCH = Path(__file__).resolve().parent


class ControlEntry:
    """An entry whose engine is the control: every answer is the
    reference's control answer, canonical already, computed over
    `n_workers` spawned processes that load nothing of the program."""

    def __init__(self, n_workers: int | None = None):
        from portbench import compare

        self.n_workers = n_workers or compare.workers()
        self.config: dict = {}

    def build(self, config: dict, device: str, rules_cache_dir):
        self.config = config
        return self

    def scan(self, engine, items):
        from portbench import compare

        k = max(1, min(self.n_workers, len(items)))
        bounds = [len(items) * j // k for j in range(k + 1)]
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=k, mp_context=ctx) as pool:
            futs = [pool.submit(compare.reference_slice, self.config, items[lo:hi], True)
                    for lo, hi in zip(bounds, bounds[1:])]
            return [a for f in futs for a in f.result()]

    @staticmethod
    def keep(idxs, answers) -> tuple:
        return idxs, len(answers), {j: a for j, a in enumerate(answers) if a}

    @staticmethod
    def answer(one) -> tuple:
        return one


def control_run(workload: str, seed: int, seconds: float, n_workers: int | None = None,
                **run_kwargs) -> dict:
    """One run of `workload` with the control in the program's place; its
    result line."""
    from portbench import harness

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(workload, seed, seconds, False, t0=time.perf_counter(),
                         program=ControlEntry(n_workers), **run_kwargs)
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
