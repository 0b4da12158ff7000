"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json`; everything it uses
is found by name under `portbench/` (`portbench/harness.py`).  The last line
of standard output is the run's JSON result.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CACHE = BENCH / "_cache"


def _seed(text: str) -> int:
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError("the seed is a whole number, 0 or more")
    return value


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=_seed, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_environment() -> None:
    """Every build and kernel cache of the program in fixed directories of
    this checkout, so only a checkout's first run builds."""
    os.environ["TRIVY_TPU_AOT_CACHE"] = str(CACHE / "aot")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    cache_environment()
    sys.path.insert(0, str(BENCH.parent))
    from portbench import harness

    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
