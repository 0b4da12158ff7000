"""B14's share of its roofline: the least time an H100 takes for the
similarity product's bytes and operations a scan (`_b14.bound_s`, from the
rows and calls the counters `SieveStats.license_classify_rows` and
`license_classify_calls` give a scan) over its kernels' device time in the
profiled pass (one whole scan), copies excluded.

On the program pass every kernel is B14's: the sieve, the claim-killer, the
confirm and the fingerprints run on the host, so the pass's kernel time
(`devtrace.py` `kernel_s`) is the product's; a pass that ran a kernel of the
program's own sources reads None."""

from portbench.metrics import _b14


def read(run):
    dt = run.devtrace
    rows = run.stats.get("license_classify_rows")
    calls = run.stats.get("license_classify_calls")
    if dt is None or not rows or not calls or not dt["kernels"] or dt["program_kernels"]:
        return None
    kernel_s = dt["kernel_s"] * run.n_files / dt["files"]
    bound = _b14.bound_s(rows / run.scans, calls / run.scans, _b14.corpus_size())
    return 100.0 * bound / kernel_s
