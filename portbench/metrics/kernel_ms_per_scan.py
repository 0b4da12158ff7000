"""Milliseconds of kernels per scan: the profiler's summed device time of
every kernel in the profiled pass (one whole scan), checked against the
wrappers' launch counts and a CUDA-event span (`portbench/devtrace.py`)."""


def read(run):
    dt = run.devtrace
    if dt is None or not dt["kernels"]:
        return None
    return 1e3 * dt["kernel_s"] * run.n_files / dt["files"]
