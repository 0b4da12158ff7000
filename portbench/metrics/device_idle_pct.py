"""Share of the profiled pass's wall time in which no device operation
(kernel, copy or fill) ran, from the `torch.profiler` trace."""


def read(run):
    dt = run.devtrace
    if dt is None:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
