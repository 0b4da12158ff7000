"""Seconds of `make_secret_engine(...)` and `warmup()` (host clock)."""


def read(run):
    return run.build_s
