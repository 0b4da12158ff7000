"""Seconds of the verify stage per scan: `SieveStats.verify_s` (the host DFA
and, on the default engine, the device NFA verify with its dedupe)."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "verify_s")
