"""Seconds of the exact confirm (`engine/oracle.py` over each candidate
file's candidate rules) per scan: `SieveStats.confirm_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "confirm_s")
