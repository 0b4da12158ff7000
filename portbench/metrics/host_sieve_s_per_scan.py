"""Seconds of the default engine's host pre-sieve (`native/gram_scan.cpp`
through `engine/hybrid.py` `_sieve_chunk`) per scan: `SieveStats.sieve_s`,
summed over the pool's threads, so busy time rather than wall time."""

from portbench.metrics._stage import HYBRID, per_scan


def read(run):
    return per_scan(run, "sieve_s", backends=HYBRID)
