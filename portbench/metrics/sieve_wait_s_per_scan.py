"""Seconds the default engine's scanning thread waits on its host
pre-sieve per scan (`engine/hybrid.py` `_finish` blocked on the sieve's
future, the `sieve.wait` span): `SieveStats.sieve_wait_s`, wall time on the
one thread that calls the engine, where `host_sieve_s_per_scan` sums busy
time over the pool's threads."""

from portbench.metrics._stage import HYBRID, per_scan


def read(run):
    return per_scan(run, "sieve_wait_s", backends=HYBRID)
