"""Seconds of the multi-program pass's claim-killer per scan (`engine/redfa.py`
over the candidate pairs of the programs that opt in, the secret program's
columns; the `programs.verify` span): `SieveStats.program_verify_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "program_verify_s")
