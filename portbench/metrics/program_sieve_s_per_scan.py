"""Seconds of the multi-program pass's merged sieve per scan (`engine/device.py`
`scan_programs`: the dedupe, the pack and the native row sieve
`native/gram_scan.cpp` over the merged secret and license rule axis, and the
candidate derive; the `programs.sieve` span): `SieveStats.program_sieve_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "program_sieve_s")
