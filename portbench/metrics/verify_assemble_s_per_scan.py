"""Seconds the default engine's device verify spends assembling its lanes
(`engine/nfa_device.py` `assemble_spans`, the `verify.assemble` spans) per
scan: `SieveStats.verify_assemble_s`, summed over every verify call; 0 when
the gate put the verify on the host, where no lane is assembled."""

from portbench.metrics._stage import HYBRID, per_scan


def read(run):
    return per_scan(run, "verify_assemble_s", backends=HYBRID)
