"""Seconds the default engine's device verify spends dispatching per scan
(`engine/nfa_device.py` `_flush_range`, the `verify.dispatch` spans: the
lane tables, the uploads, the launches and the fetches that the dispatch
depth forces): `SieveStats.verify_dispatch_s`, summed over every verify
call; 0 when the gate put the verify on the host."""

from portbench.metrics._stage import HYBRID, per_scan


def read(run):
    return per_scan(run, "verify_dispatch_s", backends=HYBRID)
