"""License candidate files per scan: the files the merged sieve marked on any
of the license program's anchor rules, which its resolve classifies
(`programs/license.py`; `SieveStats.license_candidate_files`)."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "license_candidate_files")
