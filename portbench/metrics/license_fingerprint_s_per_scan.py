"""Seconds of the license resolve's host fingerprints per scan
(`license/classifier.py` `normalize_tokens` and `_fingerprint` over every
candidate text; the `license.fingerprint` span):
`SieveStats.license_fingerprint_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "license_fingerprint_s")
