"""Seconds of the license similarity product B14 per scan, with its copies
(`license/classifier.py` `_matmul`: the fingerprints' upload, the float32
product on the card, the scores' fetch; the `license.classify` span, the
`kernel.license.classify` device phase inside it):
`SieveStats.license_classify_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "license_classify_s")
