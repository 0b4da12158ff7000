"""Set-up seconds: from the harness's first line to the first timed batch:
imports, the card's start, the tree, the engine and its warm-up batch (host
clock)."""


def read(run):
    return run.setup_s
