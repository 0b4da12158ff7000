"""Shared arithmetic of the stage readers: a `SieveStats` counter's change
over the counted batches, per scan of the whole tree."""

HYBRID = ("auto", "hybrid")


def per_scan(run, *counters: str, backends=None):
    """The counters' summed change per scan; None when the engine has none
    of them or is not one of `backends`."""
    if backends is not None and run.config["engine"]["backend"] not in backends:
        return None
    if run.scans <= 0 or not any(c in run.stats for c in counters):
        return None
    return sum(run.stats.get(c, 0.0) for c in counters) / run.scans
