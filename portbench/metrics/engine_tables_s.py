"""Seconds the default engine's construction spends on its verify and scan
tables (`engine/hybrid.py`: the device verifier `GpuNfaVerifier`, the host
claim-killer's `compute_prefix_bounds` and `DfaVerifier`, and the host
pre-sieve's `normalize_grams`, base candidates and `_build_scan_tables`;
the `engine.nfa`, `engine.dfa` and `engine.scan_tables` spans): the sum of
those parts of the engine's `build_times`, read after the first counted
batch."""

from portbench.metrics._stage import HYBRID

PARTS = ("nfa", "dfa", "scan_tables")


def on_batch(run, engine):
    times = getattr(engine, "build_times", None)
    if times is not None:
        run.state.setdefault("build_times", dict(times))


def read(run):
    if run.config["engine"]["backend"] not in HYBRID:
        return None
    times = run.state.get("build_times", {})
    if not any(p in times for p in PARTS):
        return None
    return sum(times.get(p, 0.0) for p in PARTS)
