"""Seconds of the default engine's link probe and verify gate in its
construction (`engine/hybrid.py` `_resolve_verify` and `probe_link`, the
`engine.link_probe` span): `build_times["link_probe"]` of the engine, read
after the first counted batch.  The probe's copies may be the process's
first work on the card."""

from portbench.metrics._stage import HYBRID


def on_batch(run, engine):
    times = getattr(engine, "build_times", None)
    if times is not None:
        run.state.setdefault("build_times", dict(times))


def read(run):
    if run.config["engine"]["backend"] not in HYBRID:
        return None
    return run.state.get("build_times", {}).get("link_probe")
