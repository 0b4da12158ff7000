"""Seconds the default engine's device verify spends assembling its lanes
(`GpuNfaVerifier.stream_stats["assemble_s"]`, a new record each verify
call) per scan; 0 when the gate put the verify on the host, where no lane
is assembled."""

from portbench.metrics._stage import HYBRID


def on_batch(run, engine):
    verifier = getattr(engine, "_nfa_verifier", None)
    st = getattr(verifier, "stream_stats", None) or {}
    if st and st is not run.state.get("assemble_last"):
        run.state["assemble_last"] = st
        run.state["assemble_s"] = run.state.get("assemble_s", 0.0) + st.get("assemble_s", 0.0)


def read(run):
    if run.config["engine"]["backend"] not in HYBRID or run.scans <= 0:
        return None
    return run.state.get("assemble_s", 0.0) / run.scans
