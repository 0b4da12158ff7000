"""The default engine's tracing on the CPU (`trivy_tpu_torch/engine/hybrid.py`,
`engine/nfa_device.py`, `obs/trace.py`, `obs/metrics.py`):

* a traced fused scan opens its spans where the work happens, every one of
  them inside the `hybrid.scan` root, and the counters `SieveStats`
  `sieve_wait_s`, `verify_assemble_s` and `verify_dispatch_s` equal the
  time of their spans, summed over every verify call, and
  `verify_assemble_lanes` the lanes the assembly placed in stream rows;
* `build_times`, the parts of the engine's construction and `warmup()`,
  cover the host clock around them;
* `merge_into_profile` writes the spans into a `torch.profiler` trace on
  that trace's clock, and `profile_clock` recovers a known rate and offset;
* `device_phase` never waits on the device: a CUDA section's event pair
  stays queued until its events have completed.

Tolerance: span nesting and names exact; a counter against its spans 1%
(a construction part: the span inside the counter's clock, by at most the
span's own 1 ms of entry); a span against a profiler event 50 us (the
clock marks' scatter).
"""

import json
import time

import numpy as np
import pytest
import torch

import bench_corpus
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace

# Spans of one fused scan on the calling thread, each under `hybrid.scan`.
SCAN_SPANS = {"hybrid.allow", "pipeline", "sieve.wait", "confirm", "verify.dedupe", "verify",
              "verify.assemble", "verify.dispatch", "verify.fetch", "verify.padded",
              "kernel.verify.fused"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tracing():
    obs_trace.clear()
    obs_trace.enable()
    yield
    obs_trace.disable()
    obs_trace.clear()
    obs_metrics.drain_device_phases()


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """A fused-verify engine on the CPU, built through the registry (so the
    factory's own part runs), with the host clock around its construction
    and warm-up."""
    t0 = time.perf_counter()
    engine = make_secret_engine(backend="hybrid", device="cpu", verify="fused",
                                rules_cache_dir=str(tmp_path_factory.mktemp("rules")))
    engine.warmup()
    return engine, time.perf_counter() - t0


def _items(seed: int) -> list[tuple[str, bytes]]:
    """Hit-dense files and a NUL-bracketed secret (its span takes the padded
    path)."""
    rng = np.random.default_rng(seed)
    token = b"ghp_" + bytes(rng.choice(list(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"), 36))
    return (bench_corpus.make_hitdense_corpus(60, seed=seed)
            + [("nul.bin", b"\x00" * 200 + token + b"\x00" * 50)])


def test_traced_fused_scan_nests_every_span_under_hybrid_scan(fused, tracing):
    engine, _ = fused
    engine.scan_batch(_items(3))
    spans = obs_trace.snapshot()
    [root] = [s for s in spans if s.name == "hybrid.scan"]
    assert root.parent_id == 0 and root.attrs["files"] == 61
    assert root.attrs["backend"] == "fused" and root.attrs["reason"] == "forced"
    by_id = {s.span_id: s for s in spans}

    def ancestors(s):
        while s.parent_id in by_id:
            s = by_id[s.parent_id]
            yield s.name

    mine = [s for s in spans if s is not root]
    assert {s.name for s in mine} == SCAN_SPANS | {"sieve"}
    assert "hybrid.gate" not in {s.name for s in spans}
    for s in mine:
        assert "hybrid.scan" in set(ancestors(s)), s.name
        assert s.trace_id == root.trace_id
        if s.tid == root.tid:  # the scanning thread: inside the root's interval
            assert root.start <= s.start and s.start + s.dur <= root.start + root.dur, s.name
    assert {"verify"} == {by_id[s.parent_id].name for s in mine if s.name == "verify.assemble"}
    [sieve] = {s.tid for s in spans if s.name == "sieve"}
    assert sieve != root.tid  # the pre-sieve runs on the pool, joined to the tree


def test_verify_counters_sum_over_calls_and_match_their_spans(fused, tracing):
    engine, _ = fused
    before = engine.stats.verify_assemble_s, engine.stats.verify_dispatch_s
    calls = []
    for seed in (5, 6):
        engine.scan_batch(_items(seed))
        calls.append(dict(engine._nfa_verifier.stream_stats))
    assemble = engine.stats.verify_assemble_s - before[0]
    dispatch = engine.stats.verify_dispatch_s - before[1]
    assert assemble == pytest.approx(sum(c["assemble_s"] for c in calls), rel=1e-9)
    assert dispatch == pytest.approx(sum(c["dispatch_s"] for c in calls), rel=1e-9)
    spans = obs_trace.snapshot()
    for name, total in (("verify.assemble", assemble), ("verify.dispatch", dispatch)):
        got = sum(s.dur for s in spans if s.name == name)
        assert total > 0 and got == pytest.approx(total, rel=0.01), name
    waits = sum(s.dur for s in spans if s.name == "sieve.wait")
    assert engine.stats.sieve_wait_s >= waits > 0


def test_verify_assemble_lanes_sum_placed_lanes_over_calls(fused):
    engine, _ = fused
    before = engine.stats.verify_assemble_lanes
    calls = []
    for seed in (8, 9):
        engine.scan_batch(_items(seed))
        calls.append(dict(engine._nfa_verifier.stream_stats))
    placed = sum(c["lanes"] - c["overflow_lanes"] for c in calls)
    assert engine.stats.verify_assemble_lanes - before == placed
    assert placed > 0 and all(c["overflow_lanes"] > 0 for c in calls)  # the NUL span's


def test_counters_fill_with_tracing_off(fused):
    engine, _ = fused
    obs_trace.clear()
    before = (engine.stats.sieve_wait_s, engine.stats.verify_assemble_s,
              engine.stats.verify_dispatch_s)
    engine.scan_batch(_items(7))
    after = (engine.stats.sieve_wait_s, engine.stats.verify_assemble_s,
             engine.stats.verify_dispatch_s)
    assert all(b > a for a, b in zip(before, after))
    assert obs_trace.snapshot() == []


def test_build_times_cover_the_construction(fused):
    engine, wall = fused
    times = engine.build_times
    assert set(times) == {"device", "rules", "oracle", "dfa", "nfa", "native", "scan_tables",
                          "warmup"}
    assert all(v >= 0 for v in times.values())
    assert wall >= sum(times.values()) >= 0.9 * wall


def test_build_parts_are_spans_under_engine_build(tracing, tmp_path):
    engine = make_secret_engine(backend="hybrid", device="cpu", verify="fused",
                                rules_cache_dir=str(tmp_path))
    engine.warmup()
    spans = obs_trace.snapshot()
    [root] = [s for s in spans if s.name == "engine.build"]
    parts: dict[str, float] = {}  # `rules` twice: the factory's and the engine's
    for s in spans:
        if s.name.startswith("engine.") and s is not root:
            name = s.name.removeprefix("engine.")
            parts[name] = parts.get(name, 0.0) + s.dur
            if name != "warmup":  # warmup() is its own call, after the factory's
                assert s.trace_id == root.trace_id and s.parent_id == root.span_id, name
    assert set(parts) == set(engine.build_times)
    for name, dur in parts.items():
        # the counter's clock holds the span's: only the span's own entry
        # (a root mints its trace id) lies between them
        assert engine.build_times[name] - 1e-3 <= dur <= engine.build_times[name], name


def _profiled(tmp_path, body):
    """`body()` inside a CPU profiler window with clock marks at both ends;
    returns the exported trace's path and the marks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        marks = [obs_trace.clock_mark()]
        body()
        marks.append(obs_trace.clock_mark())
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return path, marks


def test_merged_profile_trace_holds_the_spans_on_its_clock(tracing, tmp_path):
    from torch.profiler import record_function

    def body():
        for _ in range(3):
            with obs_trace.span("probe"):
                with record_function("probe"):
                    torch.ones(64).sum()
            time.sleep(0.002)

    path, marks = _profiled(tmp_path, body)
    assert obs_trace.merge_into_profile(path, marks) == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "host_span"), key=lambda e: e["ts"])
    probes = sorted((e for e in events if e.get("name") == "probe"
                     and e.get("cat") != "host_span"), key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == ["probe"] * 3 and len(probes) == 3
    for span, ev in zip(spans, probes):
        assert span["ts"] <= ev["ts"] + 50
        assert span["ts"] + span["dur"] >= ev["ts"] + ev["dur"] - 50
        assert ev["ts"] - span["ts"] < 5_000  # one clock, not two
    obs_trace.disable()
    path, marks = _profiled(tmp_path, body)
    assert obs_trace.merge_into_profile(path, marks) is None  # tracing off: untouched


def test_profile_clock_fits_a_known_rate_and_offset():
    scale, offset = 1e6 * (1 + 2e-5), 7.5e11
    marks, events = [], []
    for base in (100.0, 130.0):
        call = []
        for k in range(obs_trace.CLOCK_MARKS):
            a = base + k * 1e-4
            b, c, d = a + 2e-6, a + 4e-6, a + 6e-6
            call.append((a, b, c, d))
            events.append({"name": obs_trace.CLOCK_MARK, "ph": "X",
                           "ts": (a + b) / 2 * scale + offset,
                           "dur": ((c + d) / 2 - (a + b) / 2) * scale})
        marks.append(call)
    got_scale, got_offset = obs_trace.profile_clock(events, marks)
    assert got_scale == pytest.approx(scale, rel=1e-9)
    for t in (90.0, 115.0, 140.0):
        assert t * got_scale + got_offset == pytest.approx(t * scale + offset, abs=0.01)
    with pytest.raises(ValueError, match="clock marks"):
        obs_trace.profile_clock(events[1:], marks)


def test_device_phase_never_synchronises(fused, tracing, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("device_phase synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    engine, _ = fused
    engine.scan_batch(_items(8))
    ph = obs_metrics.device_phase("sieve-step")
    dt = ph.done(torch.ones(4))
    samples = obs_metrics.drain_device_phases()
    assert ("sieve-step", "cpu", dt) in samples
    assert {k for k, _d, _s in samples} >= {"verify.fused"}


class _Event:
    """A stand-in for a CUDA timing event: `query()` says whether the
    device has reached it; `synchronize()` must never be called."""

    def __init__(self, t: float):
        self.t, self.done = t, False

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3

    def synchronize(self):
        raise AssertionError("device_phase synchronised")


class _CudaTensor:
    device = torch.device("cuda", 0)


def test_a_cuda_section_resolves_when_its_events_complete(tracing, monkeypatch):
    made = []

    def event(index):
        made.append(_Event(0.25 * len(made)))
        return made[-1]

    monkeypatch.setattr(obs_metrics, "_cuda_index", lambda: 0)
    monkeypatch.setattr(obs_metrics, "_cuda_event", event)
    obs_metrics.drain_device_phases()
    ph = obs_metrics.device_phase("verify.fused")
    ph.done([_CudaTensor()])
    assert len(made) == 2
    assert [s.name for s in obs_trace.snapshot()] == ["kernel.verify.fused"]
    assert obs_metrics.drain_device_phases() == []  # still on the device
    made[0].done = made[1].done = True
    assert obs_metrics.drain_device_phases() == [("verify.fused", "cuda:0", 0.25)]
    assert obs_metrics.drain_device_phases() == []
    # a section over another card's tensors falls back to the host clock
    monkeypatch.setattr(obs_metrics, "_cuda_index", lambda: 1)
    dt = obs_metrics.device_phase("verify.fused").done(_CudaTensor())
    assert obs_metrics.drain_device_phases() == [("verify.fused", "cuda:0", dt)]


def test_pending_pairs_keep_to_the_cap(tracing, monkeypatch):
    monkeypatch.setattr(obs_metrics, "_cuda_index", lambda: 0)
    monkeypatch.setattr(obs_metrics, "_cuda_event", lambda index: _Event(0.0))
    obs_metrics.drain_device_phases()
    cap = obs_metrics._DEVICE_PHASE_MAX_PENDING
    for _ in range(cap + 10):
        obs_metrics.device_phase("compact").done(_CudaTensor())
    assert len(obs_metrics._DEVICE_PHASE_PENDING) == cap
    for _k, _d, (start, end) in obs_metrics._DEVICE_PHASE_PENDING:
        start.done = end.done = True
    assert len(obs_metrics.drain_device_phases()) == cap
    assert obs_metrics._DEVICE_PHASE_PENDING == []
