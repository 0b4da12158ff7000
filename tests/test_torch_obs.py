"""The port's observability seams on the CPU: the memwatch ledger
(`trivy_tpu_torch/obs/memwatch.py`), the spans of a traced scan
(`obs/trace.py`) against the JAX package's engine, and `device_phase`
(`obs/metrics.py`) on a CPU tensor.

Tolerance: exact (byte counts, span names and their order).
"""

import gc

import numpy as np
import pytest
import torch

from test_torch_engine import TILE, fingerprint, hostile_corpus
from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu.obs import trace as ref_trace
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.ftypes import VERIFY_CORPUS
from trivy_tpu_torch.obs import memwatch
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace

# The engine's stage spans (device phases and the pipeline span aside).
STAGES = {"chunk.encode", "chunk.h2d", "chunk.exec", "sieve.megakernel",
          "chunk.fetch", "verify", "confirm"}


@pytest.fixture
def ledger():
    was = memwatch.enabled()
    memwatch.reset()
    memwatch.enable()
    yield
    memwatch.reset()
    if not was:
        memwatch.disable()


def test_track_resize_release_conserves_bytes(ledger):
    a = memwatch.track("pool", 100, device="cuda:0")
    b = memwatch.track("cache", 50, device="cuda:0")
    c = memwatch.track("pool", 25, device="cuda:1")
    assert memwatch.total_bytes() == 175 and memwatch.allocation_count() == 3
    a.resize(200)
    assert memwatch.total_bytes() == 275
    b.release()
    b.release()  # idempotent
    b.resize(999)  # released handles ignore resizes
    assert memwatch.total_bytes() == 225
    snap = memwatch.snapshot()
    assert snap["devices"]["cuda:0"]["attributed"] == {"pool": 200}
    assert snap["devices"]["cuda:1"]["attributed"] == {"pool": 25}
    assert snap["devices"]["cuda:0"]["attributed_peak_bytes"] == 250
    a.release()
    c.release()
    assert memwatch.total_bytes() == 0 and memwatch.allocation_count() == 0


def test_owner_collection_and_disabled_tracking(ledger):
    class Owner:
        pass

    owner = Owner()
    memwatch.track("cache", 123, owner=owner)
    assert memwatch.total_bytes() == 123
    del owner
    gc.collect()
    assert memwatch.total_bytes() == 0
    memwatch.disable()
    assert memwatch.track("pool", 100) is memwatch.NOOP_HANDLE
    assert memwatch.total_bytes() == 0


def test_cpu_has_no_raw_stats_but_the_ledger_answers(ledger):
    """Without a card the CUDA sampler reports nothing, and the ledger
    keeps working from registrations (the reference's CPU contract)."""
    assert memwatch.cuda_stats() == {} == memwatch.raw_stats()
    memwatch.track("pool", 500)
    p = memwatch.pressure()
    assert p["source"] == "none" and p["fraction"] == 0.0
    snap = memwatch.snapshot()
    assert snap["attributed_total_bytes"] == 500
    dev = snap["devices"][memwatch._device_name()]
    assert dev["raw"] is None and dev["residual_bytes"] is None
    memwatch.set_stats_provider(lambda: {"cuda:0": {
        "bytes_in_use": 1000, "peak_bytes_in_use": 1500, "bytes_limit": 4000}})
    assert memwatch.pressure()["fraction"] == 0.25
    memwatch.set_stats_provider(None)
    assert memwatch.raw_stats() == {}


@pytest.fixture
def traced():
    obs_trace.clear()
    ref_trace.clear()
    obs_trace.enable()
    ref_trace.enable()
    yield
    obs_trace.disable()
    ref_trace.disable()
    obs_trace.clear()
    ref_trace.clear()
    obs_metrics.drain_device_phases()


def _stages(spans) -> list[str]:
    return [s.name for s in spans if s.name in STAGES]


@pytest.mark.parametrize("mega", [False, True], ids=["staged", "megakernel"])
def test_traced_scan_spans_follow_the_reference(mega, traced, monkeypatch):
    """One traced scan (codec off, where the reference megakernel runs on
    the CPU) opens the reference's stage spans in the reference's order;
    the port's staged path adds a `chunk.fetch` around its candidate fetch
    (the reference fetches there without a span)."""
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", "off")
    items = list(VERIFY_CORPUS) + hostile_corpus(5, TILE)
    port = GpuSecretEngine(device="cpu", tile_len=TILE, max_batch_tiles=64,
                           megakernel=mega)
    ref = TpuSecretEngine(kernel="pallas", fused=True, megakernel=mega,
                          tile_len=TILE, max_batch_tiles=64)
    port._host_verifier()
    ref._host_verifier()
    assert fingerprint(port.scan_batch(items)) == fingerprint(ref.scan_batch(items))
    got, want = _stages(obs_trace.snapshot()), _stages(ref_trace.snapshot())
    if mega:
        assert got == want == ["chunk.h2d", "sieve.megakernel", "chunk.fetch",
                               "verify", "confirm"]
    else:
        assert got == want[:2] + ["chunk.fetch"] + want[2:]
        assert want == ["chunk.h2d", "chunk.exec", "verify", "confirm"]
    names = {s.name for s in obs_trace.snapshot()}
    kernels = {"kernel.sieve.megakernel"} if mega else {
        "kernel.sieve-step", "kernel.lane.derive", "kernel.compact"}
    assert kernels <= names
    phases = {k for k, _dev, _s in obs_metrics.drain_device_phases()}
    assert {k.removeprefix("kernel.") for k in kernels} <= phases


def test_traced_multichunk_scan_spans_per_chunk(traced, monkeypatch):
    """A batch of several chunks opens one encode/h2d/exec triple per chunk
    inside one `pipeline` span, then the fetch, verify and confirm once."""
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", "auto")
    items = hostile_corpus(7, TILE) * 3
    items = [(f"{i}/{p}", c + bytes([65 + i % 26])) for i, (p, c) in enumerate(items)]
    port = GpuSecretEngine(device="cpu", tile_len=TILE, max_batch_tiles=64)
    port.scan_batch(items)
    n = port.stats.device_dispatches
    assert n >= 2
    spans = obs_trace.snapshot()
    assert _stages(spans) == (["chunk.encode", "chunk.h2d", "chunk.exec"] * n
                              + ["chunk.fetch", "verify", "confirm"])
    [pipe] = [s for s in spans if s.name == "pipeline"]
    assert pipe.attrs["chunks"] == n and pipe.attrs["depth"] == port.pipeline_depth
    per_chunk = [s.attrs.get("chunk") for s in spans if s.name == "chunk.exec"]
    assert per_chunk == list(range(n))


def test_device_phase_on_a_cpu_tensor(traced):
    obs_metrics.drain_device_phases()
    ph = obs_metrics.device_phase("sieve-step")
    out = torch.from_numpy(np.arange(16, dtype=np.int32)) * 2
    dt = ph.done(out)
    assert dt >= 0.0
    assert obs_metrics.drain_device_phases() == [("sieve-step", "cpu", dt)]
    assert [s.name for s in obs_trace.snapshot()] == ["kernel.sieve-step"]
    obs_trace.disable()
    assert obs_metrics.device_phase("sieve-step").done(out) == 0.0  # no-op
