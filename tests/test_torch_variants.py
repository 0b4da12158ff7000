"""`GpuSecretEngine(device="cpu")` with each of the reference engine's other
sieve choices, end to end, against `trivy_tpu`'s `TpuSecretEngine` built
with the same arguments (on XLA:CPU; Pallas in interpret mode) and against
the oracle:

* `kernel="xla"` (B5, words in gram order) and `kernel="pallas"` (K1, words
  over distinct pairs), each with `fused=False` (hit words fetched, the
  host derive) and `fused=True` (the device derive), in link codec modes
  off / auto / 4 / 6, and the megakernel in mode off (ROADMAP C1);
* `sieve="lut"` (B6 over `pack`ed tiles) and `sieve="native"` (the C++
  host row sieve), whose candidates the host derives;
* the multi-chunk host path (ChunkPipeline, and serial under
  `TRIVY_TPU_SYNC_TIMING=1`, which fills `h2d_s` and `exec_s`), with equal
  link accounting; `ruleset_digest`.

The corpus: `VERIFY_CORPUS`, the hostile shapes of tests/test_megakernel.py
(`hostile_corpus`) and the golden inputs of tests/parity/fixtures.
Tolerance: exact (findings fingerprints and byte counts).
"""

import os

import pytest

from test_torch_engine import TILE, fingerprint, hostile_corpus, oracle_fingerprint
from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.ftypes import VERIFY_CORPUS

PAR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parity", "fixtures")
LINK_STATS = ("bytes_on_link_raw", "bytes_on_link_coded", "d2h_bytes_raw", "d2h_bytes",
              "device_dispatches")


def _goldens() -> list[tuple[str, bytes]]:
    out = []
    for name in sorted(os.listdir(PAR))[:12]:
        with open(os.path.join(PAR, name), "rb") as f:
            out.append((f"testdata/{name}", f.read().replace(b"\r", b"")))
    return out


@pytest.fixture(scope="module")
def corpus():
    items = list(VERIFY_CORPUS) + hostile_corpus(42, TILE) + _goldens()
    return items, oracle_fingerprint(items)


def _pair(monkeypatch, mode: str, **kw):
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
    ref = TpuSecretEngine(tile_len=TILE, **kw)
    port = GpuSecretEngine(device="cpu", tile_len=TILE, **kw)
    return ref, port


def _stats(engine) -> dict:
    return {k: getattr(engine.stats, k) for k in LINK_STATS}


@pytest.mark.parametrize("mode", ["off", "auto", "4", "6"])
@pytest.mark.parametrize("kernel,fused", [("xla", False), ("xla", True), ("pallas", False),
                                          ("pallas", True)])
def test_gram_sieve_variants_equal_reference(corpus, monkeypatch, mode, kernel, fused):
    items, want = corpus
    ref, port = _pair(monkeypatch, mode, kernel=kernel, fused=fused, megakernel=False)
    assert (port.sieve, port.kernel, port._fused) == ("gram", kernel, fused)
    assert (port._link is None) == (mode == "off")
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items))
    assert got == want and b"github-pat" in got
    assert _stats(port) == _stats(ref)
    assert port.stats.candidate_pairs == ref.stats.candidate_pairs


def test_megakernel_in_codec_off_equals_reference(corpus, monkeypatch):
    items, want = corpus
    ref, port = _pair(monkeypatch, "off", kernel="pallas", fused=True, megakernel=True,
                      max_batch_tiles=64)
    assert port.megakernel_active
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items)) == want
    for eng in (GpuSecretEngine(device="cpu", tile_len=TILE, kernel="xla", megakernel=True),
                GpuSecretEngine(device="cpu", tile_len=TILE, fused=False, megakernel=True)):
        assert not eng.megakernel_active  # only the fused K1-twin sieve has one


@pytest.mark.parametrize("sieve", ["lut", "native"])
def test_host_derived_sieves_equal_reference(corpus, monkeypatch, sieve):
    items, want = corpus
    ref, port = _pair(monkeypatch, "auto", sieve=sieve)
    assert port.sieve == sieve and port._link is None and not port._fused
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items)) == want
    assert _stats(port) == _stats(ref)
    if sieve == "lut":
        assert port.overlap == ref.overlap == 16 and port.stats.d2h_bytes > 0
    else:
        assert port.stats.bytes_on_link_raw == 0 and port.stats.device_dispatches == 0


@pytest.mark.parametrize("kw", [dict(kernel="xla", fused=False), dict(sieve="lut")])
def test_host_chunk_pipeline_equals_reference(monkeypatch, kw):
    """More rows than the top bucket (64 here): the hit words of several
    chunks come back through the chunk pipeline, and a rescan hits the
    host cache for every chunk."""
    items = hostile_corpus(7, TILE) * 4
    items = [(f"{i}/{p}", c + bytes([65 + i % 26])) for i, (p, c) in enumerate(items)]
    ref, port = _pair(monkeypatch, "auto", max_batch_tiles=64, **kw)
    got = fingerprint(port.scan_batch(items))
    assert port.stats.device_dispatches >= 2 and port.stats.tiles > 64
    assert got == fingerprint(ref.scan_batch(items)) == oracle_fingerprint(items)
    assert _stats(port) == _stats(ref)
    dispatches = port.stats.device_dispatches
    assert fingerprint(port.scan_batch(items)) == got
    assert port.stats.device_dispatches == dispatches  # every chunk from the cache
    assert port.stats.resident_hits == dispatches


def test_sync_timing_splits_h2d_and_exec(monkeypatch):
    items = hostile_corpus(9, TILE) * 4
    items = [(f"{i}/{p}", c + bytes([97 + i % 26])) for i, (p, c) in enumerate(items)]
    monkeypatch.setenv("TRIVY_TPU_SYNC_TIMING", "1")
    ref, port = _pair(monkeypatch, "auto", kernel="xla", max_batch_tiles=64)
    assert port._fused and not port._use_fused_derive()  # sync timing is unfused
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items)) == oracle_fingerprint(items)
    st = port.stats
    assert st.h2d_s > 0 and st.exec_s > 0 and st.device_dispatches >= 2
    assert {"h2d_s", "exec_s"} <= set(st.phases())
    assert _stats(port) == _stats(ref)
    assert fingerprint(port.scan_batch(items)) == got
    assert port.stats.resident_hits == 0  # a cache hit would skip what is timed


def test_ruleset_digest_and_bad_arguments(monkeypatch):
    ref, port = _pair(monkeypatch, "off", sieve="native")
    assert port.ruleset_digest == ref.ruleset_digest and len(port.ruleset_digest) == 64
    for kw in (dict(sieve="regex"), dict(kernel="mosaic")):
        with pytest.raises(ValueError):
            GpuSecretEngine(device="cpu", **kw)
    monkeypatch.setenv("TRIVY_TPU_FUSED", "0")
    assert not GpuSecretEngine(device="cpu", tile_len=TILE)._fused
    assert GpuSecretEngine(device="cpu", tile_len=TILE, fused=True)._fused
    monkeypatch.delenv("TRIVY_TPU_FUSED")
    default = GpuSecretEngine(device="cpu", tile_len=TILE)
    assert default._fused and default.kernel == "pallas" and default.max_batch_tiles == 32768
    assert GpuSecretEngine(device="cpu", kernel="xla").max_batch_tiles == 4096
