"""The port's engines over a CPU mesh: `GpuSecretEngine(mesh=)`,
`make_secret_engine(mesh=)` and `make_program_engine(mesh=)`, the twins of
`tests/test_mesh.py`'s parity bar, on its corpus (`_mesh_corpus`: NUL-heavy
blobs, exact-tile files, a 17-tile jumbo blob whose rows straddle shard
boundaries, planted secrets):

* findings byte-identical at 1/2/4/8 lanes, to the reference
  `TpuSecretEngine(mesh=)` at the same count and to the oracle, with K1 and
  B5; across codec modes off/auto/4/6 at 8; on an uneven 13-file batch; with
  the megakernel on and off; with >= 0.7 occupancy efficiency and a staging
  lane for each of the 8 lanes (B5's 512-row bucket, the reference's CPU
  sieve);
* the factories pass the mesh through (the oracle ignores it).

The device verify's group split is in `tests/test_torch_mesh_verify.py`.

Tolerance: exact (findings fingerprints and keep-masks).
"""

import functools
import json

import numpy as np
import pytest
import torch

from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu.mesh import topology as ref_topology
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.mesh import topology as mesh_topology
from trivy_tpu_torch.ops.megakernel import MegaGramSieve
from trivy_tpu_torch.programs import make_program_engine
from trivy_tpu_torch.scanner.packing import pack_dense

LANES = (1, 2, 4, 8)
TILE = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions step small tensors, and the
    suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_topology(monkeypatch):
    monkeypatch.delenv("TRIVY_TPU_MESH", raising=False)
    mesh_topology.clear_cache()
    ref_topology.clear_cache()
    yield
    mesh_topology.clear_cache()
    ref_topology.clear_cache()


def _mesh_corpus(n_files=400, tile=TILE):
    """`tests/test_mesh.py`'s corpus, byte for byte."""
    rng = np.random.RandomState(7)
    corpus = []
    for i in range(n_files):
        size = int(rng.randint(20, 900))
        body = bytes(rng.randint(32, 127, size=size, dtype=np.int32).astype(np.uint8))
        if i % 13 == 0:
            body += b'\ntoken = "ghp_' + bytes([97 + i % 26]) * 36 + b'"\n'
        if i % 17 == 0:
            body += b"\nAKIA" + (b"%016d" % i).replace(b"0", b"Z") + b"\n"
        if i % 11 == 0:
            body = b"\x00" * int(rng.randint(1, 400)) + body
        if i % 23 == 0:
            body = body.ljust(tile, b"A")[:tile]  # exactly one tile
        corpus.append((f"m{i}.py", body))
    jumbo = bytes(rng.randint(32, 127, size=17 * tile, dtype=np.int32).astype(np.uint8))
    corpus.append(("jumbo.txt", jumbo + b'\nkey = "ghp_' + b"q" * 36 + b'"\n'))
    return corpus


def _fingerprint(results) -> str:
    return json.dumps(
        [[s.file_path, [f.to_json() for f in s.findings]] for s in results],
        sort_keys=True,
    )


@functools.lru_cache(maxsize=None)
def _corpus(n_files: int = 400):
    return tuple(_mesh_corpus(n_files))


@functools.lru_cache(maxsize=None)
def _oracle(n_files: int = 400) -> str:
    oracle = OracleScanner()
    return _fingerprint([oracle.scan(p, c) for p, c in _corpus(n_files)])


@functools.lru_cache(maxsize=None)
def _reference(n: int, n_files: int = 400, codec: str | None = None) -> str:
    """The reference engine's findings at n virtual devices (its CPU engine:
    the XLA sieve, unfused), one engine a lane count."""
    import os

    prev = os.environ.get("TRIVY_TPU_LINK_CODEC")
    if codec is not None:
        os.environ["TRIVY_TPU_LINK_CODEC"] = codec
    try:
        ref_topology.clear_cache()
        engine = TpuSecretEngine(mesh=ref_topology.get_mesh(override=str(n)), tile_len=TILE)
        return _fingerprint(engine.scan_batch(list(_corpus(n_files))))
    finally:
        if codec is not None:
            if prev is None:
                os.environ.pop("TRIVY_TPU_LINK_CODEC")
            else:
                os.environ["TRIVY_TPU_LINK_CODEC"] = prev
        ref_topology.clear_cache()


def _mesh(n: int):
    return mesh_topology.get_mesh(override=str(n), device_type="cpu")


@pytest.mark.parametrize("n", LANES)
def test_parity_1_2_4_8_lanes_vs_reference_and_oracle(n):
    """Byte-identical findings at every lane count, through K1 (the port's
    default) and B5 (the reference's CPU sieve), each equal to the reference
    engine at n devices and to the oracle; at 8 lanes B5's 512-row bucket
    feeds all 8 lanes at >= 0.7 efficiency, and the jumbo blob's rows
    straddle a shard boundary."""
    corpus = list(_corpus())
    want = _reference(n)
    assert want == _oracle()
    assert sum(len(f) for _, f in json.loads(want)) >= 10, "corpus must plant hits"
    for kernel in ("pallas", "xla"):
        engine = GpuSecretEngine(device="cpu", tile_len=TILE, kernel=kernel, mesh=_mesh(n))
        assert mesh_topology.mesh_device_count(engine.mesh) == n
        mesh_topology.reset_occupancy()
        assert _fingerprint(engine.scan_batch(corpus)) == want, kernel
        snap = mesh_topology.occupancy_snapshot()
        assert len(snap) == (n if n > 1 else 0)
        if kernel == "xla" and n == 8:
            # every lane owns a staging lane, and only real rows count
            batch = pack_dense([c for _, c in corpus], TILE, 3)
            assert sum(d["rows"] for d in snap.values()) == len(batch.rows)
            assert mesh_topology.occupancy_efficiency() >= 0.7
            assert len(batch.rows) <= engine._buckets()[0]


@functools.lru_cache(maxsize=None)
def _straddling_corpus():
    """`_mesh_corpus(k)` for the first k whose jumbo blob's rows cross row
    256 of a 512-row bucket, so they straddle a shard boundary at 2, 4 and
    8 lanes."""
    for k in range(200, 400):
        corpus = _mesh_corpus(k)
        batch = pack_dense([c for _, c in corpus], TILE, 3)
        if batch.file_row_lo[-1] < 256 <= batch.file_row_hi[-1] and len(batch.rows) <= 512:
            return tuple(corpus)
    raise AssertionError("no prefix puts the jumbo blob across row 256")


@pytest.mark.parametrize("kernel,megakernel", [("xla", False), ("pallas", True)])
def test_jumbo_straddling_shards_derives_from_every_shard(kernel, megakernel):
    """A file whose rows straddle shard boundaries derives from the shards'
    hit words gathered in row order (B5's fused derive, and K3m's counts
    summed before the threshold): its finding survives at 2, 4 and 8 lanes,
    equal to the oracle and to the reference at 8 devices."""
    corpus = list(_straddling_corpus())
    oracle = OracleScanner()
    want = _fingerprint([oracle.scan(p, c) for p, c in corpus])
    assert json.loads(want)[-1][1], "the jumbo blob's secret is a finding"
    ref_topology.clear_cache()
    ref = TpuSecretEngine(mesh=ref_topology.get_mesh(override="8"), tile_len=TILE)
    assert _fingerprint(ref.scan_batch(corpus)) == want
    for n in (2, 4, 8):
        engine = GpuSecretEngine(device="cpu", tile_len=TILE, kernel=kernel,
                                 megakernel=megakernel, max_batch_tiles=512, mesh=_mesh(n))
        assert engine._buckets()[0] == 512 and engine.megakernel_active == megakernel
        assert _fingerprint(engine.scan_batch(corpus)) == want, n


@pytest.mark.parametrize("mode", ["off", "auto", "4", "6"])
def test_parity_across_codec_modes_at_8(monkeypatch, mode):
    """The per-lane staging, shard-local unpack and demux are transparent to
    every link-codec mode."""
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
    corpus = list(_corpus(60))
    engine = GpuSecretEngine(device="cpu", tile_len=TILE, mesh=_mesh(8))
    assert (engine._link is None) == (mode == "off")
    got = _fingerprint(engine.scan_batch(corpus))
    assert got == _oracle(60) == _reference(8, 60, mode)
    unmeshed = GpuSecretEngine(device="cpu", tile_len=TILE, mesh=None)
    assert unmeshed.mesh is None
    assert _fingerprint(unmeshed.scan_batch(corpus)) == got


def test_uneven_batch_pads_to_lane_multiple():
    corpus = list(_corpus(13))
    for kernel in ("pallas", "xla"):
        engine = GpuSecretEngine(device="cpu", tile_len=TILE, kernel=kernel, mesh=_mesh(8))
        assert all(b % 8 == 0 for b in engine._buckets())
        assert _fingerprint(engine.scan_batch(corpus)) == _oracle(13) == _reference(8, 13)


@pytest.mark.parametrize("n", [2, 8])
def test_megakernel_on_and_off_over_the_mesh(monkeypatch, n):
    """With the megakernel on, a batch runs K4 once a lane and one epilogue
    (K3m), never K3; off, the staged K1 path; both equal the oracle, and a
    rescan comes from the resident row store."""
    corpus = list(_corpus(60))
    calls = {"acc": 0, "mask": 0, "epilogue": 0}
    acc, mask, epi = MegaGramSieve.acc, MegaGramSieve.__call__, MegaGramSieve.epilogue

    def count(name, fn):
        def wrapped(self, *a):
            calls[name] += 1
            return fn(self, *a)
        return wrapped

    monkeypatch.setattr(MegaGramSieve, "acc", count("acc", acc))
    monkeypatch.setattr(MegaGramSieve, "__call__", count("mask", mask))
    monkeypatch.setattr(MegaGramSieve, "epilogue", count("epilogue", epi))
    for on in (True, False):
        engine = GpuSecretEngine(device="cpu", tile_len=TILE, megakernel=on, mesh=_mesh(n))
        assert engine.megakernel_active == on
        before = dict(calls)
        assert _fingerprint(engine.scan_batch(corpus)) == _oracle(60)
        got = {k: calls[k] - before[k] for k in calls}
        assert got == ({"acc": n, "mask": 0, "epilogue": 1} if on else
                       {"acc": 0, "mask": 0, "epilogue": 0})
        assert _fingerprint(engine.scan_batch(corpus)) == _oracle(60)
        assert engine.stats.resident_hits == 1
        assert calls == {k: before[k] + got[k] for k in calls}  # no launch on the rescan


@pytest.mark.parametrize("megakernel", [False, True])
def test_scan_ledgers_each_lanes_staging_until_the_chunk_is_done(monkeypatch, megakernel):
    """A meshed scan ledgers every staged chunk in memwatch one entry a lane,
    under the lane's tag and that lane's shard bytes, and releases each
    entry once its chunk is done: none is left after the scan."""
    from trivy_tpu_torch.engine import pipeline
    from trivy_tpu_torch.obs import memwatch

    staged = []
    real = memwatch.track

    def track(component, nbytes, device="", **kw):
        handle = real(component, nbytes, device=device, **kw)
        if component == pipeline.STAGING_COMPONENT:
            staged.append((device, nbytes, handle))
        return handle

    monkeypatch.setattr(memwatch, "track", track)
    memwatch.reset()
    memwatch.enable()
    try:
        mesh = _mesh(4)
        engine = GpuSecretEngine(device="cpu", tile_len=TILE, megakernel=megakernel,
                                 mesh=mesh, resident_chunks=0)
        assert _fingerprint(engine.scan_batch(list(_corpus(60)))) == _oracle(60)
    finally:
        memwatch.disable()
        memwatch.reset()
    assert staged and len(staged) % 4 == 0
    chunks = [staged[i : i + 4] for i in range(0, len(staged), 4)]
    assert all([d for d, _, _ in c] == list(mesh.tags) for c in chunks)
    assert all(len({nb for _, nb, _ in c}) == 1 for c in chunks)
    assert all(h.released for _, _, h in staged)


def test_resident_keys_carry_the_lane_count():
    buf = np.zeros((64, 256), np.uint8)
    meshed = GpuSecretEngine(device="cpu", tile_len=TILE, mesh=_mesh(4))
    plain = GpuSecretEngine(device="cpu", tile_len=TILE)
    store = meshed._row_store
    assert meshed._chunk_digest(buf, store) != plain._chunk_digest(buf, plain._row_store)
    assert meshed._chunk_digest(buf, store).endswith(":lanes4")


def test_engine_takes_a_device_list_as_its_mesh():
    engine = GpuSecretEngine(device="cpu", tile_len=TILE, mesh=["cpu"] * 2)
    assert engine.mesh.tags == ("cpu:0", "cpu:1")
    assert GpuSecretEngine(device="cpu", tile_len=TILE, mesh=["cpu"]).mesh is None
    with pytest.raises(ValueError, match="unsupported device"):
        GpuSecretEngine(device="cpu", tile_len=TILE, mesh=["cpu", "meta"])


@pytest.mark.parametrize("backend", ["device", "native", "hybrid", "oracle"])
def test_make_secret_engine_passes_the_mesh(backend):
    corpus = list(_corpus(60))
    mesh = _mesh(4)
    engine = make_secret_engine(backend=backend, device="cpu", mesh=mesh,
                                **({"verify": "fused"} if backend == "hybrid" else {}),
                                **({"tile_len": TILE} if backend == "device" else {}))
    if backend == "oracle":
        assert isinstance(engine, OracleScanner)
    else:
        assert engine.mesh is mesh
    if backend == "hybrid":
        assert engine._nfa_verifier.mesh is mesh
    results = engine.scan_batch(corpus)
    assert _fingerprint(results) == _oracle(60)


def test_make_program_engine_passes_the_mesh():
    corpus = list(_corpus(60))
    mesh = _mesh(4)
    meshed = make_program_engine(backend="device", device="cpu", mesh=mesh, tile_len=TILE)
    plain = make_program_engine(backend="device", device="cpu", tile_len=TILE)
    assert meshed.mesh is mesh and plain.mesh is None
    got, want = meshed.scan_programs(corpus), plain.scan_programs(corpus)
    assert _fingerprint(got["secret"]) == _fingerprint(want["secret"]) == _oracle(60)
    assert got["license"] == want["license"]
