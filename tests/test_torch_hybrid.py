"""The port's hybrid engine (`trivy_tpu_torch/engine/hybrid.py`
`GpuHybridSecretEngine`, on the CPU) against the JAX package's
`HybridSecretEngine` and its `OracleScanner`:

* the C pre-sieve's candidate quads and device-eligible lanes equal the
  reference's `_sieve_chunk`;
* `findings_fingerprint` in verify modes dfa / device / fused equals the
  reference and the oracle, on `VERIFY_CORPUS`, a fuzz corpus shaped like
  `tests/test_fused_verify.py`'s `_hybrid_corpus` (NUL-bracketed and jumbo
  secrets) and a 200-file hit-dense corpus
  (`bench_corpus.make_hitdense_corpus`), with equal `device_pairs`.  One
  reference engine (fused) serves all three modes through its rungs: dfa
  against its host rung, device and fused against its fused scan, whose
  findings and device lanes equal its legacy stream's by the reference's
  own contract (tests/test_fused_verify.py); the port's one fused scan
  against the reference's in both its `TRIVY_TPU_FUSED_SCAN` modes; the 34
  golden cases are in `tests/test_torch_hybrid_goldens.py`;
* `scan_batch_host` / `scan_batch_device_legacy` and the verifier state
  they restore;
* the gate: `engine/link.py` `gate_terms` under `TRIVY_TPU_LINK=wide|relay`
  equals the reference's terms, `auto` on the CPU resolves to dfa /
  no-device, an unknown mode raises; the megakernel's measured gate in
  `GpuSecretEngine.warmup`;
* `make_secret_engine`'s backends, aliases and the cases that raise (a
  program table builds the native engine under auto and hybrid), and the
  CLI's `--secret-backend`.

Tolerance: exact.
"""

import functools
import json
import operator
import random
import sys

import numpy as np
import pytest
import torch

import bench_corpus
from test_torch_engine import TILE, _fixture_tree, hostile_corpus
from trivy_tpu.engine import hybrid as ref_hybrid
from trivy_tpu.engine.hybrid import HybridSecretEngine
from trivy_tpu.engine.oracle import OracleScanner as RefOracle
from trivy_tpu.registry.store import findings_fingerprint as ref_fingerprint
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.compiled import ARRAY_NAMES
from trivy_tpu_torch.engine import link as link_mod
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.hybrid import GpuHybridSecretEngine, make_secret_engine
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.ftypes import VERIFY_CORPUS, findings_fingerprint
from trivy_tpu_torch.obs import gatelog
from trivy_tpu_torch.programs import build_program_table, default_programs
from trivy_tpu_torch.registry.digest import ruleset_digest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions step small tensors, and the
    suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

MODES = ("dfa", "device", "fused")
ALNUM = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def _fuzz_corpus(seed: int) -> list[tuple[str, bytes]]:
    """`_hybrid_corpus`'s shapes: secrets in small env files, a
    NUL-bracketed secret (its span overflows to the padded path), a secret
    deep inside a 49 KB file (trimmed onto the device), clean prose."""
    rng = random.Random(seed)
    pick = lambda n: "".join(rng.choice(ALNUM) for _ in range(n)).encode()
    sec = lambda: b"ghp_" + pick(36)
    out = [(f"src/a{i}.env", b"x = 1\nTOKEN = " + sec() + b"\n" + pick(200))
           for i in range(8)]
    out.append(("nul.bin", b"\x00" * 200 + sec() + b"\x00" * 50))
    out.append(("big.txt", pick(40000) + b"\nt " + sec() + b"\n" + pick(9000)))
    out.append(("clean.md", b"prose, no secrets, " + pick(500)))
    out.append(("aws.env", b'AWS_ACCESS_KEY_ID="AKIA' + pick(16).upper() + b'"\n'))
    return out


@functools.lru_cache(maxsize=None)
def _corpus(name: str) -> tuple:
    if name == "verify":
        return tuple(VERIFY_CORPUS) + tuple(hostile_corpus(42, TILE))
    if name == "fuzz":
        return tuple(_fuzz_corpus(11))
    return tuple(bench_corpus.make_hitdense_corpus(200, seed=13))


@functools.lru_cache(maxsize=None)
def _port(mode: str):
    return GpuHybridSecretEngine(device="cpu", verify=mode)


@functools.lru_cache(maxsize=1)
def _reference():
    return HybridSecretEngine(verify="fused")


@functools.lru_cache(maxsize=None)
def _reference_run(name: str, host: bool) -> tuple[bytes, int]:
    """The reference's fingerprint of a corpus and the lanes it verified on
    the device: its host rung, or its fused scan."""
    ref = _reference()
    pairs0 = ref.stats.device_pairs
    fp = ref_fingerprint(_Batch(ref.scan_batch_host if host else ref.scan_batch),
                         list(_corpus(name)))
    return fp, ref.stats.device_pairs - pairs0


class _Batch:
    """A scan function behind the engines' batch interface."""

    def __init__(self, scan_batch):
        self.scan_batch = scan_batch


@functools.lru_cache(maxsize=None)
def _oracle_fp(name: str) -> bytes:
    oracle = RefOracle()
    return ref_fingerprint(_Batch(lambda items: [oracle.scan(p, c) for p, c in items]),
                           list(_corpus(name)))


@pytest.mark.parametrize("name", ["verify", "fuzz", "hitdense"])
def test_presieve_quads_equal_reference(name):
    port, ref = _port("device"), _reference()
    contents = [c for _, c in _corpus(name)]
    got, want = port._sieve_chunk(contents), ref._sieve_chunk(contents)
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])  # (file, rule, first, last)
    np.testing.assert_array_equal(got[1], want[1])  # device-eligible lanes
    np.testing.assert_array_equal(got[3], want[3])
    assert len(got[0]) and got[1].any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["verify", "fuzz", "hitdense"])
def test_findings_equal_reference_and_oracle(monkeypatch, name, mode):
    monkeypatch.setenv("TRIVY_TPU_FUSED_SCAN", "seq")
    port = _port(mode)
    corpus = list(_corpus(name))
    pairs0 = port.stats.device_pairs
    got = findings_fingerprint(port, corpus)
    want, ref_pairs = _reference_run(name, host=mode == "dfa")
    assert got == want
    assert got == _oracle_fp(name)
    assert port.stats.device_pairs - pairs0 == ref_pairs
    assert (port.stats.device_pairs > pairs0) == (mode != "dfa")
    if mode != "dfa" and name != "verify":
        st = port._nfa_verifier.stream_stats
        assert st["backend"] == ("fused" if mode == "fused" else "stream")
        assert st["dispatches"] > 0


@pytest.mark.parametrize("scan_mode", ["assoc", "seq"])
def test_fused_scan_modes_equal_reference(monkeypatch, scan_mode):
    """The reference's fused scan in either block walk (its
    `TRIVY_TPU_FUSED_SCAN`) equals the port's."""
    monkeypatch.setenv("TRIVY_TPU_FUSED_SCAN", scan_mode)
    port, ref = _port("fused"), _reference()
    corpus = list(_corpus("fuzz"))
    assert findings_fingerprint(port, corpus) == ref_fingerprint(ref, corpus)
    st = port._nfa_verifier.stream_stats
    assert st["backend"] == "fused" and st["overflow_lanes"] > 0


def test_reference_arrays_carry_into_the_hybrid(monkeypatch):
    """The reference engine's compiled arrays (`CompiledRules.from_numpy`)
    and its verifier's rule stack (`build_rule_stack`) seed the port's
    hybrid, which then scans as the reference does; arrays of another
    ruleset are refused."""
    monkeypatch.setenv("TRIVY_TPU_FUSED_SCAN", "seq")
    from trivy_tpu.engine.nfa_device import build_rule_stack as ref_rule_stack

    ref = _reference()
    arrays = {name: operator.attrgetter(name)(ref) for name in ARRAY_NAMES}
    stack = ref_rule_stack(ref._nfa_verifier)
    port = GpuHybridSecretEngine(device="cpu", verify="fused", compiled=arrays,
                                 rule_stack=stack)
    eligible = np.flatnonzero(port._nfa_verifier.has_nfa)
    assert sorted(port._nfa_verifier._byte_tensor_cache) == eligible.tolist()
    corpus = list(_corpus("fuzz"))
    assert findings_fingerprint(port, corpus) == ref_fingerprint(ref, corpus)
    other = dict(arrays)
    other["gset.masks"] = arrays["gset.masks"][::-1]
    with pytest.raises(ValueError, match="ruleset"):
        GpuHybridSecretEngine(device="cpu", verify="dfa", compiled=other)


def _flat(results):
    return [(s.file_path, [(f.rule_id, f.start_line, f.match) for f in s.findings])
            for s in results]


def test_degraded_rungs_restore_the_verifier(monkeypatch):
    port = _port("fused")
    corpus = list(_corpus("fuzz"))
    want = _flat(port.scan_batch(corpus))
    nfa = port._nfa_verifier
    legacy = port.scan_batch_device_legacy(corpus)
    assert nfa.fused is True and nfa.stream_stats["backend"] == "stream"
    pairs = port.stats.device_pairs
    host = port.scan_batch_host(corpus)
    assert port._nfa_verifier is nfa and port.stats.device_pairs == pairs
    assert _flat(legacy) == _flat(host) == want

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(nfa, "verify_lanes", boom)
    with pytest.raises(RuntimeError):
        port.scan_batch_device_legacy(corpus)
    assert nfa.fused is True
    assert _flat(port.scan_batch_host(corpus)) == want  # the host rung


# -- the gate ----------------------------------------------------------------


@pytest.mark.parametrize("link", ["wide", "relay"])
@pytest.mark.parametrize("kw", [
    {}, {"d2h_ratio": link_mod.STREAM_D2H_RATIO},
    {"d2h_ratio": link_mod.FUSED_MASK_D2H_RATIO, "profile": "fused"},
    {"d2h_ratio": 0.01, "profile": "mesh", "devices": 4},
    {"h2d_ratio": 0.5, "d2h_ratio": 0.01, "profile": "mega", "exec_mb_s": 300.0},
    {"h2d_ratio": 0.5, "d2h_ratio": 0.01, "profile": "mega", "exec_mb_s": 9e4},
], ids=["stream", "stream-compact", "fused", "mesh", "mega-slow", "mega-fast"])
def test_gate_terms_equal_reference(monkeypatch, link, kw):
    monkeypatch.setenv("TRIVY_TPU_LINK", link)
    assert link_mod.gate_terms(**kw) == ref_hybrid.gate_terms(**kw)
    assert link_mod.probe_link() == ref_hybrid.probe_link()
    ratios = {k: v for k, v in kw.items() if k.endswith("ratio")}
    assert link_mod.gate_terms(**ratios)["wide"] == ref_hybrid._link_is_wide(**ratios)


def test_auto_on_cpu_resolves_to_dfa_and_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_LINK", "wide")  # the CPU never prices
    port = GpuHybridSecretEngine(device="cpu")
    assert port.verify == "dfa" and port._nfa_verifier is None
    rec = port.gate_decision
    assert (rec["requested"], rec["backend"], rec["reason"]) == ("auto", "dfa", "no-device")
    assert gatelog.last()["seq"] == rec["seq"]
    forced = GpuHybridSecretEngine(device="cpu", verify="fused").gate_decision
    assert (forced["backend"], forced["reason"]) == ("fused", "forced")
    with pytest.raises(ValueError):
        GpuHybridSecretEngine(device="cpu", verify="warp")


def test_megakernel_gate_prices_auto_mode_only(monkeypatch):
    """The CPU has no auto megakernel (it is off there by default), so the
    engine is built with it and then marked auto, as a CUDA engine is."""
    monkeypatch.delenv("TRIVY_TPU_MEGAKERNEL", raising=False)
    kw = dict(device="cpu", tile_len=TILE, max_batch_tiles=64, megakernel=True)
    explicit = GpuSecretEngine(**kw)
    seq = (gatelog.last() or {}).get("seq")
    explicit.warmup()
    assert explicit.megakernel_active and (gatelog.last() or {}).get("seq") == seq
    assert explicit._mega_exec_mb_s() > 0  # a real measured call (plain K3)
    corpus = list(VERIFY_CORPUS)
    want = findings_fingerprint(explicit, corpus)
    seen = set()
    for link, rate in (("wide", 9e4), ("relay", 9e4), ("relay", 100.0)):
        monkeypatch.setenv("TRIVY_TPU_LINK", link)
        terms = ref_hybrid.gate_terms(h2d_ratio=0.5, d2h_ratio=link_mod.FUSED_MASK_D2H_RATIO,
                                      profile="mega", exec_mb_s=rate)
        on = terms["wide"]
        seen.add(on)
        eng = GpuSecretEngine(**kw)
        assert eng._link.ratio == 0.5  # the auto codec is 4-bit on the builtin ruleset
        eng._mega_auto = True
        monkeypatch.setattr(eng, "_mega_exec_mb_s", lambda r=rate: r)
        eng.warmup()
        assert eng.megakernel_active is on
        rec = gatelog.last()
        assert rec["seq"] == eng.mega_gate["seq"]
        assert rec["reason"] == ("mega-wide" if on else "mega-narrow")
        assert rec["margin"] == terms["margin"]
        assert rec["link"]["eff_mb_per_sec"] == terms["eff_mb_per_sec"]
        assert findings_fingerprint(eng, corpus) == want
    assert seen == {True, False}  # the relay link clears the fused model
    monkeypatch.setenv("TRIVY_TPU_MEGAKERNEL", "1")
    assert GpuSecretEngine(device="cpu", tile_len=TILE)._mega_auto is False


# -- the factory and the CLI ---------------------------------------------------


def test_make_secret_engine_backends(tmp_path):
    assert isinstance(make_secret_engine(backend="oracle"), OracleScanner)
    assert isinstance(make_secret_engine(backend="cpu"), OracleScanner)
    for backend in ("device", "tpu"):
        assert isinstance(make_secret_engine(backend=backend, device="cpu", tile_len=TILE),
                          GpuSecretEngine)
    auto = make_secret_engine(device="cpu")
    assert isinstance(auto, GpuHybridSecretEngine) and auto.verify == "dfa"
    fused = make_secret_engine(backend="hybrid", device="cpu", verify="fused")
    assert isinstance(fused, GpuHybridSecretEngine) and fused.verify == "fused"
    native = make_secret_engine(backend="native", device="cpu", tile_len=TILE)
    assert isinstance(native, GpuSecretEngine) and native.sieve == "native"
    # mesh (A11, ported): a list of devices is a mesh; anything else raises
    meshed = make_secret_engine(device="cpu", mesh=["cpu"] * 2)
    assert isinstance(meshed, GpuHybridSecretEngine) and meshed.mesh.size == 2
    with pytest.raises(TypeError, match="mesh"):
        make_secret_engine(device="cpu", mesh=object())
    # rules_cache_dir (ported): the engine starts from the registry's artifact
    warm = make_secret_engine(device="cpu", rules_cache_dir=str(tmp_path))
    assert isinstance(warm, GpuHybridSecretEngine) and warm.verify == "dfa"
    assert warm.ruleset_digest == ruleset_digest(auto.ruleset)
    assert (tmp_path / warm.ruleset_digest / "manifest.json").exists()
    # the hybrid keeps no resident rows: `resident_chunks` is not handed to it
    assert isinstance(make_secret_engine(device="cpu", resident_chunks=3),
                      GpuHybridSecretEngine)
    # a program table (A9) builds a program engine over its merged ruleset,
    # the native one under auto and hybrid, as the reference hybrid's demux
    table = build_program_table(default_programs())
    for backend in ("auto", "hybrid", "native"):
        eng = make_secret_engine(ruleset=table.merged_ruleset(), backend=backend,
                                 device="cpu", program_table=table)
        assert isinstance(eng, GpuSecretEngine) and eng.sieve == "native"
        assert eng.program_table is table
    with pytest.raises(ValueError):
        make_secret_engine(backend="warp", device="cpu")


def test_cli_secret_backend(tmp_path, tmp_path_factory, capsys, monkeypatch):
    # the CLI starts from the compiled-rules registry by default: keep it here
    monkeypatch.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(tmp_path_factory.mktemp("rules")))
    _fixture_tree(tmp_path)
    reports = {}
    for backend in ("auto", "hybrid", "tpu", "cpu", "native"):
        assert cli.main(["fs", "--scanners", "secret", "--format", "json", "--device", "cpu",
                         "--secret-backend", backend, str(tmp_path)]) == 0
        reports[backend] = json.loads(capsys.readouterr().out)
    assert len({json.dumps(r, sort_keys=True) for r in reports.values()}) == 1
    assert {r["Target"] for r in reports["auto"]["Results"]} == {
        "src/config.env", "deploy/ci.yaml", "app/main.py"}
    monkeypatch.setenv("TRIVY_TPU_SECRET_BACKEND", "cpu")
    assert cli.main(["fs", "--format", "json", "--device", "cpu", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out) == reports["auto"]
    # the server backend needs an address (tests/test_torch_rules_push.py
    # scans through a server)
    with pytest.raises(SystemExit):
        cli.main(["fs", "--device", "cpu", "--secret-backend", "server", str(tmp_path)])
    assert "requires --server" in capsys.readouterr().err
    assert "jax" in sys.modules  # this test process holds both packages
