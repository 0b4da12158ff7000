"""Scan programs in the port (`trivy_tpu_torch/programs/`, the engines'
`scan_programs`), on the CPU, against the JAX package's program engines
(`trivy_tpu/programs/`) built alike:

* demux parity on `tests/test_programs.py`'s mixed corpus (NUL-heavy,
  exact-tile, jumbo, binary, empty; a planted token and AWS key, the
  Apache-2.0 text, an MIT header) plus 300 monorepo files
  (`bench_corpus.make_monorepo_corpus`, a secret planted in every 40th)
  and three packaged license texts, for the backends `device` (codec off,
  auto, 4 and 6, and the megakernel path), `native` and `hybrid`: both
  programs' verdicts equal the reference engine's of the same backend, the
  secret slice is byte-identical to a secret-only port engine, the license
  slice equals the reference's `decide_findings` on every file; the
  program counters equal the reference's where the two sieve alike;
* `only=`, `scan_batch` routing, `programs_snapshot`, the table's
  rejections, the anchor-coverage `ProgramCompileError`s, `mesh` (a list
  of devices passes through; anything else raises), the arguments that
  raise (the oracle) and `rules_cache_dir`, which
  compiles the merged table and each member program into the registry.

The port is fed the reference's own merged compile
(`registry.store.compile_ruleset`), carried by `CompiledRules.from_numpy`.
The device backend runs at tile 512 with 64-row buckets, to keep the
plain K1 and K3 short on the CPU; its reference runs at tile 512 too.

Tolerance: exact.
"""

import dataclasses
import operator

import pytest

import bench_corpus
from test_programs import _corpus_text, _mixed_corpus
from test_torch_engine import fingerprint
from test_torch_license import source_order_anchors
from trivy_tpu import programs as ref_programs
from trivy_tpu.license import phrases as ref_phrases
from trivy_tpu.license.decide import decide_findings as ref_decide
from trivy_tpu.registry import store as rstore
from trivy_tpu_torch import programs
from trivy_tpu_torch.compiled import ARRAY_NAMES, CompiledRules
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.license import phrases
from trivy_tpu_torch.programs import (
    LicenseScanProgram,
    ProgramCompileError,
    SecretScanProgram,
    build_program_table,
    make_program_engine,
)
from trivy_tpu_torch.registry import store as rstore_port
from trivy_tpu_torch.registry.digest import ruleset_digest

TILE = 512
CAP = 64
# case -> (backend, codec, port engine kwargs)
CASES = {
    "device-off": ("device", "off", dict(tile_len=TILE, max_batch_tiles=CAP)),
    "device-auto": ("device", "auto", dict(tile_len=TILE, max_batch_tiles=CAP)),
    "device-4": ("device", "4", dict(tile_len=TILE, max_batch_tiles=CAP)),
    "device-6": ("device", "6", dict(tile_len=TILE, max_batch_tiles=CAP)),
    "device-mega": ("device", "auto", dict(tile_len=TILE, max_batch_tiles=CAP,
                                            megakernel=True)),
    "native": ("native", "auto", {}),
    "hybrid": ("hybrid", "auto", {}),
}
REF_KW = {"device": dict(tile_len=TILE), "native": {}, "hybrid": {}}


@pytest.fixture(scope="module", autouse=True)
def anchor_order():
    """Both packages' anchor tables in source order, whatever ran before in
    this process (`source_order_anchors`): the reference's merged compile
    and its table digest follow that order."""
    for module in (ref_phrases, phrases):
        source_order_anchors(module)


def license_doc(verdicts) -> list:
    return [[dataclasses.astuple(f) for f in fs] for fs in verdicts]


@pytest.fixture(scope="module")
def items():
    out = _mixed_corpus(seed=42)
    out += bench_corpus.make_monorepo_corpus(300, seed=11, planted_every=40)
    out += [(f"third_party/{name}/LICENSE", _corpus_text(name).encode())
            for name in ("GPL-3.0", "MIT", "CC0-1.0")]
    return out


@pytest.fixture(scope="module")
def ref_compile():
    table = ref_programs.build_program_table(ref_programs.default_programs())
    return table, rstore.compile_ruleset(table.merged_ruleset())


@pytest.fixture(scope="module")
def ref_runs(ref_compile, items):
    """One reference program engine per backend, built lazily: (its
    scan_programs result, its program counters, its compiled arrays)."""
    table, art = ref_compile
    cache = {}

    def run(backend):
        if backend not in cache:
            eng = ref_programs.make_program_engine(table, compiled=art, backend=backend,
                                                   **REF_KW[backend])
            res = eng.scan_programs(items)
            arrays = {n: operator.attrgetter(n)(eng) for n in ARRAY_NAMES}
            cache[backend] = (res, eng.program_stats, arrays)
        return cache[backend]

    return run


@pytest.fixture(scope="module")
def table():
    return build_program_table(programs.default_programs())


@pytest.fixture(scope="module")
def secret_only(items):
    return fingerprint(make_secret_engine(device="cpu").scan_batch(items))


@pytest.fixture(scope="module")
def host_license(items):
    return license_doc(ref_decide([c.decode("utf-8", errors="replace") for _, c in items]))


def _counters(stats: dict) -> dict:
    return {p: {k: v for k, v in st.items() if k != "resolve_s"} for p, st in stats.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_demux_matches_reference(case, table, items, ref_runs, secret_only, host_license,
                                 monkeypatch):
    backend, codec, kw = CASES[case]
    ref_res, ref_stats, arrays = ref_runs(backend)
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", codec)
    eng = make_program_engine(table, backend=backend, device="cpu", compiled=arrays, **kw)
    res = eng.scan_programs(items)
    assert list(res) == ["secret", "license"]
    got = fingerprint(res["secret"])
    assert got == fingerprint(ref_res["secret"]) == secret_only
    assert b"github-pat" in got and b"aws-access-key-id" in got
    lic = license_doc(res["license"])
    assert lic == license_doc(ref_res["license"]) == host_license
    names = [fs[0][0] for fs in lic if fs]
    assert {"Apache-2.0", "MIT", "GPL-3.0", "CC0-1.0"} <= set(names)
    if backend == "device":
        assert isinstance(eng, GpuSecretEngine) and eng.sieve == "gram"
        assert eng.megakernel_active == ("megakernel" in kw)
        assert eng.stats.device_dispatches > 0
    else:
        # the same row sieve over the same rows: the same candidates
        assert _counters(eng.program_stats) == _counters(ref_stats)
        assert isinstance(eng, GpuSecretEngine) and eng.sieve == "native"
    assert eng.programs_snapshot()["programs"][1]["verdicts"] == sum(1 for fs in lic if fs)


def test_only_scan_batch_and_snapshot(table, items, secret_only, host_license):
    eng = make_program_engine(table, device="cpu")
    assert isinstance(eng, GpuSecretEngine) and eng.sieve == "native"
    assert eng.program_table is table
    lic_only = eng.scan_programs(items, only=("license",))
    assert list(lic_only) == ["license"]
    assert license_doc(lic_only["license"]) == host_license
    assert fingerprint(eng.scan_batch(items)) == secret_only
    assert eng.scan_programs([]) == {"secret": [], "license": []}
    snap = eng.programs_snapshot()
    assert snap["enabled"] is True and snap["table"] == "secret+license"
    by_id = {p["id"]: p for p in snap["programs"]}
    assert by_id["license"]["files"] == by_id["secret"]["files"] == len(items)
    assert by_id["license"]["rules"] == 18 and by_id["secret"]["rules"] == 86
    assert by_id["secret"]["verify"] and not by_id["license"]["verify"]
    assert by_id["license"]["verdicts"] >= 4 and by_id["license"]["resolve_s"] >= 0
    assert eng.stats.files == 2 * len(items) and eng.stats.verify_s > 0
    assert snap["digest"] == ref_programs.build_program_table(
        ref_programs.default_programs()).digest()
    # the hybrid has no program pass (the server reads its table by
    # `getattr`); the native engine without a table has one that refuses
    hybrid = make_secret_engine(device="cpu")
    assert getattr(hybrid, "program_table", None) is None
    assert not hasattr(hybrid, "scan_programs")
    plain = make_secret_engine(backend="native", device="cpu")
    assert plain.programs_snapshot() == {"enabled": False}
    with pytest.raises(RuntimeError, match="program_table"):
        plain.scan_programs(items[:2])


def test_program_engine_builds_no_verifier_and_probes_no_link(table, monkeypatch):
    """The default program engine is the native one: no device verifier is
    built, the claim-killer's DFA only at `warmup()`, and the link is never
    measured."""
    from trivy_tpu_torch.engine import link, nfa_device, redfa

    built = {"nfa": 0, "dfa": 0}

    def counting(key, real):
        def init(self, *a, **k):
            built[key] += 1
            real(self, *a, **k)

        return init

    def no_probe(*a, **k):
        raise AssertionError("the program engine measured the link")

    monkeypatch.setattr(nfa_device.GpuNfaVerifier, "__init__",
                        counting("nfa", nfa_device.GpuNfaVerifier.__init__))
    monkeypatch.setattr(redfa.DfaVerifier, "__init__",
                        counting("dfa", redfa.DfaVerifier.__init__))
    monkeypatch.setattr(link, "probe_link", no_probe)
    eng = make_program_engine(table, device="cpu")
    assert isinstance(eng, GpuSecretEngine) and eng.sieve == "native"
    assert built == {"nfa": 0, "dfa": 0}
    eng.warmup()
    assert built == {"nfa": 0, "dfa": 1}


def test_table_rejections():
    secret, lic = SecretScanProgram(), LicenseScanProgram()
    with pytest.raises(ValueError, match="first"):
        build_program_table([lic, secret])
    with pytest.raises(ValueError, match="duplicate"):
        build_program_table([secret, SecretScanProgram()])
    with pytest.raises(ValueError, match="at least one"):
        build_program_table([])
    t = build_program_table([lic])
    assert t.table_id == "license" and t.num_rules == 18
    assert not t.verify_column_mask(18).any()
    with pytest.raises(ValueError, match="rule columns"):
        t.verify_column_mask(17)


def _patch_anchors(monkeypatch, table: dict) -> None:
    """Swap in a new anchor table wherever the port binds it.  A new dict,
    not `delitem`/`setitem` on the shared one: undoing a `delitem` puts the
    key back last and reorders the anchors for the rest of the process."""
    from trivy_tpu_torch.programs import license as lic_mod

    for module in (phrases, lic_mod):
        monkeypatch.setattr(module, "_PHRASE_ANCHORS", table)


def test_anchor_coverage_missing_anchor_fails(monkeypatch):
    _patch_anchors(monkeypatch, {
        k: v for k, v in phrases._PHRASE_ANCHORS.items() if k != "Apache-2.0"})
    with pytest.raises(ProgramCompileError, match="no anchor token"):
        LicenseScanProgram().ruleset()


def test_anchor_coverage_non_substring_anchor_fails(monkeypatch):
    _patch_anchors(monkeypatch, {
        k: "walrus" if k == "Apache-2.0" else v for k, v in phrases._PHRASE_ANCHORS.items()})
    with pytest.raises(ProgramCompileError, match="not a substring"):
        LicenseScanProgram().ruleset()


def test_anchor_coverage_corpus_text_without_anchor_fails(monkeypatch):
    from trivy_tpu_torch.programs import license as lic_mod

    monkeypatch.setattr(lic_mod, "anchor_tokens", lambda: list(phrases._PHRASE_ANCHORS.values()))
    with pytest.raises(ProgramCompileError, match="contains no anchor"):
        LicenseScanProgram().ruleset()


def test_factory_arguments_that_raise(table, tmp_path):
    # rules_cache_dir (ported): the merged table and each member program
    # compile into the registry, keyed by program id
    eng = make_program_engine(table, device="cpu", rules_cache_dir=str(tmp_path))
    assert isinstance(eng, GpuSecretEngine) and eng.sieve == "native"
    assert eng.program_table is table
    assert eng.ruleset_digest == ruleset_digest(table.merged_ruleset())
    for pid, rs in ((table.table_id, table.merged_ruleset()),
                    *((p.program_id, p.ruleset()) for p in table.programs)):
        assert rstore_port.load_artifact(rstore_port.program_cache_dir(str(tmp_path), pid),
                                         ruleset_digest(rs), program_id=pid) is not None, pid
    meshed = make_program_engine(table, backend="native", device="cpu", mesh=["cpu"] * 2)
    assert isinstance(meshed, GpuSecretEngine) and meshed.mesh.size == 2
    with pytest.raises(TypeError, match="mesh"):
        make_program_engine(table, device="cpu", mesh=object())
    for backend in ("oracle", "cpu"):
        with pytest.raises(ValueError, match="oracle"):
            make_program_engine(table, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="oracle"):
        make_secret_engine(backend="oracle", program_table=table)
    # compiled rules of another ruleset (the secret program's alone) are
    # refused on the program path, as the hybrid refuses them
    with pytest.raises(ValueError, match="ruleset"):
        make_program_engine(table, device="cpu",
                            compiled=CompiledRules.build(table.programs[0].ruleset()))
    eng = make_program_engine(table, backend="tpu", device="cpu", tile_len=TILE)
    assert isinstance(eng, GpuSecretEngine) and eng.program_table is table
