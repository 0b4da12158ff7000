"""The port's compiled-rules registry and executable cache
(`trivy_tpu_torch/registry/`, `commands/rules.py`), on the CPU, against the
JAX package's registry (`trivy_tpu/registry/`):

* `compile_ruleset` gives the reference's arrays, array by array, for the
  builtin ruleset, a custom `--secret-config` and the merged secret +
  license program table (with its `program_id`);
* an artifact either package writes loads through the other in strict
  mode, and the engines built from it give the findings of the cold
  engines and of the oracle, byte for byte, on `VERIFY_CORPUS` and the
  parity fixtures;
* a warm start makes no call to `compile_rules`, `build_probe_set`,
  `build_gram_set` or `build_rule_stack`, through `make_secret_engine`
  (auto, device, native) and `make_program_engine`;
* every rejection (corrupt npz, foreign digest, schema and version
  mismatches, a tampered class map or rule stack with its sha256
  recomputed, the `registry.load:corrupt` fault, a foreign program id)
  falls back to a fresh compile;
* the executable cache: on the g++ native library (warm load, a flipped
  byte, a compiler or target mismatch), and on the nvcc path through a
  fake compiler (keys, rejections, the ptxas report, a failed build);
* the `rules compile|ls|verify` CLI, `fs --rules-cache-dir`, and `rules
  push` without a server (`tests/test_torch_rules_push.py` pushes to one).

Tolerance: exact.
"""

import ctypes
import hashlib
import io
import json
import logging
import os
import stat
from pathlib import Path

import numpy as np
import pytest

from test_torch_license import source_order_anchors
from trivy_tpu import programs as ref_programs
from trivy_tpu.engine.hybrid import make_secret_engine as ref_make_secret_engine
from trivy_tpu.license import phrases as ref_phrases
from trivy_tpu.registry import store as rstore
from trivy_tpu.rules.model import build_ruleset as ref_build_ruleset
from trivy_tpu.rules.model import load_config as ref_load_config
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import faults, programs
from trivy_tpu_torch.engine import device as device_mod
from trivy_tpu_torch.engine import grams as grams_mod
from trivy_tpu_torch.engine import hybrid as hybrid_mod
from trivy_tpu_torch.engine import nfa as nfa_mod
from trivy_tpu_torch.engine import nfa_device as nfa_device_mod
from trivy_tpu_torch.engine import probes as probes_mod
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.ftypes import VERIFY_CORPUS, findings_fingerprint
from trivy_tpu_torch.license import phrases
from trivy_tpu_torch.native import loader
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.registry import aotcache
from trivy_tpu_torch.registry import store as pstore
from trivy_tpu_torch.registry.digest import ruleset_digest
from trivy_tpu_torch.rules.model import RuleSet, build_ruleset, load_config

TESTS = Path(__file__).parent
CONFIG = str(TESTS / "parity" / "configs" / "config.yaml")
TILE = 512
CAP = 64


def parity_corpus() -> list[tuple[str, bytes]]:
    return sorted((p.name, p.read_bytes()) for p in (TESTS / "parity" / "fixtures").iterdir()
                  if p.suffix in (".txt", ".json", ".md"))


CORPUS = list(VERIFY_CORPUS) + parity_corpus()


@pytest.fixture(scope="module", autouse=True)
def anchor_order():
    """Both packages' license anchors in source order (`source_order_anchors`):
    the merged table's rule columns follow it."""
    for module in (ref_phrases, phrases):
        source_order_anchors(module)


def rulesets(case: str):
    """(port ruleset, reference ruleset, program id) of a case."""
    if case == "builtin":
        return build_ruleset(), ref_build_ruleset(), "secret"
    if case == "config":
        return build_ruleset(load_config(CONFIG)), ref_build_ruleset(ref_load_config(CONFIG)), "secret"
    table = programs.build_program_table(programs.default_programs())
    ref_table = ref_programs.build_program_table(ref_programs.default_programs())
    assert table.table_id == ref_table.table_id
    return table.merged_ruleset(), ref_table.merged_ruleset(), table.table_id


@pytest.fixture(scope="module")
def ref_compiles():
    """One reference compile per case, made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            _, ref_rs, pid = rulesets(case)
            cache[case] = rstore.compile_ruleset(ref_rs, program_id=pid)
        return cache[case]

    return get


@pytest.mark.parametrize("case", ["builtin", "config", "merged"])
def test_compile_ruleset_arrays_are_the_reference(case, ref_compiles):
    port_rs, ref_rs, pid = rulesets(case)
    assert ruleset_digest(port_rs) == rstore.ruleset_digest(ref_rs)
    want = ref_compiles(case)
    got = pstore.compile_ruleset(port_rs, program_id=pid)
    assert got.digest == want.digest and got.program_id == want.program_id == pid
    ga, wa = pstore._pack_arrays(got), rstore._pack_arrays(want)
    assert sorted(ga) == sorted(wa)
    for name in wa:
        assert ga[name].dtype == wa[name].dtype and np.array_equal(ga[name], wa[name]), name
    assert got.nfa.rule_ids == want.nfa.rule_ids
    assert [(p.rule_id, p.gate_probe_ids, p.anchor_conjuncts) for p in got.pset.plans] == [
        (p.rule_id, p.gate_probe_ids, p.anchor_conjuncts) for p in want.pset.plans]
    assert [p.classes for p in got.pset.probes] == [p.classes for p in want.pset.probes]
    assert int(ga["vstack_has"].sum()) > 0


def _port_engines(ruleset, art):
    yield "auto", make_secret_engine(ruleset=ruleset, device="cpu", compiled=art)
    yield "device", make_secret_engine(ruleset=ruleset, backend="device", device="cpu",
                                       compiled=art, tile_len=TILE, max_batch_tiles=CAP)
    yield "native", make_secret_engine(ruleset=ruleset, backend="native", device="cpu",
                                       compiled=art)


@pytest.mark.parametrize("case", ["builtin", "config"])
def test_reference_artifact_loads_in_the_port(case, tmp_path):
    """The reference writes, the port loads (strict): its engines give the
    oracle's findings."""
    port_rs, ref_rs, _ = rulesets(case)
    ref_art, source = rstore.get_or_compile(ref_rs, cache_dir=str(tmp_path))
    assert source == "cold"
    art = pstore.load_artifact(str(tmp_path), ref_art.digest)
    assert art is not None and art.manifest["jax_version"] and "torch_version" not in art.manifest
    want = findings_fingerprint(OracleScanner(port_rs), CORPUS)
    for backend, eng in _port_engines(port_rs, art):
        assert eng.ruleset_digest == ref_art.digest, backend
        assert findings_fingerprint(eng, CORPUS) == want, backend


@pytest.mark.parametrize("case", ["builtin", "config"])
def test_port_artifact_loads_in_the_reference(case, tmp_path):
    """The port writes, the reference loads (strict): its engine gives the
    findings of a cold reference engine, of the oracle and of the port's
    warm engine."""
    port_rs, ref_rs, _ = rulesets(case)
    art, source = pstore.get_or_compile(port_rs, cache_dir=str(tmp_path))
    assert source == "cold" and art.manifest["torch_version"]
    assert "jax_version" not in art.manifest
    ref_art = rstore.load_artifact(str(tmp_path), art.digest)
    assert ref_art is not None
    warm = ref_make_secret_engine(ruleset=ref_rs, backend="auto", compiled=ref_art)
    got = rstore.findings_fingerprint(warm, CORPUS)
    assert got == rstore.findings_fingerprint(ref_make_secret_engine(ruleset=ref_rs), CORPUS)
    assert got == findings_fingerprint(OracleScanner(port_rs), CORPUS)
    assert got == findings_fingerprint(make_secret_engine(ruleset=port_rs, device="cpu",
                                                          compiled=art), CORPUS)


def test_merged_program_artifact_loads_both_ways(tmp_path):
    """The merged secret + license table, stored under its program id by
    either package, loads through the other; a load under another program
    id is a miss."""
    port_rs, ref_rs, pid = rulesets("merged")
    ref_art, _ = rstore.get_or_compile(ref_rs, cache_dir=str(tmp_path / "ref"), program_id=pid)
    art, _ = pstore.get_or_compile(port_rs, cache_dir=str(tmp_path / "port"), program_id=pid)
    assert art.digest == ref_art.digest
    assert pstore.load_artifact(rstore.program_cache_dir(str(tmp_path / "ref"), pid),
                                art.digest, program_id=pid) is not None
    assert rstore.load_artifact(pstore.program_cache_dir(str(tmp_path / "port"), pid),
                                art.digest, program_id=pid) is not None
    assert pstore.load_artifact(pstore.program_cache_dir(str(tmp_path / "port"), pid),
                                art.digest, program_id="secret") is None


COMPILERS = {
    "compile_rules": (nfa_mod, "compile_rules"),
    "build_probe_set": (probes_mod, "build_probe_set"),
    "build_gram_set": (grams_mod, "build_gram_set"),
    "build_rule_stack": (nfa_device_mod, "build_rule_stack"),
    "device.build_probe_set": (device_mod, "build_probe_set"),
    "device.build_gram_set": (device_mod, "build_gram_set"),
    "hybrid.build_probe_set": (hybrid_mod, "build_probe_set"),
    "hybrid.build_gram_set": (hybrid_mod, "build_gram_set"),
}


@pytest.fixture
def compile_calls(monkeypatch):
    """Calls of every compiler a cold start runs, wherever it is bound."""
    calls = dict.fromkeys(COMPILERS, 0)

    def counting(key, real):
        def wrapped(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)

        return wrapped

    for key, (module, attr) in COMPILERS.items():
        monkeypatch.setattr(module, attr, counting(key, getattr(module, attr)))
    return calls


@pytest.mark.parametrize("backend", ["auto", "device", "native"])
def test_warm_start_makes_no_compile(backend, compile_calls, tmp_path):
    kw = dict(tile_len=TILE, max_batch_tiles=CAP) if backend == "device" else {}
    cache = str(tmp_path)
    cold = make_secret_engine(backend=backend, device="cpu", rules_cache_dir=cache, **kw)
    after_cold = dict(compile_calls)
    assert after_cold["compile_rules"] == after_cold["build_rule_stack"] == 1
    assert after_cold["build_probe_set"] == after_cold["build_gram_set"] == 1
    warm = make_secret_engine(backend=backend, device="cpu", rules_cache_dir=cache, **kw)
    assert compile_calls == after_cold, "the warm start compiled something"
    assert warm.ruleset_digest == cold.ruleset_digest == ruleset_digest(build_ruleset())
    plain = make_secret_engine(backend=backend, device="cpu", **kw)
    assert findings_fingerprint(warm, CORPUS) == findings_fingerprint(plain, CORPUS)


def test_program_engine_warm_start_makes_no_compile(compile_calls, tmp_path):
    cache = str(tmp_path)
    items = [("LICENSE", b"Permission is hereby granted, free of charge, to any person"),
             ("a.env", b"t = ghp_" + b"Ab1" * 12 + b"\n")]
    cold = programs.make_program_engine(device="cpu", rules_cache_dir=cache)
    after_cold = dict(compile_calls)
    assert after_cold["compile_rules"] == 3  # the merged table and its two programs
    warm = programs.make_program_engine(device="cpu", rules_cache_dir=cache)
    assert compile_calls == after_cold, "the warm start compiled something"
    assert isinstance(warm, GpuSecretEngine) and warm.sieve == "native"
    got, want = warm.scan_programs(items), cold.scan_programs(items)
    assert [[f.name for f in fs] for fs in got["license"]] == [
        [f.name for f in fs] for fs in want["license"]]
    assert [s.findings for s in got["secret"]] == [s.findings for s in want["secret"]]
    assert got["secret"][1].findings


def _small_ruleset() -> RuleSet:
    full = build_ruleset()
    return RuleSet(rules=full.rules[:12], allow_rules=full.allow_rules)


def _rewrite(art_dir: Path, manifest=None, arrays=None, raw=None) -> None:
    """Rewrite a stored artifact as a tamperer would: edit the manifest,
    and/or edit the arrays or replace the npz bytes outright and recompute
    the manifest's npz checksum and size to match."""
    mpath, npath = art_dir / "manifest.json", art_dir / "artifact.npz"
    m = json.loads(mpath.read_text())
    if arrays is not None:
        with np.load(npath) as z:
            data = {k: z[k] for k in z.files}
        arrays(data)
        buf = io.BytesIO()
        np.savez_compressed(buf, **data)
        raw = buf.getvalue()
    if raw is not None:
        npath.write_bytes(raw)
        m["npz_sha256"] = hashlib.sha256(raw).hexdigest()
        m["npz_bytes"] = len(raw)
    if manifest is not None:
        manifest(m)
    mpath.write_text(json.dumps(m))


def _truncate(art_dir: Path) -> None:
    npath = art_dir / "artifact.npz"
    npath.write_bytes(npath.read_bytes()[:100])


def _flip_class_map(d):
    cm = d["link_class_map"].copy()
    cm[ord("a")], cm[ord("b")] = cm[ord("b")], cm[ord("a")] + 1
    d["link_class_map"] = cm


def _vstack_two(d):
    f = d["vstack_follow"].copy()
    f[0, 0, 0] = 2
    d["vstack_follow"] = f


def _vstack_nul_live(d):
    a = d["vstack_accept_b"].copy()
    a[int(np.flatnonzero(d["vstack_has"])[0]), 0, 0] = 1
    d["vstack_accept_b"] = a


# case -> (rewrite, what the warning says)
TAMPER = {
    "truncated-npz": (_truncate, "bytes, manifest says"),
    "corrupt-npz": (dict(raw=b"PK\x03\x04 not a zip archive"), "unusable"),
    "foreign-digest": (dict(manifest=lambda m: m.update(ruleset_digest="0" * 64)),
                       "does not match directory"),
    "schema": (dict(manifest=lambda m: m.update(schema_version=2)), "store schema"),
    "version": (dict(manifest=lambda m: m.update(trivy_tpu_version="0.0.9")),
                "built by trivy-tpu"),
    "torch-version": (dict(manifest=lambda m: m.update(torch_version="0.0.1")),
                      "built against torch"),
    "class-map": (dict(arrays=_flip_class_map), "class map does not match"),
    "vstack-non-indicator": (dict(arrays=_vstack_two), "non-indicator"),
    "vstack-nul-accepts": (dict(arrays=_vstack_nul_live), "byte 0x00 live"),
    "shape": (dict(manifest=lambda m: m["shapes"].update(gset_masks=[1])), "manifest says"),
}


@pytest.mark.parametrize("case", [*TAMPER, "fault", "program-id"])
def test_rejected_artifact_recompiles(case, tmp_path, caplog, compile_calls):
    rs = _small_ruleset()
    cache = str(tmp_path)
    good, source = pstore.get_or_compile(rs, cache_dir=cache)
    assert source == "cold"
    art_dir = tmp_path / good.digest
    pid = "secret"
    if case in TAMPER:
        rewrite, reason = TAMPER[case]
        if callable(rewrite):
            rewrite(art_dir)
        else:
            _rewrite(art_dir, **rewrite)
    elif case == "fault":
        faults.configure("registry.load:corrupt@1")
        reason = "injected corruption"
    else:  # a secret artifact where a license one is looked up
        pid, reason = "license", "caller wants 'license'"
        cache = str(tmp_path / "elsewhere")
        pdir = Path(pstore.program_cache_dir(cache, pid))
        pdir.mkdir(parents=True)
        os.replace(art_dir, pdir / good.digest)
    calls = compile_calls["compile_rules"]
    try:
        with caplog.at_level(logging.WARNING, logger="trivy_tpu_torch.registry"):
            assert pstore.load_artifact(pstore.program_cache_dir(cache, pid), good.digest,
                                        program_id=pid) is None
            again, source = pstore.get_or_compile(rs, cache_dir=cache, program_id=pid)
    finally:
        faults.clear()
    assert source == "cold" and compile_calls["compile_rules"] == calls + 1
    assert "falling back to a fresh compile" in caplog.text and reason in caplog.text
    ga, wa = pstore._pack_arrays(again), pstore._pack_arrays(good)
    assert all(np.array_equal(ga[k], wa[k]) for k in wa)
    # the fresh compile was stored back and now loads
    assert pstore.load_artifact(pstore.program_cache_dir(cache, pid), good.digest,
                                program_id=pid) is not None


def test_load_without_version_pins_and_listing(tmp_path):
    rs = _small_ruleset()
    art, _ = pstore.get_or_compile(rs, cache_dir=str(tmp_path))
    _rewrite(tmp_path / art.digest, manifest=lambda m: m.update(trivy_tpu_version="9"))
    assert pstore.load_artifact(str(tmp_path), art.digest) is None
    assert pstore.load_artifact(str(tmp_path), art.digest, strict_versions=False) is not None
    (tmp_path / "junk").mkdir()
    listing = pstore.list_artifacts(str(tmp_path))
    by = {e["digest"]: e for e in listing}
    assert by[art.digest]["valid"] and by[art.digest]["num_rules"] == 12
    assert by[art.digest]["torch_version"] and not by["junk"]["valid"]
    assert pstore.artifact_device_bytes(art) == pstore.artifact_device_bytes(
        pstore.load_artifact(str(tmp_path), art.digest, strict_versions=False))
    pstore.save_ruleset_source(str(tmp_path), art.digest, "")
    assert pstore.load_ruleset_source(str(tmp_path), art.digest) is None  # builtin != 12 rules
    full = ruleset_digest(build_ruleset())
    pstore.save_ruleset_source(str(tmp_path), full, "")
    assert ruleset_digest(pstore.load_ruleset_source(str(tmp_path), full)) == full


def test_resolve_rules_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(tmp_path))
    assert pstore.default_cache_dir() == rstore.default_cache_dir() == str(tmp_path)
    assert pstore.resolve_rules_cache_dir("") == str(tmp_path)
    for off in ("off", "none", "0", "-", " OFF "):
        assert pstore.resolve_rules_cache_dir(off) is None
    assert pstore.resolve_rules_cache_dir("/x/y") == "/x/y"
    monkeypatch.delenv("TRIVY_TPU_RULES_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert pstore.default_cache_dir() == rstore.default_cache_dir() == str(
        tmp_path / "trivy-tpu" / "rulesets")


# -- the executable cache ---------------------------------------------------


def test_native_library_cache(tmp_path):
    """The g++ library: built once, a warm load compiles nothing, and a
    flipped byte, a compiler-version mismatch and a target mismatch are
    rejected and rebuilt, never handed to ctypes."""
    aotcache.reset_stats()
    lib = loader.build(tmp_path)
    assert aotcache.stats() == {"compiles": 1, "hits": 0, "misses": 1, "rejects": 0}
    assert lib.parent == tmp_path and lib.name.startswith("libtrivytorch-native-")
    good = lib.read_bytes()
    man = json.loads(aotcache.manifest_path(lib).read_text())
    assert man["kind"] == "g++" and man["compiler"] == loader.gxx_version()
    assert man["target"].startswith("cpu-") and man["nbytes"] == len(good)
    aotcache.reset_stats()
    assert loader.build(tmp_path) == lib
    assert aotcache.stats() == {"compiles": 0, "hits": 1, "misses": 0, "rejects": 0}

    def flip(path):
        blob = bytearray(path.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        path.write_bytes(bytes(blob))

    def edit(field):
        def run(path):
            mpath = aotcache.manifest_path(path)
            m = json.loads(mpath.read_text())
            m[field] = m[field] + "-other"
            mpath.write_text(json.dumps(m))
        return run

    for tamper in (flip, edit("compiler"), edit("target")):
        tamper(lib)
        aotcache.reset_stats()
        assert loader.build(tmp_path) == lib
        assert aotcache.stats() == {"compiles": 1, "hits": 0, "misses": 0, "rejects": 1}
        rebuilt = json.loads(aotcache.manifest_path(lib).read_text())
        assert all(rebuilt[k] == man[k] for k in aotcache.KEY_FIELDS)
        assert rebuilt["nbytes"] == lib.stat().st_size
        aotcache.reset_stats()
        assert loader.build(tmp_path) == lib and aotcache.stats()["hits"] == 1
    assert hasattr(ctypes.CDLL(str(lib)), "gram_sieve_scan_files")


def _fake_build(text: str, fail: bool = False):
    def start(out: Path):
        if not fail:
            out.write_bytes(text.encode())

        def wait() -> str:
            if fail:
                raise RuntimeError("fake compiler failed")
            return "log " + text

        return wait

    return start


def test_cache_directory_that_cannot_be_written(tmp_path):
    """The build goes to a temporary directory and the next start builds
    again; nothing is stored."""
    (tmp_path / "file").write_text("")
    lib = tmp_path / "file" / "sub" / "libx-0.so"
    key = aotcache.make_key(kind="test", compiler="c1", target="t", digest="0")
    aotcache.reset_stats()
    got = aotcache.get_or_compile(lib, key, _fake_build("v1"))
    assert got != lib and got.read_text() == "v1"
    got2 = aotcache.get_or_compile(lib, key, _fake_build("v2"))
    assert got2.read_text() == "v2" and aotcache.stats()["compiles"] == 2


def test_failed_build_raises_after_every_build_ended(tmp_path):
    key = aotcache.make_key(kind="test", compiler="c1", target="t", digest="0")
    with pytest.raises(RuntimeError, match="fake compiler failed"):
        aotcache.get_or_compile_many({
            "a": (tmp_path / "liba-0.so", key, _fake_build("a", fail=True)),
            "b": (tmp_path / "libb-0.so", key, _fake_build("b")),
        })
    assert not (tmp_path / "liba-0.so").exists()
    assert aotcache.load_executable(tmp_path / "libb-0.so", key) == tmp_path / "libb-0.so"
    assert not list(tmp_path.glob("*.tmp"))


FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "nvcc: fake, release {release}"; exit 0; fi
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'"
echo "ptxas info    : Used 40 registers, 16 bytes smem"
echo "ptxas info    : 8 bytes spill stores, 4 bytes spill loads"
if [ -n "{fail}" ]; then echo "error: {fail}"; exit 1; fi
printf 'fake library %s' "$*" > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc (a shell script) and an empty executable cache."""
    script = tmp_path / "nvcc"

    def install(release="12.4", fail=""):
        script.write_text(FAKE_NVCC.format(release=release, fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        _build.nvcc_version.cache_clear()

    install()
    monkeypatch.setattr(_build, "nvcc", lambda: str(script))
    monkeypatch.setenv("TRIVY_TPU_AOT_CACHE", str(tmp_path / "cache"))
    yield install
    _build.nvcc_version.cache_clear()


def test_nvcc_libraries_through_the_cache(fake_nvcc, tmp_path):
    names = ["gram_sieve", "nfa_verify"]
    aotcache.reset_stats()
    libs = _build.build_all(names)
    assert aotcache.stats() == {"compiles": 2, "hits": 0, "misses": 2, "rejects": 0}
    for name, lib in libs.items():
        assert lib == _build._library_path(name) and lib.parent == tmp_path / "cache"
        m = json.loads(aotcache.manifest_path(lib).read_text())
        assert (m["kind"], m["target"], m["compiler"]) == ("nvcc", "sm_90a",
                                                         "nvcc: fake, release 12.4")
        assert m["digest"] in lib.name and "-gencode" in lib.read_text()
    assert _build.resources("nfa_verify") == [{"kernel": "_Z6kernelv", "registers": 40,
                                               "smem_bytes": 16, "spill_bytes": 12}]
    aotcache.reset_stats()
    assert _build.build_all(names) == libs
    assert aotcache.stats() == {"compiles": 0, "hits": 2, "misses": 0, "rejects": 0}
    # a flipped byte and a target mismatch are rejected and rebuilt
    blob = bytearray(libs["gram_sieve"].read_bytes())
    blob[0] ^= 0xFF
    libs["gram_sieve"].write_bytes(bytes(blob))
    mpath = aotcache.manifest_path(libs["nfa_verify"])
    mpath.write_text(json.dumps(dict(json.loads(mpath.read_text()), target="sm_80")))
    aotcache.reset_stats()
    assert _build.build_all(names) == libs
    assert aotcache.stats() == {"compiles": 2, "hits": 0, "misses": 0, "rejects": 2}
    # another nvcc: every library is rejected and rebuilt under its version
    fake_nvcc(release="12.8")
    aotcache.reset_stats()
    _build.build_all(names)
    assert aotcache.stats()["rejects"] == 2 and aotcache.stats()["compiles"] == 2
    assert "12.8" in json.loads(mpath.read_text())["compiler"]
    # a failed build raises with the compiler's output
    fake_nvcc(release="13.0", fail="bad kernel")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all(["gram_sieve"])


# -- the CLI -----------------------------------------------------------------


def test_rules_cli_compile_ls_verify_push(tmp_path, capsys):
    cache = str(tmp_path)
    assert cli.main(["rules", "verify", "--rules-cache-dir", cache, "--device", "cpu"]) == 1
    assert "no loadable artifact" in capsys.readouterr().err
    assert cli.main(["rules", "ls", "--rules-cache-dir", cache]) == 0
    assert "no cached rulesets" in capsys.readouterr().out
    assert cli.main(["rules", "compile", "--rules-cache-dir", cache, "--secret-config", CONFIG,
                     "--device", "cpu", "--warmup"]) == 0
    out = capsys.readouterr().out
    digest = ruleset_digest(build_ruleset(load_config(CONFIG)))
    assert out.startswith(f"{digest}  cold") and "aot: libraries ['native']" in out
    assert cli.main(["rules", "compile", "--rules-cache-dir", cache, "--secret-config",
                     CONFIG]) == 0
    assert capsys.readouterr().out.startswith(f"{digest}  warm")
    assert cli.main(["rules", "ls", "--rules-cache-dir", cache]) == 0
    out = capsys.readouterr().out
    assert digest[:16] in out and "torch" in out
    assert cli.main(["rules", "verify", "--rules-cache-dir", cache, "--secret-config", CONFIG,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "verify OK" in out and "FAIL" not in out and "vstack_accept_b" in out
    # push needs a server (tests/test_torch_rules_push.py drives one)
    assert cli.main(["rules", "push", "--rules-cache-dir", cache]) == 2
    assert "--server is required" in capsys.readouterr().err
    assert cli.main(["rules"]) == 2


def test_fs_rules_cache_dir_warm_equals_cold(tmp_path, capsys):
    tree = tmp_path / "tree"
    for name, body in CORPUS:
        (tree / "src").mkdir(parents=True, exist_ok=True)
        (tree / "src" / name.replace("/", "_")).write_bytes(body)
    cache = tmp_path / "rules"
    reports = []
    for flag in ("off", str(cache), str(cache)):
        assert cli.main(["fs", "--format", "json", "--device", "cpu", "--rules-cache-dir", flag,
                         str(tree)]) == 0
        reports.append(capsys.readouterr().out)
        if flag == "off":
            assert not cache.exists()
    assert reports[0] == reports[1] == reports[2] and '"Results"' in reports[0]
    assert (cache / ruleset_digest(build_ruleset()) / "manifest.json").exists()
