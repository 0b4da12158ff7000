"""The port's claim-killer (`trivy_tpu_torch/engine/redfa.py` `DfaVerifier`
and its C walk, `trivy_tpu_torch/native/dfa_verify.cpp`) against the JAX
package's, and the engine's verified candidates against the reference
engine's.

* The verifier's per-rule tables (mode, byte-class LUTs, DFA transition and
  accept blobs, NFA-64 follow/class masks, offsets, start sets, walk
  bounds) equal the reference's for the builtin ruleset and for parity
  configs with custom rules.
* The C walk, through both entry points (packed stream and per-file
  pointers), equals its plain version `_python_walk` and the reference's
  `verify_pairs_files` on every (file, rule) pair of `VERIFY_CORPUS` plus
  the hostile corpus: every candidate pair and every other pair too.
* With the verifier on, `GpuSecretEngine(device="cpu")`'s verified
  candidate matrix and `candidate_pairs` equal the reference
  `TpuSecretEngine(kernel="pallas", fused=True, megakernel=False)`'s in
  codec modes off/auto/4/6, and its findings equal the reference's and
  `OracleScanner`'s; on the megakernel path too (mode off against the
  reference megakernel, coded modes against the reference staged engine,
  since the reference megakernel has no coded-mode CPU run, ROADMAP C1).

Tolerance: exact (verdict bits, table bytes, boolean matrices).
"""

import ctypes
import os

import numpy as np
import pytest

from test_torch_engine import TILE, fingerprint, hostile_corpus, oracle_fingerprint
from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu.engine.redfa import DfaVerifier as RefDfaVerifier
from trivy_tpu.rules.model import build_ruleset as ref_build_ruleset
from trivy_tpu.rules.model import load_config as ref_load_config
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.redfa import MODE_DFA, MODE_NFA, DfaVerifier
from trivy_tpu_torch.ftypes import VERIFY_CORPUS
from trivy_tpu_torch.rules.model import build_ruleset, load_config

PAR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parity", "configs")
# Parity configs whose rules differ from the builtin set (custom rules,
# disabled rules, keyword and allow changes).
CONFIGS = [None, "config.yaml", "multiple-secret-groups.yaml", "config-disable-ghp.yaml"]
TABLES = (
    "mode", "n_classes", "luts", "trans_blob", "trans_off", "accept_blob",
    "accept_off", "follow_blob", "follow_off", "cmask_blob", "cmask_off",
    "nfa_first", "nfa_last", "start_ok", "start_bytes", "start_nbytes",
    "prefix_bound",
)


def _rulesets(config):
    if config is None:
        return build_ruleset(None), ref_build_ruleset(None)
    path = os.path.join(PAR, config)
    return build_ruleset(load_config(path)), ref_build_ruleset(ref_load_config(path))


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c or "builtin")
def test_verifier_tables_equal_reference(config):
    port_rules, ref_rules = _rulesets(config)
    port = DfaVerifier(port_rules.rules)
    ref = RefDfaVerifier(ref_rules.rules)
    assert port.num_rules == ref.num_rules and port.compiled == ref.compiled > 0
    for name in TABLES:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # both automaton kinds are exercised
    assert (port.mode == MODE_DFA).any() and (port.mode == MODE_NFA).any()


def _corpus():
    items = list(VERIFY_CORPUS) + hostile_corpus(42, TILE)
    return [c for _, c in items]


def test_c_walk_equals_python_walk_and_reference():
    rules = build_ruleset(None).rules
    port = DfaVerifier(rules)
    ref = RefDfaVerifier(ref_build_ruleset(None).rules)
    contents = _corpus()
    f, r = len(contents), port.num_rules
    pf, pr = (a.ravel().astype(np.int32) for a in np.meshgrid(
        np.arange(f), np.arange(r), indexing="ij"))
    lens = np.array([len(c) for c in contents], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    stream = np.frombuffer(b"".join(contents), np.uint8)
    ptrs = (ctypes.c_char_p * f)(*contents)

    c_stream = port.verify_pairs(stream, starts, lens, pf, pr)
    c_files = port.verify_pairs_files(ptrs, lens, pf, pr)
    plain = np.ones(len(pf), np.uint8)
    port._python_walk(stream, starts, lens, pf, pr, None, None, plain, len(pf))
    want = ref.verify_pairs_files(ptrs, lens, pf, pr)
    np.testing.assert_array_equal(c_stream, plain)
    np.testing.assert_array_equal(c_files, plain)
    np.testing.assert_array_equal(plain, want)
    # the walk both refutes and confirms on this corpus
    assert 0 < plain.sum() < len(plain)


def _verified(engine, items):
    contents = [c for _, c in items]
    cand = engine._candidates(contents)
    return cand, engine._verify_candidates(items, cand)


def _distinct(items):
    seen, out = set(), []
    for p, c in items:
        if c not in seen:
            seen.add(c)
            out.append((p, c))
    return out


@pytest.mark.parametrize("mode", ["off", "auto", "4", "6"])
def test_engine_verified_candidates_match_reference(mode, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
    items = list(VERIFY_CORPUS) + hostile_corpus(42, TILE)
    ref = TpuSecretEngine(kernel="pallas", fused=True, megakernel=False, tile_len=TILE)
    port = GpuSecretEngine(device="cpu", tile_len=TILE)
    distinct = _distinct(items)
    port_cand, port_ver = _verified(port, distinct)
    ref_cand, ref_ver = _verified(ref, distinct)
    np.testing.assert_array_equal(port_cand, ref_cand)
    np.testing.assert_array_equal(port_ver, ref_ver)
    assert port_ver.sum() < port_cand.sum()  # the claim-killer refuted pairs

    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items)) == oracle_fingerprint(items)
    assert port.stats.candidate_pairs == ref.stats.candidate_pairs > 0
    assert port.stats.verify_s > 0 and "verify_s" in port.stats.phases()


@pytest.mark.parametrize("mode", ["off", "auto", "4", "6"])
def test_megakernel_engine_verified_candidates_match_reference(mode, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
    items = list(VERIFY_CORPUS) + hostile_corpus(42, TILE)
    cap = 64
    port = GpuSecretEngine(device="cpu", tile_len=TILE, max_batch_tiles=cap,
                           megakernel=True)
    ref = TpuSecretEngine(kernel="pallas", fused=True, tile_len=TILE,
                          max_batch_tiles=cap, megakernel=mode == "off")
    assert port.megakernel_active and ref.megakernel_active == (mode == "off")
    distinct = _distinct(items)
    port_cand, port_ver = _verified(port, distinct)
    ref_cand, ref_ver = _verified(ref, distinct)
    assert port.stats.device_dispatches == 1
    assert port.stats.d2h_bytes < port.stats.d2h_bytes_raw  # the packed mask
    np.testing.assert_array_equal(port_cand, ref_cand)
    np.testing.assert_array_equal(port_ver, ref_ver)
    assert port_ver.sum() < port_cand.sum()

    got = fingerprint(port.scan_batch(items))
    assert got == oracle_fingerprint(items)
    assert got == fingerprint(ref.scan_batch(items))
    assert port.stats.candidate_pairs == ref.stats.candidate_pairs > 0
