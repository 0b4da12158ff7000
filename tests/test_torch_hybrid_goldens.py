"""The reference scanner's 34 golden cases (tests/parity/expected.json)
through the port's hybrid engine (`GpuHybridSecretEngine(device="cpu")`),
per config, in each verify mode: fused (`scan_batch`), the legacy stream
(`scan_batch_device_legacy`) and the host DFA (`scan_batch_host`), the
same three rungs of one engine that the reference's `HybridSecretEngine`
has.  Per config the port's fingerprint in each mode equals the reference
oracle's and the port's own dfa result, and each case's findings equal the
golden SecretFinding structs.  The reference's hybrid engine itself is
held to the port on the golden inputs once, in its fused mode, with the
builtin ruleset (its modes agree with each other and with its oracle by
its own tests).  Tolerance: exact.
"""

import os

import pytest
import torch

from test_torch_engine import fingerprint, oracle_fingerprint
from test_torch_goldens import CASES, CONFIGS, EXPECTED, PAR, _items
from trivy_tpu.engine.hybrid import HybridSecretEngine
from trivy_tpu.rules.model import build_ruleset as ref_build_ruleset
from trivy_tpu.rules.model import load_config as ref_load_config
from trivy_tpu_torch.engine.hybrid import GpuHybridSecretEngine
from trivy_tpu_torch.rules.model import build_ruleset, load_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions step small tensors, and the
    suite's workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rungs(engine):
    return {"dfa": engine.scan_batch_host, "fused": engine.scan_batch,
            "device": engine.scan_batch_device_legacy}


def _golden(case, got) -> None:
    want = [EXPECTED["findings"][n] for n in case["want_findings"]]
    assert got.file_path == case["want_filepath"]
    assert [(f.rule_id, f.severity, f.start_line, f.end_line, f.match)
            for f in got.findings] == [
        (w["RuleID"], w["Severity"], w["StartLine"], w["EndLine"], w["Match"])
        for w in want]


@pytest.mark.parametrize("config", CONFIGS)
def test_hybrid_matches_goldens_reference_and_oracle(config):
    cases = [c for c in CASES if c["config"] == config]
    items = _items(cases)
    path = os.path.join(PAR, "configs", config)
    port = GpuHybridSecretEngine(ruleset=build_ruleset(load_config(path)),
                                 device="cpu", verify="fused")
    oracle = oracle_fingerprint(items, ref_build_ruleset(ref_load_config(path)))
    fps = {}
    for mode, scan in _rungs(port).items():
        got = scan(items)
        fps[mode] = fingerprint(got)
        for case, res in zip(cases, got):
            _golden(case, res)
    assert fps["dfa"] == oracle
    assert fps["fused"] == fps["device"] == fps["dfa"]
    assert port._nfa_verifier.fused is True


def test_hybrid_on_golden_inputs_equals_reference_hybrid(monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FUSED_SCAN", "seq")
    items = _items(CASES)
    port = GpuHybridSecretEngine(device="cpu", verify="fused")
    ref = HybridSecretEngine(verify="fused")
    pairs0 = ref.stats.device_pairs
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items))
    assert got == oracle_fingerprint(items, ref_build_ruleset(None))
    assert port.stats.device_pairs == ref.stats.device_pairs - pairs0 > 0
