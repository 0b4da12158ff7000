"""The reference scanner's 34 golden cases (tests/parity/expected.json) through
`GpuSecretEngine(device="cpu")`, each config loaded by the port's own
`load_config`.

Per case the port's findings equal the golden SecretFinding structs; per
config its fingerprint equals the JAX package's staged fused engine
(`TpuSecretEngine(kernel="pallas", fused=True, megakernel=False)`, Pallas in
interpret mode) and its `OracleScanner`, and the candidate pairs its
claim-killer leaves for the confirm equal the reference's.  Tolerance:
exact.
"""

import json
import os

import pytest

from test_torch_engine import TILE, fingerprint, oracle_fingerprint
from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu.rules.model import build_ruleset as ref_build_ruleset
from trivy_tpu.rules.model import load_config as ref_load_config
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.rules.model import build_ruleset, load_config

PAR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parity")
with open(os.path.join(PAR, "expected.json"), encoding="utf-8") as f:
    EXPECTED = json.load(f)
CASES = EXPECTED["cases"]
CONFIGS = sorted({c["config"] for c in CASES})
# Small batches: one 64-row bucket keeps the interpret-mode kernel cheap.
MAX_ROWS = 64

_PORT: dict = {}


def _port_engine(config: str) -> GpuSecretEngine:
    if config not in _PORT:
        cfg = load_config(os.path.join(PAR, "configs", config))
        assert cfg is not None, config
        _PORT[config] = GpuSecretEngine(ruleset=build_ruleset(cfg), device="cpu",
                                        tile_len=TILE, max_batch_tiles=MAX_ROWS)
    return _PORT[config]


def _items(cases) -> list[tuple[str, bytes]]:
    out = []
    for c in cases:
        with open(os.path.join(PAR, "fixtures", c["input"]), "rb") as f:
            out.append(("testdata/" + c["input"], f.read().replace(b"\r", b"")))
    return out


@pytest.mark.parametrize("case", CASES, ids=[f"{c['name']}::{c['config']}" for c in CASES])
def test_port_matches_golden_findings(case):
    [got] = _port_engine(case["config"]).scan_batch(_items([case]))
    assert got.file_path == case["want_filepath"]
    want = [EXPECTED["findings"][n] for n in case["want_findings"]]
    assert [
        (f.rule_id, f.category, f.title, f.severity, f.start_line, f.end_line, f.match,
         [(ln.number, ln.content, ln.is_cause) for ln in f.code.lines])
        for f in got.findings
    ] == [
        (w["RuleID"], w["Category"], w["Title"], w["Severity"], w["StartLine"],
         w["EndLine"], w["Match"], [(ln["Number"], ln["Content"], ln["IsCause"])
                                    for ln in w["Lines"]])
        for w in want
    ]


@pytest.mark.parametrize("config", CONFIGS)
def test_port_matches_reference_engine_and_oracle_per_config(config):
    items = _items([c for c in CASES if c["config"] == config])
    ref_rules = ref_build_ruleset(ref_load_config(os.path.join(PAR, "configs", config)))
    ref = TpuSecretEngine(ruleset=ref_rules, kernel="pallas", fused=True,
                          megakernel=False, tile_len=TILE, max_batch_tiles=MAX_ROWS)
    port = _port_engine(config)
    pairs = port.stats.candidate_pairs
    got = fingerprint(port.scan_batch(items))
    assert got == fingerprint(ref.scan_batch(items))
    assert got == oracle_fingerprint(items, ref_rules)
    # both engines run the claim-killer: the oracle sees the same pairs
    assert port.stats.candidate_pairs - pairs == ref.stats.candidate_pairs
