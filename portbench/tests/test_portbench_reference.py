"""The benchmark's plain reference against the port's oracle on the CPU.

The reference (`portbench/reference/secret_scan.py`) must not import the
port; this test may, and holds the two to the same answers on slices of both
trees and on every planted-secret shape, in the canonical form the benchmark
compares."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench.corpus import _near_miss, make_tree, planted_secret
from portbench.entries.secret import answer as program_answer
from portbench.reference.secret_scan import RULES_FILE, SecretScanner, go_regex
from trivy_tpu_torch.engine.oracle import OracleScanner

BENCH = Path(__file__).resolve().parents[1]


# A C source tree of the generator's `kernel` shape, which no cell uses yet.
KERNEL_SHAPE = {"shape": "kernel", "n_files": 80000, "size_median": 3000, "size_sigma": 1.0,
                "size_min": 64, "size_max": 262144, "sizes_seed": 7, "pool_seed": 7,
                "pool_bytes": 8388608, "planted_every": 900, "planted_offset": 1}


def traffic(name: str) -> dict:
    if name == "kernel-shape":
        return dict(KERNEL_SHAPE)
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def scanners():
    return SecretScanner(), OracleScanner()


@pytest.mark.parametrize("name,n,seed", [
    ("config-tree", 300, 2_147_483_659),
    ("kernel-shape", 400, 5),
    ("kernel-shape", 400, 3_200_000_016),
])
def test_reference_equals_the_oracle_on_tree_slices(scanners, name, n, seed):
    ref, oracle = scanners
    tree = make_tree(traffic(name), seed, stop=n)
    want = [program_answer(oracle.scan(p, c)) for p, c in tree]
    got = [ref.scan(p, c) for p, c in tree]
    assert got == want
    assert any(got), "the slice holds a planted secret"


def test_reference_equals_the_oracle_on_planted_shapes(scanners):
    ref, oracle = scanners
    rules = json.loads(RULES_FILE.read_text())["rules"]
    for seed in (3, 2_147_483_659):
        rng = np.random.default_rng(seed)
        for kind, rule in enumerate(rules):
            body = (b"x = 1\nname = value\n" + planted_secret(rng, kind)
                    + _near_miss(rng, kind) + b"tail line\n")
            for path in ("deploy/a.env", "src/test_a.py", "docs/readme.md"):
                want = program_answer(oracle.scan(path, body))
                assert ref.scan(path, body) == want, (rule["id"], path, body)
            found = ref.scan("deploy/a.env", body)
            assert found and rule["id"] in {f[0] for f in found[1]}, rule["id"]


@pytest.mark.parametrize("name", ["config-tree", "kernel-shape"])
def test_every_builtin_rule_is_planted_in_a_whole_tree(name):
    """The planted secrets cycle through the rules: a tree with as many
    planted files as rules holds every rule's true positive."""
    t = traffic(name)
    n_rules = len(json.loads(RULES_FILE.read_text())["rules"])
    assert t["n_files"] // t["planted_every"] >= n_rules
    t = {**t, "n_files": n_rules * 3, "planted_every": 3, "planted_offset": 1}
    ref = SecretScanner()
    found = {f[0] for p, c in make_tree(t, 11) for a in [ref.scan(p, c)] if a for f in a[1]}
    assert found >= {r["id"] for r in json.loads(RULES_FILE.read_text())["rules"]}


def test_reference_equals_the_oracle_on_censoring_and_order(scanners):
    ref, oracle = scanners
    body = (b'a = "ghp_' + b"A" * 36 + b'" b = "ghp_' + b"B" * 36 + b'"\n'
            + b"AWS_ACCESS_KEY_ID=AKIA" + b"C" * 16 + b"\n"
            + b"k = EXAMPLE AKIA" + b"D" * 16 + b" more\n" + b"x" * 150
            + b' token ghp_' + b"E" * 36 + b"\n")
    want = program_answer(oracle.scan("cfg/app.yaml", body))
    assert ref.scan("cfg/app.yaml", body) == want
    assert len(want[1]) >= 4


@pytest.mark.parametrize("go,py", [
    (r"(p8e-)(?i)[a-z0-9]{32}", r"(p8e-)(?i:[a-z0-9]{32})"),
    (r"a(b(?i)c)d", r"a(b(?i:c))d"),
    (r"x[.,]?(\s+|$)", r"x[.,]?([\t\n\f\r ]+|\Z)"),
    (r"(?m)^a$", r"(?m:^a$)"),
    (r"[\s\d]\w", r"[\t\n\f\r 0-9][0-9A-Za-z_]"),
    (r"(?P<secret>a)", r"(?P<secret>a)"),
])
def test_go_regex_translation(go, py):
    assert go_regex(go) == py


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.compare as c; "
            "from portbench.reference import secret_scan; import portbench.corpus; "
            "print(c.loaded(c.PROGRAM_MODULES))" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"
