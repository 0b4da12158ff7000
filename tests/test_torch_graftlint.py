"""The port's copies of the serving path's packages stay lint-clean.

`tools.graftlint` over `trivy_tpu_torch/{serve,tenancy,rpc,obs,cache}`
with no waiver ledger: the lock-owner annotations (`# owner: _lock`,
`# graftlint: owner(serve-batcher)`, `holds(_lock)`) the copies carry from
the reference must still be true after the rewrite to the port's imports.
"""

import os

from tools.graftlint import lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("serve", "tenancy", "rpc", "obs", "cache")


def test_serving_copies_are_lint_clean_without_waivers():
    paths = [os.path.join(REPO, "trivy_tpu_torch", p) for p in PACKAGES]
    findings, errors = lint_paths(paths, REPO, waivers=None)
    assert errors == []
    assert [f.render() for f in findings] == []
    # the copies kept their ownership annotations
    with open(os.path.join(REPO, "trivy_tpu_torch", "serve", "scheduler.py")) as f:
        src = f.read()
    assert "# graftlint: owner(serve-batcher)" in src and "# owner: _lock" in src
