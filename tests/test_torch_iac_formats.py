"""`config` through the port's CLI (`python -m trivy_tpu_torch config`)
against the reference CLI (`trivy_tpu.cli.main`), both in this process, on
the CPU (`--device cpu`), whole reports equal:

* the reference's own `config` tests (`tests/test_iac_formats.py`:
  CloudFormation, terraform modules local and from a `terraform init`
  manifest, caller expressions, multi-file children, tfvars and their
  precedence, `--trace`; `tests/test_helm.py`: a chart's KSV checks) run
  with `trivy_tpu.cli.main` replaced by both CLIs on the same arguments;
  their assertions hold on the reference's report, and the port's report
  equals it;
* a tree of every format the config analyzers claim
  (`trivy_tpu_torch/iac/fixtures.py` `iac_tree`: Terraform root modules
  with tfvars and a child module, single- and multi-document manifests,
  Dockerfiles, CloudFormation YAML and JSON, Helm charts, ARM JSON and
  TOML) under `-f json`, `--include-non-failures`, `--trace`,
  `--config-check DIR` (a custom TOML check), `-f table` and `-f sarif`;
* the planted checks of that tree in the port's report: each failing
  fixture reported on its file, no passing fixture reporting its check;
* `config` takes no other scanner, as the reference's, and an unparsable
  `--config-check` module is logged on each file, as in the reference.

Tolerance: exact.
"""

import contextlib
import inspect
import io
import json
import sys

import pytest

import test_helm as ref_helm_tests
import test_iac_formats as ref_fmt_tests
from trivy_tpu import cli as ref_cli
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.iac import fixtures

CLI_CASES = [
    f"{m.__name__}::{name}" for m in (ref_fmt_tests, ref_helm_tests) for name in sorted(vars(m))
    if name.startswith("test_")
    and "from trivy_tpu.cli import main" in inspect.getsource(getattr(m, name))
]


def _run(main, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv: list[str]) -> tuple[tuple, tuple]:
    """(port, reference) (rc, stdout, stderr) of one command line; the
    port's runs with `--device cpu` after the subcommand."""
    port = _run(cli.main, [argv[0], "--device", "cpu", *argv[1:]])
    ref = _run(ref_main, argv)
    return port, ref


ref_main = ref_cli.main


def assert_same(port: tuple, ref: tuple, argv: list[str]) -> None:
    assert port[0] == ref[0], (argv, port[2][-2000:], ref[2][-2000:])
    if "json" in argv or not any(a.startswith("-f") or a == "--format" for a in argv):
        # the reports the reference tests read are `--format json`
        got, want = (json.loads(port[1]), json.loads(ref[1])) if ref[1] else (port[1], ref[1])
        assert got == want, argv
    else:
        assert port[1] == ref[1], argv


@pytest.fixture(autouse=True)
def rules_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(tmp_path_factory.mktemp("rules")))


@pytest.mark.parametrize("case", CLI_CASES)
def test_reference_config_tests_hold_for_the_port(case, tmp_path, monkeypatch):
    """The reference test runs with `trivy_tpu.cli.main` answering from both
    CLIs: it reads the reference's output, and every call's port report
    equals the reference's."""
    mod_name, name = case.split("::")
    module = sys.modules[mod_name]
    calls = []

    def main(argv):
        argv = list(argv)
        port, ref = both(argv)
        calls.append((argv, port, ref))
        sys.stdout.write(ref[1])
        sys.stderr.write(ref[2])
        return ref[0]

    monkeypatch.setattr(ref_cli, "main", main)
    getattr(module, name)(tmp_path)
    assert calls
    for argv, port, ref in calls:
        assert_same(port, ref, argv)


@pytest.fixture(scope="module")
def format_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    files, planted = fixtures.iac_tree(tf_dirs=4, tf_files=5, manifests=10, dockerfiles=20,
                                       templates=16, charts=4, configs=8)
    for path, body in files.items():
        full = root / path
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_bytes(body)
    checks = root.parent / (root.name + "-checks")
    checks.mkdir()
    (checks / "telnet.rego").write_text(fixtures.TOML_CHECK)
    return root, checks, planted


@pytest.mark.parametrize("flags", [
    ["-f", "json"], ["-f", "json", "--include-non-failures"], ["-f", "json", "--trace"],
    ["-f", "json", "--config-check", "CHECKS"], ["-f", "table"], ["-f", "sarif"],
    ["-f", "json", "--scanners", "secret"],
], ids=["json", "include-non-failures", "trace", "config-check", "table", "sarif",
        "scanners-ignored"])
def test_config_reports_equal(format_tree, flags):
    root, checks, _ = format_tree
    argv = ["config", *[str(checks) if f == "CHECKS" else f for f in flags], str(root)]
    port, ref = both(argv)
    assert port[0] == ref[0] == 0, (port[2][-2000:], ref[2][-2000:])
    assert_same(port, ref, argv)
    if "json" in flags:
        doc = json.loads(port[1])
        assert doc["Results"] and all(r["Class"] == "config" for r in doc["Results"])
        traced = any(m.get("Traces") for r in doc["Results"]
                     for m in r.get("Misconfigurations", []))
        assert traced == ("--trace" in flags)


def test_planted_checks_in_the_report(format_tree):
    """Each planted failing fixture is reported on its file, and no passing
    one reports its check (`--config-check` reads the TOML files)."""
    root, checks, planted = format_tree
    port, _ = both(["config", "-f", "json", "--config-check", str(checks), str(root)])
    fails = {(r["Target"], m["ID"]) for r in json.loads(port[1])["Results"]
             for m in r.get("Misconfigurations", []) if m["Status"] == "FAIL"}
    kinds = set()
    for path, checks_planted in planted.items():
        for check_id, failing in checks_planted:
            assert ((path, check_id) in fails) == failing, (path, check_id)
            kinds.add(path.split("/")[0])
    assert kinds == {"tf", "k8s", "docker", "cfn", "helm", "config"}


def test_unparsable_custom_check_is_logged_per_file(tmp_path):
    """A `--config-check` module that does not parse fails each file's
    analysis, which both CLIs log and scan on past (the analyzers'
    per-file tolerance): the same exit code and report."""
    checks = tmp_path / "checks"
    checks.mkdir()
    (checks / "bad.rego").write_text("package user.dockerfile.bad\ndeny[m] { input.x == \n")
    (tmp_path / "Dockerfile").write_text("FROM alpine:3.19\n")
    argv = ["config", "-f", "json", "--config-check", str(checks), str(tmp_path)]
    port, ref = both(argv)
    assert port[0] == ref[0] == 0
    assert_same(port, ref, argv)
    for _, _, err in (port, ref):
        assert "analyzer dockerfile failed on Dockerfile" in err and "RegoError" in err
