"""The port's AWS account scan (`trivy_tpu_torch/cloud/`, `python -m
trivy_tpu_torch aws`) against the reference's (`trivy_tpu/cloud/`,
`trivy_tpu.cli.main`), both in this process.

On the reference test's endpoint (`tests/test_aws.py` `_FakeAws`) and on
`trivy_tpu_torch/cloud/fixtures.py`'s seeded account (20 resources of each
kind, half planted failing): each of the 18 services' results of both
packages, every planted failure found and no passing resource named by a
planted check; the exit codes of a degraded enumeration and of an
unsupported service; `-f json` and `-f table` byte-equal, stderr too,
with the log formatters' clock pinned (`torch_log_clock.py`: a log line
carries the wall clock's second, which two runs may not share); and the
process-global rego scanner reset (`aws` starts from the builtin checks).
No kernel runs: the scan is host Python.

Tolerance: exact.
"""

import contextlib
import io
import json
import threading
from http.server import ThreadingHTTPServer

import pytest

import test_aws as ref_aws
from torch_log_clock import frozen_log_clock  # noqa: F401
from trivy_tpu import cli as ref_cli
from trivy_tpu.cloud import aws as ref_aws_mod
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.cloud import aws
from trivy_tpu_torch.cloud import fixtures as cloudfx
from trivy_tpu_torch.iac.engine import configure_shared_scanner

CUSTOM_CHECK = """# METADATA
# title: Every resource document
# custom:
#   id: CUST902
#   severity: CRITICAL
package custom.terraform.CUST902

deny[res] {
    input.resource
    res := result.new("custom check fired", {})
}
"""


def _run(main, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv: list[str]) -> tuple[tuple, tuple]:
    return _run(cli.main, ["aws", *argv]), _run(ref_cli.main, ["aws", *argv])


@pytest.fixture(autouse=True)
def _creds(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.delenv("AWS_ENDPOINT_URL", raising=False)
    for var in ("TRIVY_TPU_FORMAT", "TRIVY_TPU_EXIT_CODE", "TRIVY_TPU_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def ref_endpoint():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), ref_aws._FakeAws)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def account():
    acct = cloudfx.seeded_account(20, seed=7)
    srv = cloudfx.serve_account(acct)
    yield {"account": acct, "endpoint": f"http://127.0.0.1:{srv.server_address[1]}"}
    srv.shutdown()
    srv.server_close()


def _scan(mod, services, endpoint) -> tuple[list, list]:
    scanner = mod.AwsScanner(services=list(services), endpoint=endpoint)
    return [mc.to_json() for mc in scanner.scan()], scanner.errors


@pytest.mark.parametrize("service", aws.SUPPORTED_SERVICES)
@pytest.mark.parametrize("where", ["reference", "seeded"])
def test_service_results_equal_the_reference(ref_endpoint, account, service, where):
    endpoint = ref_endpoint if where == "reference" else account["endpoint"]
    got = _scan(aws, [service], endpoint)
    assert got == _scan(ref_aws_mod, [service], endpoint)
    assert got[0] and got[0][0]["Failures"] and not got[1]


def test_seeded_account_plants_are_found(account):
    results, errors = _scan(aws, aws.SUPPORTED_SERVICES, account["endpoint"])
    assert not errors
    failures = [(f["ID"], f["Message"]) for mc in results for f in mc["Failures"]]
    check = cloudfx.planted_check(account["account"], failures)
    assert set(check) == set(aws.SUPPORTED_SERVICES)
    for service, c in check.items():
        planted = sum(len(cloudfx.EC2_KIND_CHECKS[r["kind"]]) if service == "ec2"
                      else len(cloudfx.PLANTED[service])
                      for r in account["account"][service] if r["fail"])
        assert c == {"found": planted, "missed": 0, "passing_named": []}, service


@pytest.mark.parametrize("fmt", ["json", "table"])
def test_cli_output_is_byte_equal(account, ref_endpoint, fmt, tmp_path):
    services = [a for s in aws.SUPPORTED_SERVICES for a in ("--service", s)]
    for endpoint in (account["endpoint"], ref_endpoint):
        argv = [*services, "--endpoint", endpoint, "-f", fmt, "--exit-code", "3"]
        (prc, pout, perr), (rrc, rout, rerr) = both(argv)
        assert prc == rrc == 3 and pout == rout and perr == rerr and pout
        assert _run(cli.main, ["aws", *argv, "-o", str(tmp_path / "o")])[0] == 3
        assert (tmp_path / "o").read_text() == pout


def test_degraded_enumeration_exit_codes(account, monkeypatch):
    """A 403 on one Describe call: the rest scans, the error is printed, and
    the run exits `--exit-code` or 2 (never a clean 0)."""
    for mod in (aws, ref_aws_mod):
        orig = mod._AwsApi.call

        def flaky(self, method, path_and_query, orig=orig, mod=mod):
            if "DescribeVolumes" in path_and_query:
                raise mod.AwsError("aws: GET DescribeVolumes: HTTP 403: AccessDenied")
            return orig(self, method, path_and_query)

        monkeypatch.setattr(mod._AwsApi, "call", flaky)
    for extra, rc in (([], 2), (["--exit-code", "5"], 5)):
        (prc, pout, perr), (rrc, rout, rerr) = both(
            ["--service", "ec2", "--endpoint", account["endpoint"], "-f", "json", *extra])
        assert (prc, rrc) == (rc, rc), (prc, rrc, perr, rerr)
        assert pout == rout
        assert perr == rerr, f"port stderr:\n{perr}\nreference stderr:\n{rerr}"
        assert "DescribeVolumes" in perr and "AVD-AWS-0107" in pout


def test_unsupported_service_exits_2(account):
    (prc, pout, perr), (rrc, rout, rerr) = both(["--service", "glacier", "--endpoint",
                                                 account["endpoint"]])
    assert prc == rrc == 2 and pout == rout == "" and perr == rerr and "glacier" in perr
    with pytest.raises(aws.AwsError):
        aws.AwsScanner(services=["glacier"], endpoint=account["endpoint"]).scan()


def test_aws_starts_from_the_builtin_checks(account, tmp_path):
    checks = tmp_path / "checks"
    checks.mkdir()
    (checks / "cust.rego").write_text(CUSTOM_CHECK)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "main.tf").write_text('resource "aws_s3_bucket" "b" {\n  bucket = "b"\n}\n')
    rc, out, err = _run(cli.main, ["config", "--device", "cpu", "-f", "json", "--trace",
                                   "--config-check", str(checks), str(tmp_path / "src")])
    try:
        assert rc == 0 and "CUST902" in out, err[-2000:]
        (prc, pout, _), (rrc, rout, _) = both(["--service", "s3", "--endpoint",
                                               account["endpoint"], "-f", "json"])
    finally:
        configure_shared_scanner([])
    assert prc == rrc == 0 and pout == rout
    assert "CUST902" not in pout and "Traces" not in pout and json.loads(pout)["Results"]
