"""The port's misconfiguration engine (`trivy_tpu_torch/iac/`,
`trivy_tpu_torch/misconf/`) against the reference modules it was copied
from, on the CPU:

* `iac/checks/`: the same file names with the same bytes;
* every builtin check: its failing and its passing fixture through both
  `IacScanner`s, `Misconfiguration.to_json()` equal.  The fixtures are the
  reference corpus's (`tests/test_iac_checks_corpus.py`); a check the
  corpus has no case for takes the first input of the corpus that the
  reference fails (and passes) it on, and the checks no corpus input
  fails have theirs in `trivy_tpu_torch/iac/fixtures.py` (`CHECK_FIXTURES`,
  which `chip_smoke.py` plants too);
* the reference's engine tests (`tests/test_rego_with_stdlib.py`,
  `test_iac.py`, `test_iac_formats.py`, `test_helm.py`: rego, HCL, the
  inputs, the scanner, Helm) run against either package, every result of
  the engine's calls equal;
* the parsers (`detect_type`, the terraform, dockerfile and kubernetes
  inputs, the HCL parser) and the typed-state adapters (terraform,
  CloudFormation) on every fixture above;
* the process-global scanner: `configure_shared_scanner` resets what the
  last run set (`--config-check`, `--trace`).

Tolerance: exact.
"""

import dataclasses
import filecmp
import importlib
import inspect
import json
import os

import pytest

import test_helm as ref_helm_tests
import test_iac as iac_tests
import test_iac_checks_corpus as corpus
import test_iac_formats as fmt_tests
import test_rego_with_stdlib as rego_tests
from trivy_tpu.iac import engine as ref_engine
from trivy_tpu.iac import hcl as ref_hcl
from trivy_tpu.iac import inputs as ref_inputs
from trivy_tpu.iac import rego as ref_rego
from trivy_tpu.iac.adapters import adapt_cloudformation as ref_adapt_cfn
from trivy_tpu.iac.adapters import adapt_terraform as ref_adapt_tf
from trivy_tpu_torch.iac import engine, hcl, inputs, rego
from trivy_tpu_torch.iac.adapters import adapt_cloudformation, adapt_terraform
from trivy_tpu_torch.iac.fixtures import CHECK_FIXTURES

REF_CHECKS = os.path.join(os.path.dirname(ref_engine.__file__), "checks")
PORT_CHECKS = os.path.join(os.path.dirname(engine.__file__), "checks")

def _corpus_cases() -> dict:
    """{(input type, check id): (file name, failing, passing)} of the
    reference corpus, with the file names its tests scan under."""
    out = {}
    for itype, fname, header, cases in (
            ("terraform", "main.tf", "", corpus.TF_CASES),
            ("cloudformation", "stack.yaml", corpus.CFN_HEADER, corpus.CFN_CASES),
            ("dockerfile", "Dockerfile", "", corpus.DOCKER_CASES),
            ("kubernetes", "pod.yaml", "", corpus.K8S_CASES)):
        for check_id, bad, good in cases:
            out[(itype, check_id)] = (fname, header + bad, header + good)
    return out


CORPUS = _corpus_cases()
POOL = [(f, body) for f, bad, good in CORPUS.values() for body in (bad, good)]
BUILTIN = sorted(n[:-5] for n in os.listdir(REF_CHECKS) if n.endswith(".rego"))


@pytest.fixture(scope="module")
def scanners():
    return engine.IacScanner(), ref_engine.IacScanner()


def _fired(mc, check_id: str, kind: str) -> bool:
    return mc is not None and any(f.check_id == check_id for f in getattr(mc, kind))


def _doc(mc):
    return None if mc is None else mc.to_json()


def test_check_dirs_are_byte_equal():
    names = sorted(os.listdir(REF_CHECKS))
    assert sorted(os.listdir(PORT_CHECKS)) == names and len(names) == 121
    match, mismatch, errors = filecmp.cmpfiles(REF_CHECKS, PORT_CHECKS, names, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == 121


def test_load_checks_equal_the_reference(scanners):
    port, ref = scanners
    key = lambda c: (os.path.basename(c.module.source_path), c.check_id, c.title,  # noqa: E731
                     c.description, c.severity, c.resolution, c.input_type,
                     c.subtypes, c.references)
    assert [key(c) for c in port.checks] == [key(c) for c in ref.checks]
    assert len(port.checks) == len(BUILTIN)


@pytest.mark.parametrize("check_file", BUILTIN)
def test_builtin_check_parity(scanners, check_file):
    port, ref = scanners
    (check,) = [c for c in ref.checks
                if os.path.basename(c.module.source_path) == check_file + ".rego"]
    key = (check.input_type, check.check_id)
    if check_file in CHECK_FIXTURES:
        cid, fname, bad, good = CHECK_FIXTURES[check_file]
        assert cid == check.check_id
        pairs = [(fname, bad), (fname, good)]
    elif key in CORPUS:
        fname, bad, good = CORPUS[key]
        pairs = [(fname, bad), (fname, good)]
    else:
        scans = [(f, body, ref.scan(f, body.encode())) for f, body in POOL]
        typed = [(f, body, mc) for f, body, mc in scans
                 if mc is not None and mc.file_type == check.input_type]
        pairs = [next((f, body) for f, body, mc in typed if _fired(mc, check.check_id, kind))
                 for kind in ("failures", "successes")]
    (fb, bad), (fg, good) = pairs
    ref_bad, ref_good = ref.scan(fb, bad.encode()), ref.scan(fg, good.encode())
    assert _fired(ref_bad, check.check_id, "failures")
    assert _fired(ref_good, check.check_id, "successes")
    assert not _fired(ref_good, check.check_id, "failures")
    assert _doc(port.scan(fb, bad.encode())) == _doc(ref_bad)
    assert _doc(port.scan(fg, good.encode())) == _doc(ref_good)


# The reference's engine tests (rego, HCL, inputs, scanner, Helm), run
# against either package: those that import no reference module inside.
REF_SUITES = {m.__name__: m for m in (rego_tests, iac_tests, fmt_tests, ref_helm_tests)}
ENGINE_CASES = [
    f"{mod}::{name}" for mod, module in REF_SUITES.items() for name in sorted(vars(module))
    if name.startswith("test_")
    and "from trivy_tpu" not in inspect.getsource(getattr(module, name))
]
# The methods whose results are recorded.
RECORDED = ("scan", "evaluate", "eval_deny", "eval_set_rule", "eval_complete_rule")


def _plain(o):
    try:
        return o.to_json()
    except (AttributeError, TypeError):
        pass  # no to_json, or fields it cannot write (a test's own strings)
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, (set, frozenset)):
        return sorted(o, key=repr)
    return repr(o)


def _recording(obj, record: list):
    """`obj` (a class or a function of an engine module) with what its
    calls return appended to `record`; exceptions as they are."""
    if isinstance(obj, type):
        recorded = [n for n in RECORDED if hasattr(obj, n)]
        if not recorded:
            return obj  # types, enums, exceptions

        def method(name):
            def call(self, *a, **k):
                out = getattr(super(cls, self), name)(*a, **k)
                record.append(out)
                return out
            return call

        cls = type(obj.__name__, (obj,), {n: method(n) for n in recorded})
        return cls
    if callable(obj):
        def call(*a, **k):
            out = obj(*a, **k)
            record.append(out)
            return out
        return call
    return obj


def run_swapped(module, name: str, tmp_path, monkeypatch) -> dict:
    """Run the reference test `module.name` twice: with the reference's
    names, then with the port's (every module global taken from
    `trivy_tpu.*` swapped for the port's object of the same name), each
    recording what its calls return.  Returns {"ref", "port": record}."""
    originals = {k: v for k, v in vars(module).items()
                 if getattr(v, "__module__", "").startswith("trivy_tpu.")}
    assert originals
    records = {}
    for label in ("ref", "port"):
        record = []
        for k, obj in originals.items():
            if label == "port":
                obj = getattr(importlib.import_module(
                    "trivy_tpu_torch." + obj.__module__.split(".", 1)[1]), obj.__name__)
            monkeypatch.setattr(module, k, _recording(obj, record))
        fn = getattr(module, name)
        kwargs = {}
        for param in inspect.signature(fn).parameters:
            if param == "tmp_path":
                kwargs[param] = tmp_path / label
                kwargs[param].mkdir()
            else:
                assert param == "scanner", param
                kwargs[param] = module.IacScanner()
        fn(**kwargs)
        records[label] = json.loads(json.dumps(record, sort_keys=True, default=_plain))
    return records


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_reference_engine_tests_hold_for_the_port(case, tmp_path, monkeypatch):
    """Each test runs with the reference's engine names and with the port's
    (`run_swapped`): both records are equal, and the reference's assertions
    hold for the port."""
    mod_name, name = case.split("::")
    records = run_swapped(REF_SUITES[mod_name], name, tmp_path, monkeypatch)
    assert records["port"] == records["ref"]


@pytest.mark.parametrize("src", [
    "package t\ndeny[m] { input.x == \n",
    "package t\ndeny[m] { true with foo.bar as 1\n m := \"x\" }",
    "deny[m] { m := 1 }",
], ids=["unterminated", "bad-with", "no-package"])
def test_rego_parse_errors_equal(src):
    with pytest.raises(ref_rego.RegoError) as want:
        ref_rego.parse_module(src)
    with pytest.raises(rego.RegoError) as got:
        rego.parse_module(src)
    assert str(got.value) == str(want.value)


def test_parsers_equal_on_the_corpus():
    """detect_type, the per-type inputs and the HCL parser on every corpus
    input (and the extra fixtures)."""
    extra = [(f, body) for _, f, bad, good in CHECK_FIXTURES.values() for body in (bad, good)]
    for fname, body in POOL + extra:
        data = body.encode()
        ftype = inputs.detect_type(fname, data)
        assert ftype == ref_inputs.detect_type(fname, data), fname
        if ftype == "terraform":
            assert hcl.parse_hcl(body) == ref_hcl.parse_hcl(body)
            assert inputs.terraform_input(body) == ref_inputs.terraform_input(body)
        elif ftype == "dockerfile":
            assert inputs.dockerfile_input(data) == ref_inputs.dockerfile_input(data)
        elif ftype == "kubernetes":
            assert inputs.kubernetes_inputs(data) == ref_inputs.kubernetes_inputs(data)


def test_adapters_equal_on_the_corpus():
    """The typed cloud state the terraform and CloudFormation adapters
    build, as the rego input the cloud checks read."""
    n = 0
    for fname, body in POOL:
        data = body.encode()
        if fname == "main.tf":
            got = adapt_terraform(inputs.terraform_input(body)).to_rego()
            want = ref_adapt_tf(ref_inputs.terraform_input(body)).to_rego()
        else:
            if inputs.detect_type(fname, data) != "cloudformation":
                continue
            got = adapt_cloudformation(inputs.cloudformation_input(data)).to_rego()
            want = ref_adapt_cfn(ref_inputs.cloudformation_input(data)).to_rego()
        assert got == want, fname
        n += 1
    assert n == sum(f in ("main.tf", "stack.yaml") for f, _ in POOL) > 80


def test_shared_scanner_is_reset_by_every_configure(tmp_path):
    """A `--config-check` or `--trace` run must not leak into the next scan
    of the process: each run configures the shared scanner anew."""
    d = tmp_path / "checks"
    d.mkdir()
    (d / "user.rego").write_text(
        "# METADATA\n# title: user check\n# custom:\n#   id: USR001\n#   severity: LOW\n"
        "package user.dockerfile.USR001\n\ndeny[res] {\n    cmd := input.Stages[_].Commands[_]\n"
        '    cmd.Cmd == "from"\n    res := result.new("from", cmd)\n}\n')
    body = b"FROM alpine:3.19\nUSER app\n"
    try:
        engine.configure_shared_scanner([str(d)], trace=True)
        mc = engine.shared_scanner().scan("Dockerfile", body)
        assert _fired(mc, "USR001", "failures") and any(f.traces for f in mc.failures)
        engine.configure_shared_scanner([])
        mc = engine.shared_scanner().scan("Dockerfile", body)
        assert not _fired(mc, "USR001", "failures")
        assert not any(f.traces for f in mc.failures + mc.successes)
    finally:
        engine.configure_shared_scanner([])
