"""The port's report formats beyond table/json/sarif (`-f cyclonedx|spdx|
spdx-json|template|github|cosign-vuln`: `trivy_tpu_torch/report/writer.py`,
`report/extra.py`, the encoders of `sbom/`) and its `sbom` target
(`artifact/sbom.py`) against the reference's, on the CPU, the twins of
`tests/test_extra_formats.py:49-83`, `:321-365` and
`tests/test_breadth.py:211`, `:255`:

* every writer on the same report (the reference test's `_vuln_report`,
  built in each package) gives the reference writer's text;
* `image --input` of `test_torch_image`'s seeded image over its DB with
  each `-f`, through both CLIs: the same text (`--template` inline and as
  `@FILE`); `-f template` without `--template` exits 2 like the reference;
* `sbom` over the port's CycloneDX, SPDX JSON and SPDX tag-value output of
  that image scan finds the image scan's vulnerabilities; the reference's
  `sbom` of the same file finds its npm ones and loses its OS packages
  (its decoders read the encoders' `pkg:debian/...` purls as an
  application), and the port's report equals it but for the OS result;
  `sbom` over the reference test's SPDX document equals the reference's.

Nothing is normalised: every report here has no `CreatedAt`, so the
SPDX namespace and the predicate's times are fixed.  Tolerance: exact.
"""

import contextlib
import io
import json

import pytest

import test_torch_image as tim
from trivy_tpu import cli as ref_cli
from trivy_tpu import ftypes as ref_ftypes
from trivy_tpu.atypes import Package as RefPackage
from trivy_tpu.report.writer import write_report as ref_write
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import ftypes
from trivy_tpu_torch.atypes import Package
from trivy_tpu_torch.image.fixtures import write_docker_archive
from trivy_tpu_torch.report.writer import FORMATS, write_report

TEMPLATE = ("{{ range .Results }}{{ .Target }}:{{ range .Vulnerabilities }} "
            "{{ .VulnerabilityID }}{{ end }}\n{{ end }}")
SBOM_FORMATS = ["cyclonedx", "spdx-json", "spdx"]


def vuln_report(ft, package_cls):
    """`tests/test_extra_formats.py`'s `_vuln_report` with packages, built
    from a package's `ftypes` and `Package`."""
    report = ft.Report(
        artifact_name="app", artifact_type=ft.ArtifactType.FILESYSTEM,
        metadata=ft.Metadata(os_family="alpine", os_name="3.15"),
        results=[ft.Result(
            target="app/package-lock.json", result_class=ft.ResultClass.LANG_PKGS,
            result_type="npm",
            vulnerabilities=[
                ft.DetectedVulnerability(vulnerability_id="CVE-2099-1000", pkg_name="lodash",
                                         installed_version="4.17.20", fixed_version="4.17.21",
                                         severity="CRITICAL"),
                ft.DetectedVulnerability(vulnerability_id="CVE-2099-2000", pkg_name="ws",
                                         installed_version="7.0.0", severity="HIGH"),
            ])],
    )
    report.results[0].packages = [package_cls(name="lodash", version="4.17.20"),
                                  package_cls(name="ws", version="7.0.0", indirect=True)]
    return report


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_equals_the_reference_writer(fmt):
    got, want = io.StringIO(), io.StringIO()
    write_report(vuln_report(ftypes, Package), fmt, got, template=TEMPLATE)
    ref_write(vuln_report(ref_ftypes, RefPackage), fmt, want, template=TEMPLATE)
    assert got.getvalue() == want.getvalue() and got.getvalue()
    if fmt == "template":
        assert got.getvalue() == "app/package-lock.json: CVE-2099-1000 CVE-2099-2000\n"
    if fmt == "github":
        manifest = json.loads(got.getvalue())["manifests"]["app/package-lock.json"]
        assert manifest["resolved"]["ws"]["relationship"] == "indirect"


def test_unknown_format_is_refused():
    with pytest.raises(ValueError, match="unknown format"):
        write_report(vuln_report(ftypes, Package), "bogus", io.StringIO())


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    base = tmp_path_factory.mktemp("sbom")
    archive = str(base / "app.tar")
    write_docker_archive(archive, *tim.seeded_image())
    tim.build_db(str(base / "db"), tim.DB)
    (base / "report.tpl").write_text(TEMPLATE)
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(base / "rules"))
    for var in ("TRIVY_TPU_SECRET_BACKEND", "TRIVY_TPU_DB_DIR", "TRIVY_TPU_SCANNERS"):
        mp.delenv(var, raising=False)
    yield {"archive": archive, "db": str(base / "db"), "tpl": str(base / "report.tpl"),
           "base": base}
    mp.undo()


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def image_both(image: dict, argv: list[str]) -> tuple[str, str]:
    common = ["--db-dir", image["db"], *argv]
    prc, pout, perr = _run(cli.main, ["image", "--device", "cpu", *common,
                                      "--input", image["archive"]])
    rrc, rout, rerr = _run(ref_cli.main, ["image", *common, "--input", image["archive"],
                                          image["archive"]])
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    return pout, rout


@pytest.mark.parametrize("fmt", ["cyclonedx", "spdx", "spdx-json", "github", "cosign-vuln",
                                 "template", "template@file"])
def test_image_format_equals_the_reference_cli(image, fmt):
    argv = ["-f", fmt]
    if fmt == "template":
        argv += ["--template", TEMPLATE]
    elif fmt == "template@file":
        argv = ["-f", "template", "--template", "@" + image["tpl"]]
    got, want = image_both(image, argv)
    assert got == want
    if fmt.startswith("template"):
        assert "CVE-2021-23337" in got and "CVE-2099-0001" in got


def test_template_format_needs_a_template_like_the_reference(image):
    argv = ["-f", "template", "--db-dir", image["db"]]
    prc, pout, perr = _run(cli.main, ["image", "--device", "cpu", *argv,
                                      "--input", image["archive"]])
    rrc, rout, rerr = _run(ref_cli.main, ["image", *argv, "--input", image["archive"],
                                          image["archive"]])
    assert prc == rrc == 2 and pout == rout == "" and perr == rerr


def _vulns(doc: dict) -> set:
    return {(v["PkgName"], v["InstalledVersion"], v["VulnerabilityID"])
            for r in doc.get("Results", []) for v in r.get("Vulnerabilities", [])}


@pytest.mark.parametrize("fmt", SBOM_FORMATS)
def test_sbom_of_the_port_output_finds_the_image_vulnerabilities(image, fmt):
    pout, _ = image_both(image, ["-f", "json"])
    want = _vulns(json.loads(pout))
    assert {v[2] for v in want} == {"CVE-2099-0001", "CVE-2099-0003", "CVE-2021-23337"}
    path = str(image["base"] / f"bom.{fmt}")
    rc, _, err = _run(cli.main, ["image", "--device", "cpu", "--db-dir", image["db"], "-f", fmt,
                                 "-o", path, "--input", image["archive"]])
    assert rc == 0, err[-2000:]
    argv = ["sbom", "-f", "json", "--db-dir", image["db"], path]
    prc, got, perr = _run(cli.main, [argv[0], "--device", "cpu", *argv[1:]])
    rrc, ref, rerr = _run(ref_cli.main, argv)
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    doc, ref_doc = json.loads(got), json.loads(ref)
    assert doc["ArtifactType"] == ("cyclonedx" if fmt == "cyclonedx" else "spdx")
    assert _vulns(doc) == want
    # the reference's decoder reads the OS packages' `pkg:debian/...` purls
    # as an application of type "debian", so it finds only the npm ones;
    # every other result is the same
    os_results = [r for r in doc["Results"] if r["Class"] == "os-pkgs"]
    assert {v[2] for v in _vulns({"Results": os_results})} == {"CVE-2099-0001",
                                                               "CVE-2099-0003"}
    assert [r for r in doc["Results"] if r["Class"] != "os-pkgs"] == ref_doc["Results"]
    assert _vulns(ref_doc) == {v for v in want if v[0] == "lodash"}


def test_sbom_of_a_spdx_document_equals_the_reference(image):
    spdx = {"spdxVersion": "SPDX-2.3", "SPDXID": "SPDXRef-DOCUMENT", "name": "app",
            "packages": [{"SPDXID": "SPDXRef-Package-1", "name": "lodash",
                          "versionInfo": "4.17.20",
                          "externalRefs": [{"referenceCategory": "PACKAGE-MANAGER",
                                            "referenceType": "purl",
                                            "referenceLocator": "pkg:npm/lodash@4.17.20"}]}]}
    path = image["base"] / "doc.spdx.json"
    path.write_text(json.dumps(spdx))
    argv = ["sbom", "-f", "json", "--db-dir", image["db"], str(path)]
    (prc, pout, _), (rrc, rout, _) = (_run(cli.main, [argv[0], "--device", "cpu", *argv[1:]]),
                                      _run(ref_cli.main, argv))
    assert prc == rrc == 0 and json.loads(pout) == json.loads(rout)
    assert [v[2] for v in _vulns(json.loads(pout))] == ["CVE-2021-23337"]
