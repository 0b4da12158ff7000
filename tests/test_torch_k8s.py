"""The port's cluster scan (`trivy_tpu_torch/k8s/`, `python -m trivy_tpu_torch
k8s`) against the reference's (`trivy_tpu/k8s/`, `trivy_tpu.cli.main`),
both in this process, on the CPU (`--device cpu`).

On the reference test's API server (`tests/test_k8s.py` `_FakeAPI`):
kubeconfig loading, enumeration and bearer auth; whole JSON reports for
`--report summary` and `all`, `--scanners misconfig,rbac`,
`--include-kinds`, a namespace scope that keeps the cluster-scoped RBAC
kinds, and the KBOM (`-f cyclonedx`, its random `serialNumber` aside).  On
`trivy_tpu_torch/k8s/fixtures.py`'s seeded cluster, whose workloads name
an image served by the in-process registry (`image/fixtures.py`
`serve_registry`) and one no registry serves: `vuln,secret` over the
served image (the reference's own tests only reach an unreachable one),
the unserved image tolerated as a per-resource error with `--exit-code`
failing the run, and, port only, an engine or kernel-build error that
fails the command instead (the port's deliberate difference).  Last, the
process-global rego scanner: `k8s` starts from the builtin checks whatever
an earlier `config --config-check --trace` in the process configured.

Tolerance: exact.
"""

import contextlib
import io
import json
import socket

import pytest

import test_k8s as ref_k8s
import test_torch_image as timg
from trivy_tpu import cli as ref_cli
from trivy_tpu.k8s import client as ref_client
from trivy_tpu.k8s import kbom as ref_kbom
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.db.vulndb import build_db
from trivy_tpu_torch.engine import hybrid
from trivy_tpu_torch.iac.engine import configure_shared_scanner
from trivy_tpu_torch.image import fixtures as imfx
from trivy_tpu_torch.k8s import client, kbom
from trivy_tpu_torch.k8s import fixtures as k8sfx
from torch_log_clock import frozen_log_clock  # noqa: F401

CUSTOM_CHECK = """# METADATA
# title: Every workload
# custom:
#   id: CUST901
#   severity: CRITICAL
package custom.kubernetes.CUST901

deny[res] {
    input.kind
    res := result.new("custom check fired", input)
}
"""


def _run(main, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv: list[str]) -> tuple[tuple, tuple]:
    """(port, reference) (rc, stdout, stderr) of one `k8s` command line."""
    return (_run(cli.main, ["k8s", "--device", "cpu", *argv]),
            _run(ref_cli.main, ["k8s", *argv]))


@pytest.fixture(scope="module", autouse=True)
def isolated(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIVY_TPU_RULES_CACHE_DIR", str(tmp_path_factory.mktemp("rules")))
    mp.setenv("TRIVY_TPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
    for var in ("TRIVY_TPU_SECRET_BACKEND", "TRIVY_TPU_DB_DIR", "TRIVY_TPU_SCANNERS",
                "TRIVY_TPU_FORMAT", "KUBECONFIG"):
        mp.delenv(var, raising=False)
    yield
    mp.undo()
    configure_shared_scanner([])


@pytest.fixture(scope="module")
def api_server():
    from http.server import ThreadingHTTPServer
    import threading

    srv = ThreadingHTTPServer(("127.0.0.1", 0), ref_k8s._FakeAPI)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def kubeconfig(tmp_path, api_server) -> str:
    return ref_k8s._write_kubeconfig(tmp_path, api_server)


def test_kubeconfig_loading_equals_the_reference(tmp_path, kubeconfig):
    assert vars(client.load_kubeconfig(kubeconfig)) == vars(
        ref_client.load_kubeconfig(kubeconfig))
    for args in ((kubeconfig, "missing"), (str(tmp_path / "enoent"), "")):
        with pytest.raises(client.KubeConfigError) as got:
            client.load_kubeconfig(*args)
        with pytest.raises(ref_client.KubeConfigError) as want:
            ref_client.load_kubeconfig(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("namespace", ["", "prod"])
@pytest.mark.parametrize("include, rbac", [([], False), ([], True), (["clusterrole", "Pod"],
                                                                      False)])
def test_enumeration_and_auth_equal_the_reference(kubeconfig, namespace, include, rbac):
    kinds = client.select_kinds(include, rbac=rbac)
    assert kinds == ref_client.select_kinds(include, rbac=rbac)
    got = client.KubeClient(client.load_kubeconfig(kubeconfig)).list_workloads(namespace, kinds)
    want = ref_client.KubeClient(ref_client.load_kubeconfig(kubeconfig)).list_workloads(
        namespace, kinds)
    assert got == want and got
    assert f"Bearer {ref_k8s._FakeAPI.token}" in ref_k8s._FakeAPI.seen_auth


def test_bad_token_and_unknown_kinds_exit_2_as_the_reference(tmp_path, api_server):
    bad = ref_k8s._write_kubeconfig(tmp_path, api_server, token="wrong-token")
    for argv in (["--kubeconfig", bad, "-f", "json"],
                 ["--kubeconfig", bad, "-f", "cyclonedx"]):
        (prc, pout, perr), (rrc, rout, rerr) = both(argv)
        assert prc == rrc == 2 and pout == rout == "" and perr == rerr and "401" in perr
    good = ref_k8s._write_kubeconfig(tmp_path, api_server)
    for argv in (["--include-kinds", "Gateway"], ["--scanners", "misconfig,bogus"]):
        (prc, pout, perr), (rrc, rout, rerr) = both(["--kubeconfig", good, *argv])
        assert prc == rrc == 2 and pout == rout == "" and perr == rerr


@pytest.mark.parametrize("argv", [
    ["--report", "summary"],
    ["--report", "all"],
    ["--scanners", "misconfig,rbac", "--report", "all"],
    ["--scanners", "rbac", "--include-kinds", "ClusterRole,Role"],
    ["prod", "--scanners", "misconfig,rbac", "--report", "all"],
    ["--scanners", "misconfig", "--exit-code", "4"],
], ids=lambda v: "_".join(v).replace("-", ""))
@pytest.mark.parametrize("fmt", ["json", "table"])
def test_k8s_report_equals_the_reference(kubeconfig, argv, fmt):
    (prc, pout, perr), (rrc, rout, rerr) = both(["--kubeconfig", kubeconfig, "-f", fmt, *argv])
    assert prc == rrc and pout == rout, (perr[-2000:], rerr[-2000:])
    assert prc == (4 if "--exit-code" in argv else 0)
    if fmt == "json":
        doc = json.loads(pout)
        rows = doc["Resources"] + doc.get("RBACAssessment", [])
        assert rows and doc["ClusterName"].startswith("http://127.0.0.1")
        if argv[0] == "prod":
            assert {"ClusterRole", "Role"} <= {r["Kind"] for r in rows}


def _kbom(main, argv) -> dict:
    rc, out, err = _run(main, argv)
    assert rc == 0, err[-2000:]
    doc = json.loads(out)
    doc.pop("serialNumber")
    return doc


@pytest.mark.parametrize("target", ["cluster", "prod"])
def test_kbom_equals_the_reference(kubeconfig, tmp_path, target):
    argv = ["k8s", target, "--kubeconfig", kubeconfig, "-f", "cyclonedx"]
    got = _kbom(cli.main, argv)
    assert got == _kbom(ref_cli.main, argv)
    assert got["bomFormat"] == "CycloneDX" and {"node-1", "k8s.io/kubelet"} <= {
        c["name"] for c in got["components"]}
    out = tmp_path / "kbom.json"
    assert cli.main([*argv, "-o", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc.pop("serialNumber").startswith("urn:uuid:") and doc == got
    assert kbom._split_os_image("Amazon Linux 2") == ref_kbom._split_os_image("Amazon Linux 2")


# -- the seeded cluster, its images in the in-process registry ---------------


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """{"kubeconfig", "db", "served", "gone"}: a seeded cluster of 18
    workloads naming `served` (the test image, in the in-process registry)
    and `gone` (a registry that refuses connections)."""
    base = tmp_path_factory.mktemp("cluster")
    layers, config = timg.seeded_image()
    manifest, blobs, digest = imfx.oci_blobs(layers, config)
    registry = imfx.serve_registry({"app": {"manifests": {"1": manifest, digest: manifest},
                                            "blobs": blobs}})
    served = f"127.0.0.1:{registry.server_address[1]}/app:1"
    gone = f"127.0.0.1:{_closed_port()}/gone:1"
    seeded = k8sfx.seeded_cluster([served, served, gone], workloads=18, namespaces=3, rbac=8,
                                  nodes=2, seed=3)
    api = k8sfx.serve_cluster(seeded)
    build_db(str(base / "db"), timg.DB)
    yield {"kubeconfig": k8sfx.write_kubeconfig(str(base / "kubeconfig"),
                                                f"http://127.0.0.1:{api.server_address[1]}"),
           "db": str(base / "db"), "served": served, "gone": gone, "seeded": seeded}
    for srv in (registry, api):
        srv.shutdown()
        srv.server_close()


def test_seeded_cluster_enumerates_every_kind(cluster):
    c = client.KubeClient(client.load_kubeconfig(cluster["kubeconfig"]))
    got = c.list_workloads(kinds=client.select_kinds([], rbac=True))
    assert {r["kind"] for r in got} == set(k8sfx.API)
    assert len(got) == sum(len(v) for v in cluster["seeded"]["items"].values())
    assert sorted(n["metadata"]["name"] for n in c.get("/api/v1/nodes")["items"]) == [
        "node-0", "node-1"]


def test_vuln_secret_over_a_served_image_equals_the_reference(cluster):
    argv = ["--kubeconfig", cluster["kubeconfig"], "--scanners", "misconfig,vuln,secret,rbac",
            "--report", "all", "-f", "json", "--db-dir", cluster["db"], "--insecure",
            "--exit-code", "1"]
    (prc, pout, perr), (rrc, rout, rerr) = both(argv)
    assert prc == rrc == 1, (perr[-2000:], rerr[-2000:])
    got = json.loads(pout)
    assert got == json.loads(rout)
    rows = got["Resources"]
    errors = {r["Name"] for r in rows if r.get("Error")}
    gone = {w["metadata"]["name"] for kind in k8sfx.TOP_KINDS
            for w in cluster["seeded"]["items"][kind] if cluster["gone"] in json.dumps(w)
            and not w["metadata"].get("ownerReferences")}
    assert errors == gone and gone
    secrets = {(r["Name"], res["Target"]) for r in rows for res in r.get("Results", [])
               for _ in res.get("Secrets", [])}
    vulns = {v["VulnerabilityID"] for r in rows for res in r.get("Results", [])
             for v in res.get("Vulnerabilities", [])}
    assert secrets and {"CVE-2099-0001", "CVE-2021-23337"} <= vulns


def test_each_image_is_scanned_once(cluster, monkeypatch):
    from trivy_tpu_torch.artifact import image as port_image

    seen = []
    real = port_image.ImageArtifact.inspect
    monkeypatch.setattr(port_image.ImageArtifact, "inspect",
                        lambda self: seen.append(self.target) or real(self))
    rc, _, err = _run(cli.main, ["k8s", "--device", "cpu", "--kubeconfig", cluster["kubeconfig"],
                                 "--scanners", "secret", "--insecure", "-f", "json"])
    assert rc == 0, err[-2000:]
    assert seen == [cluster["served"]]


def _failing_engine(kind: str):
    real = hybrid.make_secret_engine

    def make(**kw):
        if kind == "build":
            raise FileNotFoundError("nvcc: not found (the kernels cannot be built)")
        engine = real(**kw)

        def scan_batch(items):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        engine.scan_batch = scan_batch
        return engine

    return make


@pytest.mark.parametrize("kind", ["launch", "build"])
def test_engine_errors_fail_the_command(cluster, monkeypatch, kind):
    """A registry that cannot serve is one resource's error; an engine or
    kernel-build error is not: it leaves the command."""
    monkeypatch.setattr(hybrid, "make_secret_engine", _failing_engine(kind))
    argv = ["k8s", "--device", "cpu", "--kubeconfig", cluster["kubeconfig"], "--scanners",
            "misconfig,secret", "--insecure", "-f", "json"]
    with pytest.raises(RuntimeError if kind == "launch" else FileNotFoundError):
        _run(cli.main, argv)


def test_registry_failure_stays_a_resource_error(cluster, monkeypatch, tmp_path):
    """With the engine failing as above, a cluster whose only image no
    registry serves still scans: every workload row carries the pull error,
    its misconfigurations are kept, `--exit-code` fails the run."""
    monkeypatch.setattr(hybrid, "make_secret_engine", _failing_engine("launch"))
    api = k8sfx.serve_cluster(k8sfx.seeded_cluster([cluster["gone"]], workloads=6, rbac=0,
                                                   seed=5))
    try:
        kc = k8sfx.write_kubeconfig(str(tmp_path / "kc"),
                                    f"http://127.0.0.1:{api.server_address[1]}")
        argv = ["--kubeconfig", kc, "--scanners", "misconfig,secret", "--insecure", "-f",
                "json", "--report", "all", "--exit-code", "1"]
        (prc, pout, perr), (rrc, rout, _) = both(argv)
    finally:
        api.shutdown()
        api.server_close()
    assert prc == rrc == 1 and pout == rout, perr[-2000:]
    rows = json.loads(pout)["Resources"]
    assert len(rows) == 6
    assert all(r["Error"].startswith("unable to resolve image") for r in rows)
    assert any(r.get("Results") for r in rows)


def test_k8s_starts_from_the_builtin_checks(kubeconfig, tmp_path):
    """An earlier `config --config-check D --trace` in the process does not
    reach `k8s`: its report equals the reference's fresh one."""
    checks = tmp_path / "checks"
    checks.mkdir()
    (checks / "cust.rego").write_text(CUSTOM_CHECK)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "pod.yaml").write_text(
        "apiVersion: v1\nkind: Pod\nmetadata:\n  name: p\nspec:\n  containers:\n"
        "  - name: a\n    image: nginx\n")
    rc, out, err = _run(cli.main, ["config", "--device", "cpu", "-f", "json", "--trace",
                                   "--config-check", str(checks), str(tmp_path / "src")])
    assert rc == 0 and "CUST901" in out, err[-2000:]
    (prc, pout, _), (rrc, rout, _) = both(["--kubeconfig", kubeconfig, "-f", "json",
                                           "--report", "all"])
    assert prc == rrc == 0 and pout == rout
    assert "CUST901" not in pout and "Traces" not in pout
