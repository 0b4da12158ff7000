"""The port's image sources (`trivy_tpu_torch/image/`: the registry client,
the daemon and containerd sources, the resolution chain) against the
reference's (`trivy_tpu/image/`), on the CPU, the twins of
`tests/test_image_sources.py`: reference parsing and platform picking, a
pull from an in-process registry (the reference test's `_FakeRegistry`,
subclassed so its state is this module's), bearer-token and basic auth
and the handshake's order, tag listing, the base-layer secret skip, the
OCI-referrer SBOM short-circuit (`--sbom-sources oci`: no layer walked)
and its referrers-tag fallback, a containerd root (meta.db written by
`tests/bolt_fixture.py`) with an index and with a missing blob, the chain's
joined error, and `image REF --insecure` through both CLIs with whole JSON
reports equal.

Tolerance: exact.
"""

import contextlib
import io
import json
import tarfile
import threading
from http.server import ThreadingHTTPServer

import pytest

import test_image_sources as tis
import test_torch_image as tim
from trivy_tpu import cli as ref_cli
from trivy_tpu.image import containerd as ref_containerd
from trivy_tpu.image import registry as ref_registry
from trivy_tpu.image import resolve_image as ref_resolve
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.analyzer.core import AnalyzerOptions, SecretScannerOption
from trivy_tpu_torch.artifact import image as port_image
from trivy_tpu_torch.cache.store import MemoryCache
from trivy_tpu_torch.image import containerd, registry, resolve_image
from trivy_tpu_torch.image.daemon import SourceUnavailable
from trivy_tpu_torch.image.fixtures import oci_blobs, write_docker_archive

REFS = ["alpine", "alpine:3.19", "docker.io/nginx:1.25", "registry-1.docker.io/x/y",
        "ghcr.io/org/app:1.2", "localhost:5000/app@sha256:" + "a" * 64,
        "127.0.0.1:5000/a/b/c:tag", "quay.io/org/app@sha256:" + "b" * 64, "org/app"]


def _cpu_options(**kw) -> AnalyzerOptions:
    return AnalyzerOptions(device="cpu", secret_scanner_option=SecretScannerOption(
        device="cpu"), **kw)


class _Registry(tis._FakeRegistry):
    """The reference test's fake registry with this module's own state, and
    `tags/list`."""

    manifest: dict = {}
    manifests: dict = {}
    referrers: dict = {}
    blobs: dict = {}
    tags: list = []
    seen_auth: list = []

    def do_GET(self):  # noqa: N802
        if self.path.endswith("/tags/list") and self._authed():
            body = json.dumps({"name": "test/app", "tags": self.tags}).encode()
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body)
            return
        super().do_GET()


def _serve(handler) -> tuple:
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def registry_addr():
    manifest, blobs = tis._fake_image()
    _Registry.manifest, _Registry.blobs = manifest, dict(blobs)
    _Registry.tags = ["2", "1", "latest"]
    srv, addr = _serve(_Registry)
    yield addr
    srv.shutdown()


@pytest.fixture(scope="module")
def seeded_registry(tmp_path_factory):
    """The seeded image of `test_torch_image` served as an OCI manifest, and
    a DB that flags its packages."""
    layers, config = tim.seeded_image()
    manifest, blobs, _ = oci_blobs(layers, config)
    manifest = json.loads(manifest)

    class Seeded(_Registry):
        pass

    Seeded.manifest, Seeded.blobs = manifest, blobs
    Seeded.manifests, Seeded.referrers = {}, {}
    db = tmp_path_factory.mktemp("db")
    tim.build_db(str(db), tim.DB)
    srv, addr = _serve(Seeded)
    yield addr, str(db), Seeded
    srv.shutdown()


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    _Registry.require_token = False
    _Registry.seen_auth = []
    _Registry.referrers = {}
    _Registry.manifests = {}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("ref", REFS)
def test_parse_reference_equals_the_reference(ref):
    got, want = registry.parse_reference(ref), ref_registry.parse_reference(ref)
    assert (got.registry, got.repository, got.tag, got.digest, got.name) == (
        want.registry, want.repository, want.tag, want.digest, want.name)


def test_pick_platform_equals_the_reference():
    index = {"manifests": [{"digest": "sha256:a", "platform": {"os": "linux",
                                                                "architecture": "arm64"}},
                           {"digest": "sha256:b", "platform": {"os": "linux",
                                                                "architecture": "amd64"}},
                           {"digest": "sha256:c"}]}
    for plat in (("linux", "amd64"), ("linux", "arm64"), ("windows", "amd64")):
        assert registry.pick_platform(index, *plat) == ref_registry.pick_platform(index, *plat)
    assert registry.pick_platform(index, "linux", "amd64")["digest"] == "sha256:b"
    with pytest.raises(RuntimeError):
        registry.pick_platform({"manifests": []}, "linux", "amd64")


def _pulled(client, addr: str):
    src = client.fetch_image(f"{addr}/test/app:1")
    layers = []
    for opener in src.layers:
        with opener() as f:
            layers.append(f.read())
    return src.config, src.config_digest, src.diff_ids, src.repo_tags, layers


@pytest.mark.parametrize("auth", ["none", "token", "basic-token"])
def test_registry_pull_equals_the_reference(registry_addr, auth):
    _Registry.require_token = auth != "none"
    cred = {"username": "u", "password": "p"} if auth == "basic-token" else {}
    got = _pulled(registry.RegistryClient(insecure=True, **cred), registry_addr)
    want = _pulled(ref_registry.RegistryClient(insecure=True, **cred), registry_addr)
    assert got == want and len(got[2]) == 2
    with tarfile.open(fileobj=io.BytesIO(got[4][0]), mode="r:*") as tf:
        assert tf.getnames() == ["etc/base.conf"]


def test_basic_then_bearer_handshake_equals_the_reference(registry_addr):
    """Basic attached first, a Bearer challenge, the Basic credentials
    traded at the realm, the retry with the token: the same requests in the
    same order as the reference's client."""
    seen = []
    for client in (registry.RegistryClient, ref_registry.RegistryClient):
        _Registry.require_token = True
        _Registry.seen_auth = []
        manifest, _ = client(insecure=True, username="u", password="p").get_manifest(
            registry.parse_reference(f"{registry_addr}/test/app:1"))
        assert manifest.get("layers")
        seen.append(list(_Registry.seen_auth))
    assert seen[0] == seen[1]
    kinds = [(p == "/token", a.split(" ")[0]) for p, a in seen[0]]
    assert kinds == [(False, "Basic"), (True, "Basic"), (False, "Bearer")]


def test_list_tags_equals_the_reference(registry_addr):
    ref = registry.parse_reference(f"{registry_addr}/test/app:1")
    got = registry.RegistryClient(insecure=True).list_tags(ref)
    assert got == ref_registry.RegistryClient(insecure=True).list_tags(ref) == [
        "1", "2", "latest"]


def test_registry_errors_name_the_url(registry_addr):
    client = registry.RegistryClient(insecure=True)
    with pytest.raises(registry.RegistryError, match="HTTP 404"):
        client.get_blob(registry.parse_reference(f"{registry_addr}/test/app:1"),
                        "sha256:" + "0" * 64)


def test_base_layer_secret_skip_through_the_registry(registry_addr):
    src = registry.RegistryClient(insecure=True).fetch_image(f"{registry_addr}/test/app:1")
    art = port_image.ImageArtifact("test/app:1", MemoryCache(), _cpu_options(), source=src)
    base, app = src.diff_ids
    assert port_image.guess_base_layers(src.diff_ids, src.config) == [base]
    ref = art.inspect()
    paths = {s.file_path for b in ref.blob_ids for s in art.cache.get_blob(b).secrets}
    assert paths == {"/srv/app.conf"}
    assert art._layer_key(base, ()) != art._layer_key(base, ("secret",))


def _plant_sbom(addr: str, via_tag: bool, name: str, version: str) -> None:
    doc = {"bomFormat": "CycloneDX", "specVersion": "1.5",
           "components": [{"type": "library", "name": name, "version": version,
                           "purl": f"pkg:pypi/{name}@{version}"}]}
    blob = json.dumps(doc).encode()
    sbom_manifest = {
        "schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "artifactType": "application/vnd.cyclonedx+json",
        "layers": [{"mediaType": "application/vnd.cyclonedx+json",
                    "digest": tis._digest(blob), "size": len(blob)}]}
    image_digest = tis._digest(json.dumps(_Registry.manifest).encode())
    mdigest = tis._digest(json.dumps(sbom_manifest).encode())
    _Registry.blobs[tis._digest(blob)] = blob
    _Registry.manifests = {mdigest: sbom_manifest}
    index = {"schemaVersion": 2, "mediaType": "application/vnd.oci.image.index.v1+json",
             "manifests": [{"mediaType": "application/vnd.oci.image.manifest.v1+json",
                            "artifactType": "application/vnd.cyclonedx+json",
                            "digest": mdigest, "size": 1}]}
    if via_tag:
        _Registry.manifests[image_digest.replace(":", "-")] = index
    else:
        _Registry.referrers = {image_digest: index}


@pytest.mark.parametrize("via_tag", [False, True], ids=["referrers-api", "tag-schema"])
def test_referrer_sbom_short_circuits_the_layer_walk(registry_addr, via_tag, tmp_path,
                                                     monkeypatch):
    """`image REF --sbom-sources oci`: the referrer SBOM's packages, no
    layer walked, no engine built; the report equals the reference CLI's."""
    from trivy_tpu_torch.engine import hybrid

    _plant_sbom(registry_addr, via_tag, "flask", "2.0.1")
    calls = {"walk": 0, "engine": 0}
    real_walk, real_make = port_image.walk_layer_tar, hybrid.make_secret_engine

    def walk(f):
        calls["walk"] += 1
        return real_walk(f)

    def make(**kw):
        calls["engine"] += 1
        return real_make(**kw)

    monkeypatch.setattr(port_image, "walk_layer_tar", walk)
    monkeypatch.setattr(hybrid, "make_secret_engine", make)
    target = f"{registry_addr}/test/app:1"
    argv = ["--insecure", "--sbom-sources", "oci", "-f", "json", "--list-all-pkgs",
            "--cache-dir", str(tmp_path), target]
    (prc, pout, perr) = _run(cli.main, ["image", "--device", "cpu", *argv])
    (rrc, rout, rerr) = _run(ref_cli.main, ["image", *argv])
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    doc = json.loads(pout)
    assert doc == json.loads(rout) and calls == {"walk": 0, "engine": 0}
    assert doc["ArtifactType"] == "cyclonedx"
    assert [(p["Name"], p["Version"]) for r in doc["Results"] for p in r.get("Packages", [])
            ] == [("flask", "2.0.1")]
    # without the flag the layers are walked
    src = registry.RegistryClient(insecure=True).fetch_image(target)
    ref = port_image.ImageArtifact(target, MemoryCache(), _cpu_options(), source=src).inspect()
    assert ref.artifact_type == "container_image" and calls == {"walk": 2, "engine": 1}


def test_sbom_sources_rekor_exits_2_naming_its_item(registry_addr, tmp_path):
    """Ported since (ROADMAP A13d.3): `image --sbom-sources rekor` of a
    registry image, against a fake Rekor log that attests nothing, gives
    the reference CLI's report."""
    from trivy_tpu_torch.attestation_fixtures import serve_rekor

    srv = serve_rekor({})
    try:
        argv = ["--sbom-sources", "rekor", "--rekor-url", srv.url, "--insecure", "-f", "json",
                "--cache-dir", str(tmp_path), f"{registry_addr}/test/app:1"]
        prc, pout, perr = _run(cli.main, ["image", "--device", "cpu", *argv])
        rrc, rout, rerr = _run(ref_cli.main, ["image", *argv])
    finally:
        srv.shutdown()
        srv.server_close()
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    assert pout == rout and json.loads(pout)["ArtifactType"] == "container_image"


def test_image_ref_equals_the_reference_cli(seeded_registry, tmp_path):
    """`image localhost:P/smoke/app:1 --insecure` from the registry: whole
    JSON reports equal, and equal to `image --input` of the same image
    but for the artifact's name and metadata."""
    addr, db, _ = seeded_registry
    target = f"{addr}/smoke/app:1"
    argv = ["--insecure", "-f", "json", "--db-dir", db, "--cache-dir", str(tmp_path)]
    prc, pout, perr = _run(cli.main, ["image", "--device", "cpu", *argv, target])
    rrc, rout, rerr = _run(ref_cli.main, ["image", *argv, target])
    assert prc == rrc == 0, (perr[-2000:], rerr[-2000:])
    doc = json.loads(pout)
    assert doc == json.loads(rout)
    archive = str(tmp_path / "app.tar")
    write_docker_archive(archive, *tim.seeded_image())
    rc, out, _ = _run(cli.main, ["image", "--device", "cpu", *argv, "--input", archive])
    local = json.loads(out)
    assert rc == 0 and json.loads(json.dumps(local["Results"]).replace(archive, target)) == doc[
        "Results"]
    assert local["Metadata"]["ImageID"] == doc["Metadata"]["ImageID"]
    assert doc["Metadata"]["RepoTags"] == ["smoke/app:1"]


# -- containerd and the chain ------------------------------------------------------


def test_containerd_source_equals_the_reference(tmp_path):
    manifest, blobs = tis._fake_image()
    root = tis._containerd_root(tmp_path, ["docker.io/library/testapp:1.0"], manifest, blobs)
    got = containerd.containerd_image("testapp:1.0", root=root)
    want = ref_containerd.containerd_image("testapp:1.0", root=root)
    assert (got.config, got.config_digest, got.repo_tags, got.repo_digests) == (
        want.config, want.config_digest, want.repo_tags, want.repo_digests)
    assert got.repo_tags == ["docker.io/library/testapp:1.0"] and len(got.diff_ids) == 2
    with got.layers[0]() as f:
        assert tarfile.open(fileobj=f, mode="r:*").getnames() == ["etc/base.conf"]


def test_containerd_index_through_the_chain(tmp_path, monkeypatch):
    manifest, blobs = tis._fake_image()

    def index(mdigest):
        return {"schemaVersion": 2, "mediaType": "application/vnd.oci.image.index.v1+json",
                "manifests": [{"digest": "sha256:" + "0" * 64,
                               "platform": {"os": "linux", "architecture": "arm64"}},
                              {"digest": mdigest,
                               "platform": {"os": "linux", "architecture": "amd64"}}]}

    root = tis._containerd_root(tmp_path, ["ghcr.io/org/app:2"], manifest, blobs, index=index)
    monkeypatch.setenv("CONTAINERD_ROOT", root)
    got, want = resolve_image("ghcr.io/org/app:2"), ref_resolve("ghcr.io/org/app:2")
    assert (got.config, got.diff_ids, got.repo_tags) == (want.config, want.diff_ids,
                                                         want.repo_tags)
    art = port_image.ImageArtifact("ghcr.io/org/app:2", MemoryCache(), _cpu_options(),
                                   source=got)
    ref = art.inspect()
    assert {s.file_path for b in ref.blob_ids for s in art.cache.get_blob(b).secrets} == {
        "/srv/app.conf"}


def test_containerd_missing_blob_is_source_unavailable(tmp_path):
    manifest, blobs = tis._fake_image()
    blobs = dict(blobs)
    blobs.pop(manifest["layers"][1]["digest"])
    root = tis._containerd_root(tmp_path, ["docker.io/library/x:1"], manifest, blobs)
    with pytest.raises(SourceUnavailable, match="missing layer"):
        containerd.containerd_image("x:1", root=root)


def test_resolve_chain_joins_every_source_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path))
    with pytest.raises(registry.RegistryError) as got:
        resolve_image("127.0.0.1:1/enoent/image:1", insecure_registry=True)
    with pytest.raises(ref_registry.RegistryError) as want:
        ref_resolve("127.0.0.1:1/enoent/image:1", insecure_registry=True)
    assert str(got.value) == str(want.value)
    assert all(f"{n}:" in str(got.value) for n in ("docker", "containerd", "podman",
                                                    "registry"))


def test_archive_path_bypasses_the_chain(tmp_path):
    archive = str(tmp_path / "app.tar")
    write_docker_archive(archive, *tim.seeded_image())
    src = resolve_image(archive)
    assert src.repo_tags == ["smoke/app:1"] and len(src.diff_ids) == 4


@pytest.mark.parametrize("daemon", ["docker", "podman"])
def test_daemon_socket_export_equals_the_reference(tmp_path, monkeypatch, daemon):
    """`GET /images/<ref>/get` over a unix socket returns a `docker save`
    archive (a fake daemon here); the chain's docker or podman hop loads it
    as the reference's does, and the export's temporary tar is removed with
    the source."""
    import gc
    import os
    import socketserver
    from http.server import BaseHTTPRequestHandler

    from trivy_tpu.image import daemon as ref_daemon
    from trivy_tpu_torch.image import daemon as port_daemon

    archive = tmp_path / "app.tar"
    write_docker_archive(str(archive), *tim.seeded_image())
    body = archive.read_bytes()
    seen = []

    class Export(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            seen.append(self.path)
            ok = self.path == "/images/smoke%2Fapp%3A1/get"
            self.send_response(200 if ok else 404)
            self.send_header("Content-Length", str(len(body) if ok else 0))
            self.end_headers()
            if ok:
                self.wfile.write(body)

    class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
        daemon_threads = True

        def get_request(self):
            conn, _ = super().get_request()
            return conn, ("local", 0)

    sock = str(tmp_path / f"{daemon}.sock")
    srv = Server(sock, Export)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    attr = "DOCKER_SOCKETS" if daemon == "docker" else "PODMAN_SOCKETS"
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path / "no-containerd"))
    try:
        for mod in (port_daemon, ref_daemon):
            monkeypatch.setattr(mod, "DOCKER_SOCKETS", ())
            monkeypatch.setattr(mod, "PODMAN_SOCKETS", ())
            monkeypatch.setattr(mod, attr, (sock,))
        got, want = resolve_image("smoke/app:1"), ref_resolve("smoke/app:1")
        assert (got.config, got.config_digest, got.repo_tags) == (
            want.config, want.config_digest, want.repo_tags)
        assert got.repo_tags == ["smoke/app:1"] and len(got.diff_ids) == 4
        exported = got._tmpfile
        with got.layers[0]() as f:
            assert "etc/os-release" in tarfile.open(fileobj=f, mode="r:*").getnames()
        art = port_image.ImageArtifact("smoke/app:1", MemoryCache(), _cpu_options(), source=got)
        assert len(art.inspect().blob_ids) == 5
        del got, art
        gc.collect()
        assert not os.path.exists(exported)
        # an image the daemon lacks: every hop fails, the registry's on a
        # closed localhost port
        with pytest.raises(registry.RegistryError,
                           match=f"{daemon}: image '127.0.0.1:1/none:1' not found"):
            resolve_image("127.0.0.1:1/none:1", insecure_registry=True)
    finally:
        srv.shutdown()
        srv.server_close()
    assert seen[:2] == ["/images/smoke%2Fapp%3A1/get"] * 2
