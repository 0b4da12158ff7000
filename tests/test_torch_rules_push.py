"""`rules push`, digest routing, hot reload and `fs --secret-backend
server` against the port's server (in-process, CPU engines, a registry
directory so the resident pool is on).

* An artifact compiled and pushed by the port (`rules push`) and one
  compiled by the reference's store and pushed by the port's client both
  install into the port's server as "pushed" (never-trust validation), and
  a scan under each digest finds that ruleset's custom rule, which the
  default lane does not;
* a YAML-only push compiles on the server; an unknown digest is a 404;
* `/admin/ruleset/reload` swaps at a batch boundary with no failed ticket;
* `fs --secret-backend server` prints the same report as a local `fs`.

Tolerance: exact.
"""

import json
import os
import textwrap
import threading

import pytest
import torch

from test_torch_engine import _fixture_tree
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.cache.store import MemoryCache
from trivy_tpu_torch.rpc.client import RpcClient, RpcError
from trivy_tpu_torch.rpc.server import start_background
from trivy_tpu_torch.serve import ServeConfig


def _rule_yaml(rule_id: str, prefix: str) -> str:
    return textwrap.dedent(f"""
        rules:
          - id: {rule_id}
            category: custom
            title: Push test token
            severity: critical
            regex: {prefix}-[a-f0-9]{{8}}
            keywords: [{prefix}-]
        """)


PORT_YAML = _rule_yaml("port-push-token", "PORTTOK")
REF_YAML = _rule_yaml("ref-push-token", "REFTOK")
SERVER_YAML = _rule_yaml("server-push-token", "SRVTOK")
FILES = [("a/creds.env", b"token = PORTTOK-deadbeef\n"),
         ("b/creds.env", b"token = REFTOK-cafef00d\n"),
         ("c/creds.env", b"token = SRVTOK-0badf00d\n"),
         ("d/plain.txt", b"nothing to see here\n")]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("push")
    # the default factory: a reload re-reads the server's secret-config
    httpd, _ = start_background(
        "localhost:0", MemoryCache(), serve_config=ServeConfig(batch_window_ms=20.0),
        rules_cache_dir=str(root / "server"), device="cpu")
    addr = f"{httpd.server_address[0]}:{httpd.server_address[1]}"
    try:
        yield addr, httpd.scan_server, root
    finally:
        httpd.scan_server.scheduler.close()
        httpd.shutdown()
        httpd.server_close()
        torch.set_num_threads(prev)


def _rule_ids(resp) -> list[str]:
    return [f["RuleID"] for s in resp["Secrets"] for f in s["Findings"]]


def _write(root, name, text) -> str:
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def test_port_and_reference_artifacts_install_and_route(server, capsys):
    from trivy_tpu.registry import store as ref_store
    from trivy_tpu.rules.model import build_ruleset as ref_build
    from trivy_tpu.rules.model import load_config as ref_load

    addr, scan_server, root = server
    port_cfg = _write(root, "port.yaml", PORT_YAML)
    assert cli.main(["rules", "push", "--server", addr, "--secret-config", port_cfg,
                     "--rules-cache-dir", str(root / "client")]) == 0
    out = capsys.readouterr().out
    assert "source=pushed" in out and "resident=True" in out
    port_digest = out.split("pushed ")[1].split()[0]

    ref_cfg = _write(root, "ref.yaml", REF_YAML)
    art, _ = ref_store.get_or_compile(ref_build(ref_load(ref_cfg)),
                                      cache_dir=str(root / "reference"))
    art_dir = os.path.join(str(root / "reference"), art.digest)
    with open(os.path.join(art_dir, ref_store.MANIFEST_JSON)) as f:
        manifest = json.load(f)
    assert manifest.get("jax_version")
    with open(os.path.join(art_dir, ref_store.ARTIFACT_NPZ), "rb") as f:
        npz = f.read()
    client = RpcClient(addr)
    resp = client.push_ruleset(rules_yaml=REF_YAML, manifest_json=manifest, npz=npz)
    assert resp == {"RulesetDigest": art.digest, "Source": "pushed", "Resident": True}

    resp = client.push_ruleset(rules_yaml=SERVER_YAML)
    assert resp["Source"] == "cold"
    server_digest = resp["RulesetDigest"]

    for digest, rule in ((port_digest, "port-push-token"), (art.digest, "ref-push-token"),
                         (server_digest, "server-push-token")):
        scanned = client.scan_secrets(FILES, ruleset_digest=digest)
        assert scanned["RulesetDigest"] == digest
        assert rule in _rule_ids(scanned)
    assert not {"port-push-token", "ref-push-token", "server-push-token"} & set(
        _rule_ids(client.scan_secrets(FILES)))
    assert scan_server.scheduler.pool.resident_count() == 3
    assert scan_server.scheduler.stats.errors == 0


def test_unknown_digest_is_404(server):
    addr, _, _ = server
    with pytest.raises(RpcError, match="HTTP 404"):
        RpcClient(addr).scan_secrets(FILES, ruleset_digest="f" * 64)


def test_reload_swaps_at_a_batch_boundary_without_failed_tickets(server):
    addr, scan_server, root = server
    sched = scan_server.scheduler
    client = RpcClient(addr)
    old = client.scan_secrets(FILES)
    errs, digests = [], []

    def fire(i):
        try:
            digests.append(client.scan_secrets(FILES, client_id=f"r{i}")["RulesetDigest"])
        except Exception as e:  # surfaced after join
            errs.append(e)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in threads[:4]:
        t.start()
    staged = client.call("/admin/ruleset/reload",
                         {"SecretConfigPath": _write(root, "reload.yaml", SERVER_YAML)})
    for t in threads[4:]:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    assert staged["Staged"] and staged["RulesetDigest"] != old["RulesetDigest"]
    new = client.scan_secrets(FILES)
    assert new["RulesetDigest"] == staged["RulesetDigest"]
    assert new["RulesetEpoch"] == old["RulesetEpoch"] + 1
    assert "server-push-token" in _rule_ids(new)
    assert set(digests) <= {old["RulesetDigest"], staged["RulesetDigest"]}
    assert sched.manager.reloads == 1 and sched.stats.errors == 0


def test_fs_server_backend_equals_local_fs(server, tmp_path, capsys):
    addr, _, _ = server
    _fixture_tree(tmp_path)
    assert cli.main(["fs", "--device", "cpu", "--rules-cache-dir", "off", str(tmp_path)]) == 0
    local = json.loads(capsys.readouterr().out)
    assert cli.main(["fs", "--secret-backend", "server", "--server", addr, str(tmp_path)]) == 0
    remote = json.loads(capsys.readouterr().out)
    assert remote == local and local["Results"]
