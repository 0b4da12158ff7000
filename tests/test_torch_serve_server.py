"""The port's scan server (`trivy_tpu_torch/rpc/server.py`) against the
reference's (`trivy_tpu/rpc/server.py`), both in-process on free ports.

* The same `ScanSecrets` requests (seeded, numpy seed 21), sent
  concurrently by the reference's and then by the port's `RpcClient`, get
  equal `Secrets`/`Results`/`RulesetDigest`/`RulesetEpoch` JSON from both
  servers (no timing field is asked for: no Explain);
* the cache routes and `Scan` over a pushed blob answer alike;
* every debug route, `/healthz`, `/readyz`, `/version` and `/metrics`
  answer; the protobuf content type gets the reference's 415;
* the profile window (`/admin/profile/start|stop`, `torch.profiler`)
  writes a Chrome trace on the CPU.

The reference hybrid prices its gate with `TRIVY_TPU_LINK=relay`, as
`tests/test_serve_smoke.py` runs it.  Tolerance: exact.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_serve_scheduler import seeded_tickets
from trivy_tpu.cache.store import MemoryCache as RefMemoryCache
from trivy_tpu.rpc import server as ref_server
from trivy_tpu.rpc.client import RpcClient as RefClient
from trivy_tpu_torch.atypes import BlobInfo
from trivy_tpu_torch.cache.store import MemoryCache
from trivy_tpu_torch.engine.oracle import OracleScanner
from trivy_tpu_torch.ftypes import secret_to_json
from trivy_tpu_torch.rpc import server as port_server
from trivy_tpu_torch.rpc.client import RemoteCache, RemoteDriver, RpcClient, RpcError
from trivy_tpu_torch.scanner.service import ScanOptions
from trivy_tpu_torch.serve import ServeConfig


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIVY_TPU_LINK", "relay")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profile_dir = str(tmp_path_factory.mktemp("profile"))
    port, _ = port_server.start_background(
        "localhost:0", MemoryCache(), serve_config=ServeConfig(batch_window_ms=60.0),
        device="cpu", profile_dir=profile_dir)
    ref, _ = ref_server.start_background(
        "localhost:0", RefMemoryCache(), serve_config=ref_server.ServeConfig(
            batch_window_ms=60.0))
    addrs = {name: f"{h.server_address[0]}:{h.server_address[1]}"
             for name, h in (("port", port), ("reference", ref))}
    try:
        yield addrs, port.scan_server, profile_dir
    finally:
        for h in (port, ref):
            h.scan_server.scheduler.close()
            h.shutdown()
            h.server_close()
        torch.set_num_threads(prev)
        mp.undo()


def _fire(client, tickets) -> list[dict]:
    out = [None] * len(tickets)
    errs = []

    def one(i):
        try:
            out[i] = client.scan_secrets(tickets[i], client_id=f"c{i}")
        except Exception as e:  # surfaced after join
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(tickets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    return out


def test_scan_secrets_equal_reference_server(servers):
    addrs, scan_server, _ = servers
    tickets = seeded_tickets(21, n_tickets=6, per=3)
    oracle = OracleScanner()
    docs = {}
    for client_cls in (RefClient, RpcClient):
        for name, addr in addrs.items():
            resps = _fire(client_cls(addr), tickets)
            docs[(client_cls.__module__, name)] = json.dumps(resps, sort_keys=True)
            for items, resp in zip(tickets, resps):
                assert resp["Secrets"] == [secret_to_json(oracle.scan(p, c)) for p, c in items]
    assert len(set(docs.values())) == 1
    assert '"RuleID"' in next(iter(docs.values()))
    assert scan_server.scheduler.stats.multi_request_batches >= 1
    assert scan_server.scheduler.stats.degraded_batches == 0


def test_cache_routes_and_scan_equal_reference(servers):
    addrs, _, _ = servers
    items = seeded_tickets(4, n_tickets=1, per=4)[0]
    secrets = OracleScanner().scan_batch(items)
    blob = BlobInfo(digest="sha256:abc", diff_id="sha256:def", secrets=secrets)
    got = {}
    for name, addr in addrs.items():
        cache = RemoteCache(addr)
        assert cache.missing_blobs("art", ["blob1"]) == (True, ["blob1"])
        cache.put_blob("blob1", blob)
        assert cache.missing_blobs("art", ["blob1"]) == (True, [])
        results, os_found = RemoteDriver(addr).scan(
            "target", "art", ["blob1"], ScanOptions(scanners=["secret"]))
        assert os_found is None
        got[name] = [r.to_json() for r in results]
        cache.delete_blobs(["blob1"])
        assert cache.missing_blobs("art", ["blob1"]) == (True, ["blob1"])
    assert got["port"] == got["reference"]
    assert any(r.get("Secrets") for r in got["port"])
    # the reference's default scanners (vuln among them) over a server
    # with no DB: the secrets, no vulnerabilities, as there
    for name, addr in addrs.items():
        RemoteCache(addr).put_blob("blob2", blob)
        results, _ = RemoteDriver(addr).scan("t", "art", ["blob2"], ScanOptions())
        got[name] = [r.to_json() for r in results]
    assert got["port"] == got["reference"] and got["port"]


def _get(addr, route):
    try:
        with urllib.request.urlopen(f"http://{addr}{route}") as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_every_debug_route_answers(servers):
    addrs, _, _ = servers
    addr = addrs["port"]
    assert set(port_server.DEBUG_SURFACES) == set(ref_server.DEBUG_SURFACES)
    for route in port_server.DEBUG_SURFACES:
        code, body = _get(addr, route)
        assert code == 200, route
        assert isinstance(json.loads(body), dict), route
    for route in ("/debug/fleet", "/debug/watch"):
        assert json.loads(_get(addr, route)[1]) == {"enabled": False}
    assert json.loads(_get(addr, "/debug")[1])["surfaces"] == port_server.DEBUG_SURFACES
    assert _get(addr, "/healthz") == (200, b"ok")
    code, body = _get(addr, "/readyz")
    assert code == 200 and json.loads(body)["checks"]["breaker"] == "closed"
    assert json.loads(_get(addr, "/version")[1]) == {"Version": port_server.__version__}
    mesh = json.loads(_get(addr, "/debug/mesh")[1])
    assert mesh["devices"] == 1 and mesh["plan"]
    metrics = _get(addr, "/metrics")[1].decode()
    for family in ("trivy_tpu_requests_total", "trivy_tpu_serve_batches_total",
                   "trivy_tpu_mesh_devices 1", "trivy_tpu_build_info"):
        assert family in metrics, family
    assert _get(addr, "/nope")[0] == 404
    req = urllib.request.Request(
        f"http://{addr}/twirp/trivy.cache.v1.Cache/PutBlob", data=b"\x00",
        headers={"Content-Type": "application/protobuf"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 415 and b"protobuf wire unavailable" in ei.value.read()


def test_profile_window_writes_a_trace_on_the_cpu(servers):
    addrs, _, profile_dir = servers
    client = RpcClient(addrs["port"])
    with pytest.raises(RpcError, match="400"):
        client.call("/admin/profile/stop", {})
    assert client.call("/admin/profile/start", {}) == {
        "Profiling": True, "ProfileDir": profile_dir}
    with pytest.raises(RpcError, match="already active"):
        client.call("/admin/profile/start", {})
    client.scan_secrets(seeded_tickets(2, n_tickets=1, per=2)[0])
    out = client.call("/admin/profile/stop", {})
    assert out["Profiling"] is False and os.path.dirname(out["DeviceTrace"]) == profile_dir
    with open(out["DeviceTrace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_not_ported_options_raise():
    for kw, item in (({"fleet_config": "fleet.yaml"}, "fleet"),
                     ({"watch_config": "watch.yaml"}, "watch")):
        with pytest.raises(ValueError, match=f"{item} is not ported yet .ROADMAP A13c"):
            port_server.ScanServer(MemoryCache(), device="cpu", **kw)
    with pytest.raises(RpcError, match="A13c"):
        RpcClient("localhost:1", wire="protobuf").call("/x", {})


def test_cli_server_on_the_cpu_only_when_asked():
    """`python -m trivy_tpu_torch server --device cpu` serves; without
    `--device` it asks for the card, which a host without one refuses at
    start."""
    from trivy_tpu_torch import __main__ as cli

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["server", "--listen", "localhost:0"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "server", "--device", "cpu",
         "--listen", "localhost:0", "--rules-cache-dir", "off"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("trivy-tpu server listening on "), proc.stderr.read()
        addr = line.split()[-1]
        resp = RpcClient(addr).scan_secrets(seeded_tickets(6, n_tickets=1, per=3)[0])
        assert len(resp["Secrets"]) == 3 and resp["RulesetDigest"]
        proc.send_signal(signal.SIGTERM)  # drain, then exit
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
