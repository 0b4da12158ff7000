"""The port's scan server (`trivy_tpu_torch/rpc/server.py`) against the
reference's (`trivy_tpu/rpc/server.py`), both in-process on free ports.

* The same `ScanSecrets` requests (seeded, numpy seed 21), sent
  concurrently by the reference's and then by the port's `RpcClient`, get
  equal `Secrets`/`Results`/`RulesetDigest`/`RulesetEpoch` JSON from both
  servers (no timing field is asked for: no Explain);
* the cache routes and `Scan` over a pushed blob answer alike;
* every debug route, `/healthz`, `/readyz`, `/version` and `/metrics`
  answer; protobuf bodies get the reference's answers;
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
    # The protobuf content type: a malformed body, ScanSecrets (JSON-only)
    # and a valid DeleteBlobs get the reference server's answers.
    answers = {}
    for name in ("port", "reference"):
        answers[name] = []
        for path, body in (("/twirp/trivy.cache.v1.Cache/PutBlob", b"\x00"),
                           ("/twirp/trivy.scanner.v1.Scanner/ScanSecrets", b""),
                           ("/twirp/trivy.cache.v1.Cache/DeleteBlobs", b"\x0a\x03abc")):
            req = urllib.request.Request(
                f"http://{addrs[name]}{path}", data=body,
                headers={"Content-Type": "application/protobuf"})
            try:
                with urllib.request.urlopen(req) as resp:
                    answers[name].append((resp.status, resp.read()))
            except urllib.error.HTTPError as e:
                answers[name].append((e.code, e.read()))
    assert answers["port"] == answers["reference"]
    assert [code for code, _ in answers["port"]] == [500, 415, 200]


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


def test_profile_window_merges_the_host_spans(servers):
    """With tracing on, the stop writes the window's host spans into the
    profiler's trace, on its clock, and `HostTrace` names that file."""
    from trivy_tpu_torch.obs import trace as obs_trace

    addrs, _, profile_dir = servers
    client = RpcClient(addrs["port"])
    obs_trace.clear()
    obs_trace.enable()
    try:
        client.call("/admin/profile/start", {})
        client.scan_secrets(seeded_tickets(3, n_tickets=1, per=2)[0])
        out = client.call("/admin/profile/stop", {})
    finally:
        obs_trace.disable()
        obs_trace.clear()
    assert out["HostTrace"] == out["DeviceTrace"]
    assert os.path.dirname(out["DeviceTrace"]) == profile_dir
    with open(out["DeviceTrace"]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "host_span"]
    assert {"rpc.scan_secrets", "batch"} <= {e["name"] for e in spans}
    marks = sorted((e for e in events if e.get("name") == obs_trace.CLOCK_MARK),
                   key=lambda e: e["ts"])
    lo, hi = marks[0]["ts"], marks[-1]["ts"] + marks[-1]["dur"]
    for e in spans:  # the start and stop calls straddle the window's edges
        if not e["name"].startswith("rpc.profile_"):
            assert lo - 50 <= e["ts"] and e["ts"] + e["dur"] <= hi + 50, e["name"]


def test_remote_options_build_a_server(servers, tmp_path):
    """The options that once raised build a server: a fleet member with a
    watch plane (over a result cache), and a protobuf client's calls
    answer as the reference server's."""
    from trivy_tpu.rpc.client import RpcClient as RefRpcClient
    from trivy_tpu_torch.cache.results import ScanResultCache

    fleet = tmp_path / "fleet.yaml"
    fleet.write_text(json.dumps({"members": [{"name": "a", "endpoint": "localhost:1"},
                                             {"name": "b", "endpoint": "localhost:2"}]}))
    feed = tmp_path / "feed.jsonl"
    feed.write_text("")
    watch = tmp_path / "watch.yaml"
    watch.write_text(json.dumps({"sources": [{"type": "feed", "path": str(feed)}]}))
    cache = MemoryCache()
    srv = port_server.ScanServer(cache, device="cpu", fleet_config=str(fleet),
                                 fleet_member="b", watch_config=str(watch),
                                 result_cache=ScanResultCache(cache))
    try:
        assert srv.fleet.name == "b" and srv.fleet_report()["self"] == "b"
        assert srv.watch_report()["enabled"] is True
    finally:
        srv.watch.close()
        srv.scheduler.close()
    addrs, _, _ = servers
    path = "/twirp/trivy.cache.v1.Cache/MissingBlobs"
    req = {"ArtifactID": "sha256:none", "BlobIDs": ["sha256:b1"]}
    got = RpcClient(addrs["port"], wire="protobuf").call(path, req)
    assert got == RefRpcClient(addrs["reference"], wire="protobuf").call(path, req)
    assert got == {"MissingArtifact": True, "MissingBlobIDs": ["sha256:b1"]}


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
