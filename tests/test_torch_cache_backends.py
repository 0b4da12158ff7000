"""The port's remote cache tiers (`trivy_tpu_torch/cache/redis.py`,
`cache/s3.py`) against in-process fakes, and against the reference's
tiers (`trivy_tpu/cache/`), on the CPU.

* the reference's five tests of `tests/test_cache_backends.py`, run
  against the port over the same fakes (its mini RESP server and mini S3
  endpoint, imported from that module);
* a document one package writes is the document the other reads, under
  the same keys, in both tiers;
* `fs --cache-backend redis://…|s3://…` through the port's CLI writes the
  reference CLI's report and the same cache keys;
* a server whose result cache runs over redis answers a repeated scan
  from the cache, with no second dispatch.

No network: every endpoint is a localhost fake.  Tolerance: exact.
"""

import contextlib
import io
import json
import socketserver
import threading
from http.server import ThreadingHTTPServer

import pytest

import test_cache_backends as ref_cb
from trivy_tpu_torch.atypes import ArtifactInfo, BlobInfo
from trivy_tpu_torch.cache.redis import RedisCache, RespClient
from trivy_tpu_torch.cache.s3 import S3Cache

_MiniRedisHandler = ref_cb._MiniRedisHandler
_MiniS3 = ref_cb._MiniS3



@pytest.fixture()
def redis_url():
    _MiniRedisHandler.store = {}
    srv = socketserver.ThreadingTCPServer(
        ("127.0.0.1", 0), _MiniRedisHandler
    )
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"redis://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_redis_cache_roundtrip(redis_url):
    cache = RedisCache(redis_url)
    info = ArtifactInfo(architecture="amd64", os_name="linux")
    blob = BlobInfo(diff_id="sha256:abc")
    cache.put_artifact("art1", info)
    cache.put_blob("blob1", blob)

    got = cache.get_artifact("art1")
    assert got is not None and got.architecture == "amd64"
    got_blob = cache.get_blob("blob1")
    assert got_blob is not None and got_blob.diff_id == "sha256:abc"
    assert cache.get_blob("missing") is None

    missing_artifact, missing = cache.missing_blobs(
        "art1", ["blob1", "blob2"]
    )
    assert missing_artifact is False
    assert missing == ["blob2"]

    cache.delete_blobs(["blob1"])
    assert cache.get_blob("blob1") is None
    cache.put_blob("blob3", blob)
    cache.clear()
    assert cache.get_blob("blob3") is None
    cache.close()


def test_resp_client_protocol_shapes(redis_url):
    c = RespClient(redis_url)
    assert c.command("PING") == "PONG"
    assert c.command("SET", "k", "v") == "OK"
    assert c.command("GET", "k") == b"v"
    assert c.command("GET", "nope") is None
    assert c.command("EXISTS", "k") == 1
    c.close()


@pytest.fixture()
def s3_cache(monkeypatch):
    _MiniS3.objects = {}
    _MiniS3.auth_headers = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _MiniS3)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    monkeypatch.setenv(
        "AWS_ENDPOINT_URL", f"http://127.0.0.1:{srv.server_address[1]}"
    )
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "testsecret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    yield S3Cache("s3://cache-bucket/trivy")
    srv.shutdown()
    srv.server_close()


def test_s3_cache_roundtrip(s3_cache):
    info = ArtifactInfo(architecture="arm64")
    blob = BlobInfo(diff_id="sha256:xyz")
    s3_cache.put_artifact("a1", info)
    s3_cache.put_blob("b1", blob)

    assert s3_cache.get_artifact("a1").architecture == "arm64"
    assert s3_cache.get_blob("b1").diff_id == "sha256:xyz"
    assert s3_cache.get_blob("nope") is None

    missing_artifact, missing = s3_cache.missing_blobs("a1", ["b1", "b2"])
    assert missing_artifact is False
    assert missing == ["b2"]

    s3_cache.delete_blobs(["b1"])
    assert s3_cache.get_blob("b1") is None

    # keys carry the prefix layout and requests are SigV4-signed
    assert any(k.startswith("/cache-bucket/trivy/") for k in _MiniS3.objects)
    assert all(
        h.startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/")
        for h in _MiniS3.auth_headers
    )


def test_cache_backend_selection(redis_url, tmp_path):
    from trivy_tpu_torch.cache.store import FSCache, MemoryCache
    from trivy_tpu_torch.cache.tiered import TieredCache
    from trivy_tpu_torch.commands.run import Options, init_cache

    # Remote backends sit behind local tiers now: memory first (FS too
    # when --cache-dir is set), the remote last.
    cache = init_cache(Options(cache_backend=redis_url))
    assert isinstance(cache, TieredCache)
    backends = [t.backend for t in cache.tiers]
    assert isinstance(backends[0], MemoryCache)
    assert isinstance(backends[-1], RedisCache)
    cache.close()

    cache = init_cache(
        Options(cache_backend=redis_url, cache_dir=str(tmp_path))
    )
    assert [type(t.backend) for t in cache.tiers] == [
        MemoryCache, FSCache, RedisCache,
    ]
    cache.close()

    assert isinstance(
        init_cache(Options(cache_backend="memory")), MemoryCache
    )
    fs_tiers = init_cache(
        Options(cache_backend="fs", cache_dir=str(tmp_path))
    )
    assert isinstance(fs_tiers, TieredCache)
    assert [type(t.backend) for t in fs_tiers.tiers] == [
        MemoryCache, FSCache,
    ]
    fs_tiers.close()


def test_scan_through_redis_cache(redis_url, tmp_path):
    """End to end: an fs secret scan caches its blobs in redis."""
    from trivy_tpu_torch.__main__ import main

    (tmp_path / "x.py").write_text('token = "ghp_' + "A" * 36 + '"\n')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "fs", "--scanners", "secret", "--format", "json", "--device", "cpu",
            "--rules-cache-dir", "off", "--cache-backend", redis_url, str(tmp_path),
        ])
    assert rc == 0
    assert json.loads(buf.getvalue())["Results"]
    assert any(
        k.startswith(b"fanal::blob::") for k in _MiniRedisHandler.store
    )


# -- the port against the reference ------------------------------------------


def _docs(pkg_atypes):
    return (pkg_atypes.ArtifactInfo(architecture="amd64", os_name="linux"),
            pkg_atypes.BlobInfo(diff_id="sha256:abc", opaque_dirs=["var/"]))


@pytest.mark.parametrize("tier", ["redis", "s3"])
def test_documents_cross_packages(tier, redis_url, monkeypatch):
    """What one package's tier writes, the other's reads: the same keys and
    the same bytes, both ways."""
    from trivy_tpu import atypes as ref_atypes
    from trivy_tpu.cache.redis import RedisCache as RefRedisCache
    from trivy_tpu.cache.s3 import S3Cache as RefS3Cache
    from trivy_tpu_torch import atypes

    if tier == "redis":
        make = {"port": lambda: RedisCache(redis_url), "ref": lambda: RefRedisCache(redis_url)}

        def stored():
            return dict(_MiniRedisHandler.store)
    else:
        _MiniS3.objects = {}
        _MiniS3.auth_headers = []
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _MiniS3)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        for k, v in (("AWS_ENDPOINT_URL", f"http://127.0.0.1:{srv.server_address[1]}"),
                     ("AWS_ACCESS_KEY_ID", "AKIATEST"),
                     ("AWS_SECRET_ACCESS_KEY", "testsecret"), ("AWS_REGION", "us-east-1")):
            monkeypatch.setenv(k, v)
        make = {"port": lambda: S3Cache("s3://cache-bucket/trivy"),
                "ref": lambda: RefS3Cache("s3://cache-bucket/trivy")}

        def stored():
            return dict(_MiniS3.objects)
    try:
        written = {}
        for writer, types in (("port", atypes), ("ref", ref_atypes)):
            cache = make[writer]()
            cache.clear()
            info, blob = _docs(types)
            cache.put_artifact("art1", info)
            cache.put_blob("blob1", blob)
            cache.close()
            written[writer] = stored()
            reader = make["ref" if writer == "port" else "port"]()
            assert reader.get_artifact("art1").to_json() == info.to_json()
            assert reader.get_blob("blob1").to_json() == blob.to_json()
            assert reader.missing_blobs("art1", ["blob1", "blob2"]) == (False, ["blob2"])
            reader.close()
        assert written["port"] == written["ref"] and len(written["port"]) == 2
    finally:
        if tier == "s3":
            srv.shutdown()
            srv.server_close()


def _cli(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("tier", ["redis", "s3"])
def test_fs_report_and_keys_equal_the_reference_cli(tier, redis_url, tmp_path, monkeypatch):
    """`fs --cache-backend redis://…|s3://…`: the port's report is the
    reference CLI's, and its cache holds the same keys."""
    from trivy_tpu import cli as ref_cli
    from trivy_tpu_torch import __main__ as cli

    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "x.py").write_text('token = "ghp_' + "A" * 36 + '"\n')
    (tree / "requirements.txt").write_text("flask==2.0.1\nrequests==2.25.0\n")
    if tier == "redis":
        backend = redis_url

        def keys():
            return sorted(_MiniRedisHandler.store)

        def clear():
            _MiniRedisHandler.store.clear()
    else:
        _MiniS3.objects = {}
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _MiniS3)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        for k, v in (("AWS_ENDPOINT_URL", f"http://127.0.0.1:{srv.server_address[1]}"),
                     ("AWS_ACCESS_KEY_ID", "AKIATEST"),
                     ("AWS_SECRET_ACCESS_KEY", "testsecret"), ("AWS_REGION", "us-east-1")):
            monkeypatch.setenv(k, v)
        backend = "s3://cache-bucket/trivy"

        def keys():
            return sorted(_MiniS3.objects)

        def clear():
            _MiniS3.objects.clear()
    try:
        argv = ["fs", "--scanners", "vuln,secret", "-f", "json", "--rules-cache-dir", "off",
                "--secret-backend", "cpu", "--cache-backend", backend, str(tree)]
        port = _cli(cli.main, [*argv[:1], "--device", "cpu", *argv[1:]])
        port_keys = keys()
        clear()
        ref = _cli(ref_cli.main, argv)
        assert port == ref and json.loads(port)["Results"]
        assert port_keys == keys() and port_keys
    finally:
        if tier == "s3":
            srv.shutdown()
            srv.server_close()


def test_an_unreachable_tier_fails_like_the_reference(tmp_path):
    """A redis tier that refuses the connection fails the command at cache
    construction in both CLIs, with the same error."""
    from trivy_tpu import cli as ref_cli
    from trivy_tpu_torch import __main__ as cli

    probe = socketserver.TCPServer(("127.0.0.1", 0), socketserver.BaseRequestHandler)
    dead = f"redis://127.0.0.1:{probe.server_address[1]}"
    probe.server_close()
    (tmp_path / "x.py").write_text('token = "ghp_' + "A" * 36 + '"\n')
    argv = ["fs", "--scanners", "secret", "-f", "json", "--rules-cache-dir", "off",
            "--secret-backend", "cpu", "--cache-backend", dead, str(tmp_path)]
    errors = []
    for main, args in ((cli.main, [*argv[:1], "--device", "cpu", *argv[1:]]),
                       (ref_cli.main, argv)):
        with pytest.raises(ConnectionRefusedError) as ei:
            _cli(main, args)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def test_server_result_cache_over_redis(redis_url):
    """`server --cache-backend redis://…`: the result cache's verdicts live
    in redis, a repeated request is answered from it with no second
    dispatch, and both answers are the reference server's."""
    from trivy_tpu.cache import build_cache as ref_build_cache
    from trivy_tpu.cache.results import ScanResultCache as RefScanResultCache
    from trivy_tpu.engine.oracle import OracleScanner as RefOracle
    from trivy_tpu.rpc import server as ref_server
    from trivy_tpu_torch.cache import build_cache
    from trivy_tpu_torch.cache.results import ScanResultCache
    from trivy_tpu_torch.engine.oracle import OracleScanner
    from trivy_tpu_torch.rpc import server as port_server
    from trivy_tpu_torch.rpc.client import RpcClient

    class Counting:
        def __init__(self, oracle):
            self.oracle, self.calls = oracle, 0
            self.ruleset = oracle.ruleset

        def scan_batch(self, items):
            self.calls += 1
            return [self.oracle.scan(path, content) for path, content in items]

    items = [("a/creds.env", b'tok = "ghp_' + b"B" * 36 + b'"\n'),
             ("a/plain.txt", b"nothing here at all\n")]
    answers = {}
    for name, srv, build, results, oracle, kw in (
            ("port", port_server, build_cache, ScanResultCache, OracleScanner,
             {"device": "cpu"}),
            ("reference", ref_server, ref_build_cache, RefScanResultCache, RefOracle, {})):
        _MiniRedisHandler.store.clear()
        engine = Counting(oracle())
        cache = build(redis_url)
        httpd, _ = srv.start_background(
            "localhost:0", cache, serve_config=srv.ServeConfig(batch_window_ms=0.0),
            secret_engine_factory=lambda engine=engine: engine,
            result_cache=results(cache), **kw)
        try:
            client = RpcClient(f"localhost:{httpd.server_address[1]}")
            first = client.scan_secrets(items)
            assert cache.flush()
            second = client.scan_secrets(items)
            assert engine.calls == 1, name
            assert any(k.startswith(b"fanal::") for k in _MiniRedisHandler.store)
            answers[name] = (first, second, sorted(_MiniRedisHandler.store))
        finally:
            httpd.scan_server.scheduler.close()
            httpd.shutdown()
            httpd.server_close()
            cache.close()
    assert answers["port"] == answers["reference"]
    assert answers["port"][0]["Secrets"][0]["Findings"]
