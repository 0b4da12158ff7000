"""Chaos suite of the port's serving path, in the style of
`tests/test_chaos_serve.py`: with faults armed on the dispatch boundary the
port's scheduler keeps findings byte-identical to an unfaulted run, loses no
ticket, opens its breaker under sustained failure and re-closes it once the
fault clears, sheds an OOM by splitting the batch, and its server and client
ride out connection resets.  An engine on a card keeps only its device
rungs: it never runs a batch on the host, its batches are shed with 503
while the breaker is open, and a batch whose device rungs all fail fails.

Engines are the port's on the CPU (the hybrid's host rung, the device
engine's staged rung under the megakernel), and fakes: one with a host
path, and one that reports a CUDA device (the ladder reads only
`device.type`; nothing runs on a card).  The fault schedules are armed
programmatically (`faults.configure`, seeded), as the reference's suite
does.  Tolerance: exact.
"""

import threading
import time

import pytest
import torch

from test_torch_serve_scheduler import doc, seeded_tickets
from trivy_tpu_torch import faults
from trivy_tpu_torch.engine.device import GpuSecretEngine
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.serve import BatchScheduler, BreakerOpenError, ServeConfig

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _disarm():
    """No fault profile outlives its test."""
    yield
    faults.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hybrid():
    return make_secret_engine(device="cpu")


class FlakyEngine:
    """Fake engine with a host path: scan_batch raises `fail_with` for the
    first `fail_n` calls, then succeeds; scan_batch_host always succeeds."""

    def __init__(self, fail_n=0, fail_with=None):
        self.fail_n = fail_n
        self.fail_with = fail_with or RuntimeError("injected device failure")
        self.calls = 0
        self.host_calls = 0
        self._lock = threading.Lock()

    def scan_batch(self, items):
        with self._lock:
            self.calls += 1
            if self.calls <= self.fail_n:
                raise self.fail_with
        return [Secret(file_path=p) for p, _ in items]

    def scan_batch_host(self, items):
        with self._lock:
            self.host_calls += 1
        return [Secret(file_path=p) for p, _ in items]


class CardEngine(FlakyEngine):
    """FlakyEngine that reports a CUDA device and has the fused-verify
    engine's legacy device rung, which fails when `legacy_fails`."""

    device = torch.device("cuda")
    verify = "fused"

    def __init__(self, fail_n=0, fail_with=None, legacy_fails=False):
        super().__init__(fail_n, fail_with)
        self.legacy_fails = legacy_fails
        self.legacy_calls = 0

    def scan_batch_device_legacy(self, items):
        with self._lock:
            self.legacy_calls += 1
        if self.legacy_fails:
            raise RuntimeError("injected legacy-rung failure")
        return [Secret(file_path=p) for p, _ in items]


def _run(sched, tickets):
    try:
        futures = [sched.submit(items, client_id=f"client{r}")
                   for r, items in enumerate(tickets)]
        return [doc(f.result(timeout=120)) for f in futures]
    finally:
        faults.clear()
        sched.drain(timeout=30)


@pytest.mark.parametrize("engine_kind", ["hybrid", "device"])
def test_findings_byte_identical_under_dispatch_fault_every_batch(hybrid, engine_kind):
    """`sched.dispatch:error@1`: every batch fails at dispatch and is
    absorbed by the next rung (the hybrid's host DFA, the device engine's
    staged sieve) with byte-identical findings and no lost ticket."""
    engine = hybrid if engine_kind == "hybrid" else GpuSecretEngine(
        device="cpu", tile_len=512, megakernel=True)
    tickets = seeded_tickets(31, n_tickets=5, per=3)
    clean = [doc(engine.scan_batch(items)) for items in tickets]
    faults.configure("sched.dispatch:error@1")
    sched = BatchScheduler(lambda: engine, ServeConfig(batch_window_ms=40.0))
    assert _run(sched, tickets) == clean
    assert sched.stats.degraded_batches == sched.stats.batches >= 1
    assert sched.stats.errors == 0
    assert any('"RuleID"' in d for d in clean)


def test_breaker_opens_then_recloses_when_fault_clears():
    eng = FlakyEngine()
    faults.configure("sched.dispatch:error@1x3")
    sched = BatchScheduler(lambda: eng, ServeConfig(
        batch_window_ms=0.0, breaker_threshold=3, breaker_cooldown_s=0.05))
    try:
        for i in range(3):
            sched.submit([(f"a{i}.txt", b"x")]).result(timeout=10)
        assert sched.breaker.snapshot()["state"] == "open"
        assert sched.readiness()["ready"] is False
        host_before = eng.host_calls
        sched.submit([("open.txt", b"x")]).result(timeout=10)
        assert eng.host_calls > host_before
        time.sleep(0.08)
        sched.submit([("probe.txt", b"x")]).result(timeout=10)
        snap = sched.breaker.snapshot()
        assert snap["state"] == "closed"
        assert snap["opened_total"] == 1 and snap["reclosed_total"] == 1
        assert sched.readiness()["ready"] is True
        assert sched.stats.degraded_batches >= 4
        assert sched.stats.errors == 0
    finally:
        faults.clear()
        sched.drain(timeout=10)


def test_oom_sheds_and_retries_on_device():
    eng = FlakyEngine(fail_n=1, fail_with=faults.InjectedOom("RESOURCE_EXHAUSTED: injected"))
    sched = BatchScheduler(lambda: eng, ServeConfig(batch_window_ms=0.0))
    try:
        out = sched.submit([("a.txt", b"x"), ("b.txt", b"y")]).result(timeout=10)
        assert [s.file_path for s in out] == ["a.txt", "b.txt"]
        assert sched.stats.shed_retries == 1
        assert sched.stats.degraded_batches == 0 and eng.host_calls == 0
        assert sched.breaker.snapshot()["state"] == "closed"
    finally:
        sched.drain(timeout=10)


def test_oom_that_survives_shedding_degrades_to_host():
    eng = FlakyEngine(fail_n=99, fail_with=faults.InjectedOom("RESOURCE_EXHAUSTED: injected"))
    sched = BatchScheduler(lambda: eng, ServeConfig(batch_window_ms=0.0))
    try:
        out = sched.submit([("a.txt", b"x"), ("b.txt", b"y")]).result(timeout=10)
        assert [s.file_path for s in out] == ["a.txt", "b.txt"]
        assert sched.stats.shed_retries == 1
        assert sched.stats.degraded_batches == 1 and eng.host_calls == 1
    finally:
        sched.drain(timeout=10)


def test_card_engine_never_runs_on_the_host():
    """`sched.dispatch:error@1x3` on a card engine: three batches step down
    to the legacy device rung, the breaker opens, the next batch is shed
    with BreakerOpenError (not run on the host), and the half-open probe
    after the cooldown runs on the device and re-closes the breaker."""
    eng = CardEngine()
    faults.configure("sched.dispatch:error@1x3")
    sched = BatchScheduler(lambda: eng, ServeConfig(
        batch_window_ms=0.0, breaker_threshold=3, breaker_cooldown_s=0.05))
    try:
        for i in range(3):
            out = sched.submit([(f"a{i}.txt", b"x")]).result(timeout=10)
            assert [s.file_path for s in out] == [f"a{i}.txt"]
        assert eng.legacy_calls == 3
        assert sched.breaker.snapshot()["state"] == "open"
        with pytest.raises(BreakerOpenError):
            sched.submit([("open.txt", b"x")]).result(timeout=10)
        assert sched.stats.breaker_rejected == 1
        time.sleep(0.08)
        sched.submit([("probe.txt", b"x")]).result(timeout=10)
        snap = sched.breaker.snapshot()
        assert snap["state"] == "closed" and snap["reclosed_total"] == 1
        assert eng.host_calls == 0
        assert sched.stats.degraded_batches == 3 and sched.stats.errors == 0
    finally:
        faults.clear()
        sched.drain(timeout=10)


@pytest.mark.parametrize("fail_with", [
    RuntimeError("injected device failure"),
    faults.InjectedOom("RESOURCE_EXHAUSTED: injected"),
], ids=["error", "oom"])
def test_card_batch_fails_when_its_device_rungs_fail(fail_with):
    """A card engine whose device and legacy rungs all fail (an OOM after
    shedding too) fails the batch with the device's error; the host path
    is never called."""
    eng = CardEngine(fail_n=99, fail_with=fail_with, legacy_fails=True)
    sched = BatchScheduler(lambda: eng, ServeConfig(batch_window_ms=0.0))
    try:
        fut = sched.submit([("a.txt", b"x"), ("b.txt", b"y")])
        with pytest.raises(type(fail_with)):
            fut.result(timeout=10)
        assert eng.host_calls == 0 and eng.legacy_calls == 1
        assert sched.stats.errors == 1 and sched.stats.degraded_batches == 0
    finally:
        sched.drain(timeout=10)


def test_card_server_answers_503_while_the_breaker_is_open():
    """Through the port's server: a card engine behind an open breaker
    gets 503 with the breaker's cooldown as Retry-After."""
    from trivy_tpu_torch.cache.store import MemoryCache
    from trivy_tpu_torch.rpc.client import RpcClient, RpcError
    from trivy_tpu_torch.rpc.server import start_background

    eng = CardEngine()
    httpd, _ = start_background(
        "localhost:0", MemoryCache(), secret_engine_factory=lambda: eng, device="cpu",
        serve_config=ServeConfig(batch_window_ms=0.0, breaker_threshold=1,
                                 breaker_cooldown_s=30.0))
    client = RpcClient(f"{httpd.server_address[0]}:{httpd.server_address[1]}",
                       max_retries=0)
    faults.configure("sched.dispatch:error@1x1")
    try:
        assert client.scan_secrets([("a.txt", b"x")])["Secrets"] is not None
        with pytest.raises(RpcError):
            client.scan_secrets([("b.txt", b"y")])
        assert client.last_error_status == 503
        assert client.last_error_retry_after == 30.0
        assert eng.host_calls == 0 and eng.legacy_calls == 1
        assert httpd.scan_server.breaker_report()["breaker_rejected"] == 1
    finally:
        faults.clear()
        httpd.scan_server.scheduler.close()
        httpd.shutdown()
        httpd.server_close()


def test_rpc_reset_chaos_all_requests_complete(hybrid):
    """`rpc.serve:reset@0.2`: the port's server drops ~1 in 5 connections
    mid-request; the port's client retries every one and findings match a
    local scan."""
    from trivy_tpu_torch.cache.store import MemoryCache
    from trivy_tpu_torch.rpc import client as rpc_client
    from trivy_tpu_torch.rpc.client import RemoteSecretEngine, RetryBudget
    from trivy_tpu_torch.rpc.server import start_background

    items = seeded_tickets(8, n_tickets=1, per=4)[0]
    expected = doc(hybrid.scan_batch(items))
    httpd, _ = start_background("localhost:0", MemoryCache(),
                                secret_engine_factory=lambda: hybrid, device="cpu")
    addr = f"{httpd.server_address[0]}:{httpd.server_address[1]}"
    rpc_client.reset_retry_budget(RetryBudget(min_floor=100))
    remote = RemoteSecretEngine(addr)
    faults.configure("rpc.serve:reset@0.2", seed=1)
    try:
        for _ in range(10):
            assert doc(remote.scan_batch(items)) == expected
        assert rpc_client.client_retries_total() >= 1
    finally:
        faults.clear()
        rpc_client.reset_retry_budget()
        httpd.scan_server.scheduler.close()
        httpd.shutdown()
        httpd.server_close()
