"""`correct` has to fail where it should, on the CPU at a size a test run
holds: a whole run of the harness, everything but the card, with the
control (the reference with its secret-group spans broken) in the engine's
place on three seeds of each cell, and with the timed path broken
underneath in each way a secret scan can be."""

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.control import control_run
from trivy_tpu_torch.ftypes import Secret


@pytest.mark.parametrize("cell,n_files", [("default.config-tree", 300)])
def test_control_comes_out_not_correct(cell, n_files):
    """The control's answers, in the engine's place, through the window,
    the batch records and the comparison that decides `correct`."""
    for seed in (1, 2_147_483_659, 3_000_000_021):
        result = control_run(cell, seed, 0.5, n_workers=2, device="cpu",
                             traffic_overrides={"n_files": n_files}, reference_workers=2)
        assert not result["correct"], result
        number = result["compared"]["mismatched_files"]
        assert number["value"] > number["limit"], result


class Stale:
    """A step that returns its state unchanged: every call after the first
    answers with the first call's results."""

    def __init__(self, engine):
        self.engine, self.first = engine, None

    def scan_batch(self, items):
        res = self.engine.scan_batch(items)
        if self.first is None:
            self.first = res
        return self.first


class Half:
    """Half of the batch left out: only the first half is answered."""

    def __init__(self, engine):
        self.engine = engine

    def scan_batch(self, items):
        return self.engine.scan_batch(items[: len(items) // 2])


class HalfEmpty(Half):
    """Half of the batch left out, its answers filled in empty."""

    def scan_batch(self, items):
        k = len(items) // 2
        return super().scan_batch(items) + [Secret() for _ in items[k:]]


class Altered:
    """An answer altered where it is produced: the first finding of each
    batch one line off."""

    def __init__(self, engine):
        self.engine = engine

    def scan_batch(self, items):
        res = self.engine.scan_batch(items)
        for secret in res:
            if secret.findings:
                secret.findings[0].start_line += 1
                break
        return res


def drive(capsys, fault=None) -> dict:
    """A run of the config tree on the CPU, its engine wrapped in `fault`, if any."""
    cell = "default.config-tree"
    program = None
    if fault is not None:
        ent = harness.entry(harness.load_cell(cell).config)
        program = SimpleNamespace(build=lambda *args: fault(ent.build(*args)), scan=ent.scan,
                                  keep=ent.keep, answer=ent.answer)
    rc = harness.run(cell, 2_147_483_659, 1.0, False, t0=time.perf_counter(),
                     device="cpu", traffic_overrides={"n_files": 300}, program=program,
                     reference_workers=2)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    result = drive(capsys)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 300
    assert result["compared"]["mismatched_files"] == {"value": 0, "limit": 0}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault,number", [(Stale, "mismatched_files"),
                                          (Half, "missing_files"),
                                          (HalfEmpty, "mismatched_files"),
                                          (Altered, "mismatched_files")])
def test_a_broken_timed_path_is_not_correct(capsys, fault, number):
    result = drive(capsys, fault)
    assert not result["correct"] and result["failed"] > 0
    assert result["compared"][number]["value"] > result["compared"][number]["limit"]
