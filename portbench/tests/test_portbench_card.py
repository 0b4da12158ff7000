"""The benchmark's own runs on the card: one short run of each cell, plain
and traced, through `portbench/run.py` as a check starts it.  Marked
`cuda`; each test skips where no card is present (`pytest -m cuda
portbench/tests` on the card)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]


def test_a_run_without_a_card_fails_without_a_result():
    """Where torch sees no card, the run exits non-zero and prints no result
    (here on the CPU; on a card machine the card is hidden from it)."""
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert not done.stdout.strip() or not done.stdout.strip().splitlines()[-1].startswith("{")
