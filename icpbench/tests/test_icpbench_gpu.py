"""On the card: a short run of every cell is correct, and the control (the
reference in TF32 in the program's place) at the cells' own sizes is not.
Each test skips without a card, decided inside the fixture."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _last_json(args):
    res = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    (out,) = _last_json(["icpbench/run.py", "--workload", cell, "--seed", "2147483711",
                         "--seconds", "3", "--trace", "0"])[-1:]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_full_size(card, cell):
    rows = _last_json(["icpbench/calibrate.py", "--workload", cell, "--seeds", "3",
                       "--mode", "control"])
    assert rows and all(r["correct"] is False for r in rows)
