"""The command on the card: each cell runs briefly and is correct, and
its control is not. Run on the chip with
``python -m pytest -q -m cuda canalbench/test_canalbench_card.py``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from canalbench import harness

ROOT = Path(__file__).resolve().parent.parent
CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


def _run(name, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "canalbench.run", "--workload", name,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0",
         *extra], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    out = _run(name, "--control", "depth")
    assert not out["correct"], out["checks"]
