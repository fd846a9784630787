"""A short window of each one-chip cell on a card, as the driver runs it.
Skips where no CUDA card is visible (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import REPO
from portbench import harness

pytestmark = pytest.mark.gpu
ONE_CHIP = [w["name"] for w in harness.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.parametrize("cell", ONE_CHIP)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 101), "--seconds", "2",
                        "--trace", str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
