"""Shared sizes: every cell at a size the CPU holds, through the rest of
a run (the harness's look for a chip skipped)."""

import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import harness  # noqa: E402

# (traffic, config) keys that shrink each cell for the CPU
SMALL = {
    "gbdt-higgs.dp4": ({}, {"n_rows": 4000}),
    "ring-rdma.rsag-f64-256M-n8": ({"length": 8 * 1024}, {}),
}
SEED = 2 ** 31 + 7


def small_run(name, seed=SEED, seconds=0.2, config=None):
    """One run of cell ``name`` on the CPU at its small size (``config``:
    keys that replace the small size's)."""
    traffic, small = SMALL[name]
    return harness.execute(name, seed, seconds, False, time.perf_counter(),
                           device="cpu", look_for_chips=False,
                           traffic=traffic, config={**small, **(config or {})})


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
