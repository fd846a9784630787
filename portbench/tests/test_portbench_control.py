"""The control of each cell (the plain reference one precision below the
configuration's, in the program's place) comes out not correct under the
cell's own limits."""

import pytest

from conftest import SEED, SMALL
from portbench import control, harness


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_control_is_not_correct(cell, seed):
    traffic, config = SMALL[cell]
    nums = control.readings(cell, seed, "cpu", traffic=traffic,
                            config=config)
    limits = harness.find_cell(harness.benchmark(), cell)["spec"]["limits"]
    assert nums and set(nums[0]) == set(limits)
    assert control.fails(nums, limits)
