"""The control: the plain reference computed in bfloat16 in the program's
place fails every compared number of each cell, at a test's size."""

import pytest

from conftest import SEED, tiny_cell
from portbench import control


@pytest.mark.parametrize("name,steps", [("node_base.viewer", 41),
                                        ("node_base.headless", 41),
                                        ("fuser_replica.orbit", 9)])
def test_bfloat16_reference_is_not_correct(name, steps):
    cell = tiny_cell(name)
    nums = control.control_numbers(cell, SEED, steps,
                                   cell.module.warm_up_steps(cell.config), "cpu")
    assert nums, name
    for key, value in nums.items():
        assert value is not None and value > cell.limits[key], (key, value)
