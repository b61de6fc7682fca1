"""The control, the plain reference in the next lower precision put in the
program's place, fails the cell's check, on three seeds."""

import pytest

from eigbench import control
from eigbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    cell = tiny.cell(name)
    for seed in (3, 4, 2**32 + 5):
        if "pool_seed" in cell.mix:  # a fixed pool: draw other operators too
            cell.mix["pool_seed"] = seed
        widest = control.control_numbers(cell, seed, "cpu")
        assert any(not widest[k] <= lim for k, lim in cell.spec["limits"].items()), (seed, widest)
