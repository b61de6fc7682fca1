"""Each plain reference agrees with the program's plain CPU route at a tiny
size, within the cell's own limits. The test runs the program; the
reference never imports it."""

import pytest
import torch

from eigbench import harness, traffic
from eigbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_reference_agrees_with_the_program(name, seed):
    cell = tiny.cell(name)
    cfg, mix = cell.config, cell.mix
    builder = harness.load_plugin("builders", cfg["builder"])
    ref = harness.load_plugin("reference", mix["reference"])
    n = builder.size(cfg)
    ops = builder.operators(cfg, traffic.operator_seed(mix, seed), mix["pool"], "cpu")
    solve = harness.solver(mix, n)
    answers = []
    for index in range(3):
        op_index, inputs = traffic.solve_inputs(mix, seed, index, n, torch.float32, "cpu")
        answers.append((index, op_index, ref.answer(solve(ops[op_index], inputs))))
    widest = harness.judge(cell, seed, answers, "cpu")
    assert set(widest) == set(cell.spec["limits"])
    for key, limit in cell.spec["limits"].items():
        assert widest[key] <= limit, (key, widest[key], limit)
