"""The generator: the same seed gives the same inputs, any whole number is
a seed, and a pool is solved in whole passes."""

import torch

from eigbench import traffic
from eigbench.tests import tiny


def test_same_seed_same_inputs():
    for seed in (0, 7, 2**31 + 3, 2**40 + 1, -5):
        a = traffic.start_vector(seed, 3, 100, torch.float32, "cpu")
        b = traffic.start_vector(seed, 3, 100, torch.float32, "cpu")
        assert torch.equal(a, b) and a.abs().max() <= 1
        assert not torch.equal(a, traffic.start_vector(seed, 4, 100, torch.float32, "cpu"))
    assert traffic.derive(2**31 + 3, 0, 1) != traffic.derive(2**31 + 4, 0, 1)


def test_pool_order_is_a_permutation_from_the_seed():
    orders = {tuple(traffic.pool_order(seed, 4)) for seed in range(40)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders) and len(orders) > 1
    assert traffic.pool_order(99, 4) == traffic.pool_order(99, 4)


def test_reservoir_repeats_for_a_seed():
    def sample(seed):
        r = traffic.Reservoir(5, seed)
        for i in range(200):
            r.offer(i, i)
        return [i for i, _ in r.items()]
    assert sample(3) == sample(3) and len(sample(3)) == 5
    assert sample(3) != sample(4)


def test_input_kinds_are_files_found_by_name():
    vector = {"inputs": "start_vector", "pool": 1}
    pool = {"inputs": "operator_pool", "pool": 4}
    op, kwargs = traffic.solve_inputs(vector, 5, 2, 10, torch.float32, "cpu")
    assert op == 0 and list(kwargs) == ["x0"]
    assert torch.equal(kwargs["x0"], traffic.start_vector(5, 2, 10, torch.float32, "cpu"))
    op, kwargs = traffic.solve_inputs(pool, 5, 2, 10, torch.float32, "cpu")
    assert op == traffic.pool_order(5, 4)[2] and kwargs == {}
    assert traffic.input_kind(vector).FRESH and not traffic.input_kind(pool).FRESH


def test_pool_is_solved_in_whole_passes():
    _, run = tiny.run("geev-f32-2048.eigvals", seconds=0.01)
    assert run.completed == 4 and run.correct
