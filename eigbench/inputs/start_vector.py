"""A fresh start vector a solve, passed as ``x0=``: n entries uniform in
[-1, 1), drawn from ``(seed, index)``; the operator is the same for all
solves (``pool`` 1)."""

from eigbench import traffic

FRESH = True


def draw(mix: dict, seed: int, index: int, n: int, dtype, device):
    return index % mix["pool"], {"x0": traffic.start_vector(seed, index, n, dtype, device)}
