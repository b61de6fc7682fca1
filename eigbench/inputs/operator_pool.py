"""No argument but the operator: the configuration's builder makes ``pool``
operators, and solves take them in turn, in an order drawn from the seed.
Where the mix gives a ``pool_seed``, the operators are made from it and are
the same in every run: their content sets the work (a QR solve's sweeps),
so a seed of its own would move the time by the seed and not by the code;
the run's seed then picks only the order. The harness solves a pool in
whole passes, so every run solves each operator equally often."""

from eigbench import traffic

FRESH = False


def draw(mix: dict, seed: int, index: int, n: int, dtype, device):
    return traffic.pool_order(seed, mix["pool"])[index % mix["pool"]], {}
