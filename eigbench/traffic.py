"""The one generator of the benchmark's traffic.

A mix (``mixes/<mix>.json``) is data: the solver to call, its options, and
the kind of input that varies from solve to solve (``inputs``), a file of
its own under ``inputs/`` (``inputs/__init__.py`` says what one holds).
Every draw is a function of ``(seed, stream, index)`` alone, so the same
seed gives the same inputs in a run, in the reference after the window, and
in the control. The solves run back to back from one caller (a closed loop).
"""

from __future__ import annotations

import random

import numpy as np
import torch

# Streams of draws, each its own sequence of seeds.
START_VECTOR = 0
OPERATOR = 1
SAMPLE = 2
ORDER = 3

# The warm-up solve's index: its start vector is never one of the window's.
WARM_UP = -1


def derive(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one draw, from the run's seed (any whole number),
    the stream and the draw's index."""
    seq = np.random.SeedSequence([seed % 2**64, stream, index % 2**64])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive(seed, stream, index))
    return gen


def uniform(shape, low: float, high: float, dtype, gen: torch.Generator) -> torch.Tensor:
    """Entries uniform in [low, high), made on the generator's device."""
    x = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return x.mul_(high - low).add_(low)


def start_vector(seed: int, index: int, n: int, dtype, device) -> torch.Tensor:
    """Solve ``index``'s start vector: n entries uniform in [-1, 1)."""
    return uniform((n,), -1.0, 1.0, dtype, generator(seed, START_VECTOR, index, device))


def operator_seed(mix: dict, seed: int) -> int:
    """The seed the operators are made from: the mix's ``pool_seed`` if it
    has one, else the run's."""
    return mix.get("pool_seed", seed)


def pool_order(seed: int, pool: int) -> list:
    order = list(range(pool))
    random.Random(derive(seed, ORDER)).shuffle(order)
    return order


def input_kind(mix: dict):
    """The module ``inputs/<mix's inputs>.py``."""
    from eigbench.plugins import load_plugin
    return load_plugin("inputs", mix["inputs"])


def solve_inputs(mix: dict, seed: int, index: int, n: int, dtype, device):
    """``(operator index, keyword arguments of the call)`` of solve ``index``."""
    return input_kind(mix).draw(mix, seed, index, n, dtype, device)


class Reservoir:
    """A uniform sample of ``size`` solves out of however many the window
    completes (Algorithm R), drawn from the seed: the harness keeps only
    the sampled solves' answers for the check."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(derive(seed, SAMPLE))
        self.slots = []
        self.seen = 0

    def offer(self, index: int, item) -> None:
        if len(self.slots) < self.size:
            self.slots.append((index, item))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.slots[j] = (index, item)
        self.seen += 1

    def items(self):
        return sorted(self.slots, key=lambda s: s[0])
