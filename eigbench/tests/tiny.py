"""Cells cut to sizes the CPU tests run in seconds, through the same
harness, builders, references and program entry points as on the card.
The grids stay at most 7 per side, where the interleaved layout's halo fits
(the bandwidth g^2 + g + 1 within R = 64 rows); Arnoldi takes m = 6, where
no Ritz value has converged and float32 still agrees with float64. The power
run takes 100 iterations: on a 6^3 grid the float32 Rayleigh quotient
settles to a repeated value, which stops a run at tolerance 0, within 200
(at 256^3 the top of the spectrum is far denser: it moves by ~1e-3 an
iteration at 200)."""

from __future__ import annotations

from eigbench import harness

SIZES = {
    "hpcg27-256.power": ({"grid": 6}, {}, {"max_iterations": 100}),
    "hpcg27-256.arnoldi": ({"grid": 7}, {"m": 6}, {}),
    "geev-f32-2048.eigvals": ({"n": 24}, {}, {}),
}
CELLS = tuple(SIZES)


def cell(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    config, kwargs, options = SIZES[name]
    c.config.update(config)
    c.mix["kwargs"].update(kwargs)
    c.mix["options"].update(options)
    return c


def run(name: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False):
    c = cell(name)
    return c, harness.run_cell(c, seed, seconds, trace, "cpu", 0.0)
