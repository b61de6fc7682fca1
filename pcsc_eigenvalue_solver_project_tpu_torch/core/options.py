"""Solver option structs.

Reference parity: ``SolverOptions`` (maxIterations=1000, tolerance=1e-10;
reference src/option/solver_option.hpp:14-20). The shifted and QR
option structs come with their solvers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Basic configuration for iterative eigenvalue algorithms."""

    max_iterations: int = 1000
    tolerance: float = 1e-10

    def __post_init__(self):
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be non-negative")
        if self.tolerance < 0:
            raise ValueError("tolerance must be non-negative")
