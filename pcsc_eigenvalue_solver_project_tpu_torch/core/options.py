"""Solver option structs.

Reference parity: ``SolverOptions`` (maxIterations=1000, tolerance=1e-10;
reference src/option/solver_option.hpp:14-20). ``QROptions`` adds the QR
iteration's mode switch; ``ShiftedSolverOptions`` adds a scalar shift
defaulting to 0 (reference src/option/shifted_solver_option.hpp:30-69) and
the inner linear solve's controls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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


@dataclasses.dataclass(frozen=True)
class ShiftedSolverOptions(SolverOptions):
    """Options for solvers operating on ``(A - shift*I)``.

    ``shift`` may be real or complex. ``inner_*`` fields configure the inner
    iterative linear solve used for sparse operators (the reference
    refactorises a SparseLU every outer iteration, solve_shifted.hpp:104-115;
    here the sparse path is a Krylov solve on the SpMV kernels instead).
    """

    shift: complex = 0.0
    # Inner linear-solve controls (sparse/Krylov path only).
    inner_tolerance: float = 1e-12
    inner_max_iterations: Optional[int] = None  # default: 4*n
    inner_method: str = "auto"  # "auto" | "dense_lu" | "bicgstab" | "gmres"


@dataclasses.dataclass(frozen=True)
class QROptions(SolverOptions):
    """Options for the QR eigenvalue iteration.

    ``mode="parity"`` reproduces the reference algorithm exactly: unshifted
    QR sweeps on the Hessenberg form with the stopping rule
    ``max|subdiag| <= tol*(1+||H||_F)`` (qr_eigenvalues.hpp:69-93).

    ``mode="accelerated"``: Wilkinson-shifted QR sweeps with deflation, run
    in complex arithmetic so conjugate eigenvalue pairs of real matrices
    converge too (the reference's unshifted real iteration cannot separate
    them — a documented limitation it inherits).
    """

    mode: str = "parity"  # "parity" | "accelerated"
    deflation_tolerance: Optional[float] = None  # accelerated mode; default: tolerance
    sweeps_per_check: int = 8  # accelerated mode: device sweeps between host checks
    compute_vectors: bool = False  # accelerated mode: accumulate the Schur
    # similarity and return eigenvectors (superset of the reference)

    def __post_init__(self):
        super().__post_init__()
        if self.mode not in ("parity", "accelerated"):
            raise ValueError(f"unknown QR mode: {self.mode!r}")
        if self.compute_vectors and self.mode != "accelerated":
            raise ValueError(
                "compute_vectors requires mode='accelerated' (the parity "
                "algorithm, like the reference, produces eigenvalues only)")
