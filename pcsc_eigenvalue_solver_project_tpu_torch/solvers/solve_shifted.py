"""Shifted linear solve ``(A - shift*I) x = b`` (the port of the JAX
package's ``solvers/solve_shifted.py``).

Reference parity (reference src/matrix/solve_shifted.hpp:48-118): the dense
path forms ``M = A - shift*I`` and LU-solves (PartialPivLU, :74-79); the
sparse path subtracts the shift on the diagonal and SparseLU-solves
(:96-115). Guards preserved: scalar-type mismatch (TypeError, :56-58),
non-square (ValueError, :67-69/:88-90), size mismatch (ValueError,
:70-72/:91-93).

The dense LU is a library call (``torch.linalg.lu_factor_ex`` and
``lu_solve``), as the JAX package leaves it to XLA; a singular matrix gives
non-finite entries rather than raising, as XLA's LU does. For sparse
operators ``method="auto"`` densifies systems up to ``DENSE_FALLBACK_MAX_N``
and runs Jacobi-preconditioned BiCGStab on the SpMV kernels beyond it;
``"gmres"`` runs restarted GMRES.
"""

from __future__ import annotations

import torch

from ..core.dtypes import check_scalar_type
from ..matrix.protocol import AbstractMatrix
from ..ops.krylov import solve_shifted_bicgstab
from ..utils.timing import spanned

# Up to this size a sparse system is densified and LU-solved.
DENSE_FALLBACK_MAX_N = 2048


def lu_factor(m: torch.Tensor):
    """``(LU, pivots)`` of a square matrix; a zero pivot is kept, not
    raised, so that the solve gives inf/NaN as XLA's does."""
    lu, piv, _info = torch.linalg.lu_factor_ex(m)
    return lu, piv


def lu_solve(lu, piv, x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.lu_solve(lu, piv, x[:, None])[:, 0]


def shifted_dense(a: torch.Tensor, shift) -> torch.Tensor:
    """``a - shift * I``."""
    return a - shift * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def _dense_solve_shifted(a: torch.Tensor, shift, b: torch.Tensor) -> torch.Tensor:
    return lu_solve(*lu_factor(shifted_dense(a, shift)), b)


@spanned
def solve_shifted(M: AbstractMatrix, shift, b, *, dtype=None, method: str = "auto",
                  tol: float = 1e-12, maxiter: int | None = None) -> torch.Tensor:
    """Solve ``(A - shift*I) x = b`` for a wrapped dense or sparse matrix, on
    the device where it lies."""
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "solve_shifted")
    b = torch.as_tensor(b).to(device=M.device, dtype=M.dtype)
    kind = "dense" if M.is_dense else "sparse"
    if M.shape[0] != M.shape[1]:
        raise ValueError(f"solve_shifted: A must be square ({kind} case)")
    if M.shape[0] != b.shape[0]:
        raise ValueError(f"solve_shifted: size mismatch between A and b ({kind} case)")
    shift = torch.as_tensor(shift, dtype=M.dtype, device=M.device)

    if M.is_dense:
        return _dense_solve_shifted(M.as_dense(), shift, b)

    if method == "auto":
        method = "dense_lu" if M.shape[0] <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        return _dense_solve_shifted(M.to_dense(), shift, b)
    if method == "bicgstab":
        n = M.shape[0]
        return solve_shifted_bicgstab(M.matvec, shift, b, diag=M.diagonal(), tol=tol,
                                      maxiter=maxiter if maxiter else 4 * n)
    if method == "gmres":
        from ..parallel.krylov import gmres
        from .power import norm, vdot
        d = M.diagonal() - shift
        safe = torch.where(d == 0, torch.ones((), dtype=d.dtype, device=d.device), d)
        x, _, _ = gmres(lambda v: M.matvec(v) - shift * v, b, vdot=vdot, norm=norm,
                        precond=lambda v: v / safe, tol=tol)
        return x
    raise ValueError(f"solve_shifted: unknown method {method!r}")
