"""Krylov linear solvers for shifted systems (the port of the JAX package's
``ops/krylov.py``).

The reference solves ``(A - shift*I) x = b`` with dense ``PartialPivLU`` or
``SparseLU`` (reference src/matrix/solve_shifted.hpp:74-115). The sparse
path here is an iterative Krylov solve (BiCGStab) on the SpMV kernels with
Jacobi preconditioning; near-singular ``A - shift*I`` (the regime of inverse
iteration) is handled by capping iterations and accepting the direction.

JAX calls ``jax.scipy.sparse.linalg.bicgstab`` here; torch has no
counterpart, so the port calls its own generic ``bicgstab``
(``parallel/krylov.py``) with the same ``tol``, ``atol``, ``maxiter`` and
Jacobi preconditioner.
"""

from __future__ import annotations

import torch

from ..parallel.krylov import bicgstab
from ..solvers.power import norm, vdot


def jacobi_preconditioner(diag: torch.Tensor):
    """Preconditioner ``v -> v / diag`` with zero-diagonal safety."""
    safe = torch.where(diag == 0, torch.ones((), dtype=diag.dtype, device=diag.device), diag)

    def apply(v):
        return v / safe

    return apply


def solve_shifted_bicgstab(matvec, shift, b, *, diag=None, tol=1e-12, atol=0.0, maxiter=None,
                           stop=None):
    """Solve ``(A - shift*I) y = b`` where ``matvec(v) == A @ v``. Returns
    the iterate, converged or not (inverse iteration needs only the
    direction); ``stop`` as in ``parallel/krylov.py``."""
    shift = torch.as_tensor(shift, dtype=b.dtype, device=b.device)

    def shifted_mv(v):
        return matvec(v) - shift * v

    precond = jacobi_preconditioner(diag - shift) if diag is not None else None
    y, _, _ = bicgstab(shifted_mv, b, vdot=vdot, norm=norm, precond=precond, tol=tol,
                       atol=atol, maxiter=maxiter, stop=stop)
    return y
