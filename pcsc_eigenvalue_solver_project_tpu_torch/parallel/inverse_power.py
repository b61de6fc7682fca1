"""Distributed shifted inverse power iteration (the port of the JAX
package's ``parallel/inverse_power.py``).

The inner Krylov solve (``parallel/krylov.py::solve_shifted_distributed``,
Jacobi-preconditioned BiCGStab) nests inside the outer loop of
``solvers/inverse_power.py::inverse_power_loop``, both on row shards: every
SpMV exchanges its halo or gathers x, every reduction is all-reduced, and
the flags every rank reads are the same on every rank. The outer loop's
finished iterations hand their inner solve ``stop=done``, as on one card.
"""

from __future__ import annotations

import torch

from ..core.options import ShiftedSolverOptions
from ..core.results import EigenResult
from ..solvers.inverse_power import inverse_power_loop
from ..utils.timing import spanned
from .krylov import solve_shifted_distributed
from .mesh import ROW_AXIS, RowMesh, axis_size
from .power import host_start_vector, reductions
from .sharded import PartitionedELL


def _partitioned_diagonal(A: PartitionedELL, mesh: RowMesh) -> torch.Tensor:
    """This rank's block of the padded operator's diagonal."""
    rows = mesh.rank * A.rows_per_shard + torch.arange(A.rows_per_shard, device=A.data.device)
    on_diag = A.indices.long() == rows[:, None]
    return torch.sum(torch.where(on_diag, A.data, torch.zeros_like(A.data)), dim=1)


@spanned
def distributed_shifted_inverse_power(A: PartitionedELL, mesh: RowMesh,
                                      opts: ShiftedSolverOptions = ShiftedSolverOptions(), *,
                                      axis: str = ROW_AXIS, exchange: str = "auto",
                                      generator: torch.Generator | None = None,
                                      x0=None) -> EigenResult:
    """Eigenpair of the row-partitioned operator nearest ``opts.shift``;
    ``eigenvector`` is this rank's block of the padded iterate. The inner
    solves are BiCGStab whatever ``opts.inner_method`` says, as in JAX, with
    ``inner_max_iterations`` (default 4 n_padded) and ``inner_tolerance``.

    Padded rows have a zero diagonal; the Jacobi preconditioner divides by
    ``diag - shift``, nonzero there as long as the shift is not 0."""
    axis_size(mesh, axis)
    xh = host_start_vector(A.n_orig, A.dtype, generator, x0)
    x0_local = A.local_block(xh, mesh)
    matvec = A.local_matvec(mesh, exchange)
    vdot, norm = reductions(mesh)
    diag = _partitioned_diagonal(A, mesh)
    inner_maxiter = opts.inner_max_iterations or 4 * A.n_padded

    def solve(x, done):
        return solve_shifted_distributed(matvec, opts.shift, x, vdot=vdot, norm=norm,
                                         diag=diag, tol=opts.inner_tolerance,
                                         maxiter=inner_maxiter, stop=done)

    return inverse_power_loop(matvec, solve, vdot, norm, x0_local, opts.max_iterations,
                              opts.tolerance)
