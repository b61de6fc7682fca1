"""Distributed Arnoldi and Krylov-Schur: top-k eigenvalues of a
row-partitioned operator (the port of the JAX package's
``parallel/arnoldi.py``).

The Krylov basis is row-partitioned (each rank holds its block of every
basis vector); the only O(n) operations are the shard SpMV with its
exchange and the all-reduced inner products. The basis builds are the
single-device ``arnoldi_decomposition`` and ``arnoldi_extend``
(``solvers/arnoldi.py``) with all-reduced ``vdot``, ``norm`` and
projection. The m x m Hessenberg projection, the same on every rank, is
solved on the rank's device as the single-device Arnoldi solves it: B8 on
the card (B13 beyond ``UNBLOCKED_MAX_N``), ``_qr_eigenvalues_accel`` on the
CPU. Krylov-Schur's restart math (ordered Schur form, contraction) runs on
the host from the replicated projection, as in JAX; the contraction of the
basis is local to each rank.

The operator may be any partition of this layer (``PartitionedELL``,
``PartitionedDIA``, ``PrunedGELL`` as in JAX; ``PartitionedGELL`` and
``PartitionedILDIA`` as well).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import complex_dtype_of
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..solvers.arnoldi import (_projection_eigenvalues, arnoldi_decomposition, arnoldi_extend,
                               krylov_schur_cycles)
from ..solvers.lanczos import _default_project
from ..solvers.qr_eigenvalues import _result
from ..utils.timing import spanned
from .mesh import ROW_AXIS, RowMesh, all_reduce_sum, axis_size
from .power import host_start_vector, reductions
from .sharded import PartitionedELL


def _start_block(A, mesh: RowMesh, generator, x0) -> torch.Tensor:
    """This rank's block of the start vector in the operator's dtype (the
    basis build normalises it), zero padding: spurious zero modes stay
    dark."""
    dtype = getattr(A, "vector_dtype", A.dtype)
    return A.local_block(host_start_vector(A.n_orig, dtype, generator, x0, normalise=False),
                         mesh)


@spanned
def distributed_arnoldi_eigenvalues(A: PartitionedELL, mesh: RowMesh, k: int = 6, *,
                                    m: int | None = None,
                                    opts: SolverOptions = SolverOptions(),
                                    axis: str = ROW_AXIS, exchange: str = "auto",
                                    generator: torch.Generator | None = None,
                                    x0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) of the partitioned operator;
    ``iterations`` counts the projection's QR sweeps."""
    axis_size(mesh, axis)
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_arnoldi_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"distributed_arnoldi_eigenvalues: k ({k}) must be <= m ({m})")
    vdot, norm = reductions(mesh)
    _, H, _ = arnoldi_decomposition(A.local_matvec(mesh, exchange),
                                    _start_block(A, mesh, generator, x0), m, vdot=vdot, norm=norm)
    Hm = H[:m, :m].to(complex_dtype_of(H.dtype))
    eigs, sweeps, converged = _projection_eigenvalues(Hm, opts.max_iterations, opts.tolerance)
    order = torch.argsort(-eigs.abs(), stable=True)
    return _result(eigs[order][:k], sweeps, converged)


@spanned
def distributed_krylov_schur_eigenvalues(A, mesh: RowMesh, k: int = 6, *,
                                         m: int | None = None, restarts: int = 60,
                                         opts: SolverOptions = SolverOptions(),
                                         axis: str = ROW_AXIS, exchange: str = "auto",
                                         generator: torch.Generator | None = None,
                                         x0=None) -> QRResult:
    """Distributed Krylov-Schur restarted Arnoldi. The host sees only the
    m x m projected matrix; basis extension and contraction stay on the
    ranks. ``iterations`` counts matvecs."""
    axis_size(mesh, axis)
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_krylov_schur_eigenvalues: k must be >= 1")
    if restarts < 1:
        raise ValueError("distributed_krylov_schur_eigenvalues: restarts must be >= 1")
    if m is None:
        m = min(max(3 * k + 10, 20), n)
    m = min(m, n)
    if k + 2 > m:
        raise ValueError(f"distributed_krylov_schur_eigenvalues: m ({m}) too small for "
                         f"k ({k}); need m >= k + 2")
    l_target = min(2 * k, m - 2)
    vdot, norm = reductions(mesh)
    matvec = A.local_matvec(mesh, exchange)

    def extend(mv, W0, l, m_):
        return arnoldi_extend(mv, W0, l, m_, norm=norm,
                              project=lambda W, w: all_reduce_sum(_default_project(W, w), mesh))

    basis = arnoldi_decomposition(matvec, _start_block(A, mesh, generator, x0), m, vdot=vdot,
                                  norm=norm)
    wanted, total_mv, converged = krylov_schur_cycles(matvec, basis, m, k, l_target,
                                                      float(opts.tolerance), restarts, extend)
    return _result(torch.from_numpy(np.asarray(wanted)).to(mesh.device), total_mv, converged)
