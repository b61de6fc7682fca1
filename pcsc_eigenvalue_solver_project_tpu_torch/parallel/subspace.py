"""Distributed block (subspace) iteration: top-k eigenvalues with the
interleaved block SpMM across a row mesh (the port of the JAX package's
``parallel/subspace.py``).

Every sweep reads each rank's diagonals once for the whole block (B5
through ``dia_matmat_il_window`` on the card), the shard-boundary halo is
one exchange of the block's (pr, 1) seam-lane strips, and CholeskyQR2 needs
only all-reduced (b, b) Gram matrices, with the shift of the single-device
``solvers/subspace.py`` (1e-7 in single precision, else 1e-14, times the
trace): no distributed QR factorisation. The host checks the Ritz values of
the projected block, the same on every rank, between chunks of sweeps, as
``subspace_iteration`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import QRResult
from ..core.tolerance import is_close_relative
from ..ops.dia_spmv import dia_matmat_il_window, il_window_halo
from ..solvers.subspace import _conj_factor_inverse, _result
from ..utils.prng import default_generator
from ..utils.timing import spanned
from .dia import PartitionedILDIA, dia_il_halo_window, encode_vec_il_sharded
from .mesh import ROW_AXIS, RowMesh, all_reduce_sum, axis_size


def _block_gram(Xf, Yf, mesh: RowMesh):
    """All-reduced (b, b) Gram matrix: ``G[i, j] = <X_i, Y_j>`` over the
    row-partitioned domain."""
    return all_reduce_sum(torch.tensordot(Xf.conj(), Yf, dims=([1, 2], [1, 2])), mesh)


def _cholqr2_rows_dist(Xf, mesh: RowMesh):
    """Orthonormalise the block's rows (each a vector, (b, R, 128) local):
    two rounds of ``X <- conj(L)^{-1} X`` with ``L L^H`` the shifted Gram
    matrix."""
    def one(Xc):
        Linv = _conj_factor_inverse(_block_gram(Xc, Xc, mesh))
        return (Linv @ Xc.reshape(Xc.shape[0], -1)).reshape(Xc.shape)

    return one(one(Xf))


def _dist_subspace_chunk(A: PartitionedILDIA, Xf, sweeps: int, mesh: RowMesh):
    pr = il_window_halo(A.offsets)

    def apply_block(Xc):
        return dia_matmat_il_window(A.data_il, A.offsets, dia_il_halo_window(Xc, pr, mesh))

    for _ in range(sweeps):
        Xf = _cholqr2_rows_dist(apply_block(Xf), mesh)
    return Xf, _block_gram(Xf, apply_block(Xf), mesh)


@spanned
def distributed_subspace_iteration(A: PartitionedILDIA, mesh: RowMesh, k: int = 4, *,
                                   block: int | None = None,
                                   opts: SolverOptions = SolverOptions(),
                                   sweeps_per_check: int = 10, axis: str = ROW_AXIS,
                                   generator: torch.Generator | None = None,
                                   X0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) of a ``PartitionedILDIA``
    operator by distributed block iteration.

    ``X0`` is the whole (n, b) start block (the same on every rank), as the
    single-device ``subspace_iteration`` takes it; by default its entries are
    uniform [-1, 1] from ``generator`` (``utils.prng.default_generator`` on
    the CPU). As in JAX, the first sweep applies the operator to it as
    given."""
    axis_size(mesh, axis)
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_subspace_iteration: k must be >= 1")
    b = block if block is not None else min(max(k + 4, 8), n)
    if b < k:
        raise ValueError(f"distributed_subspace_iteration: block ({b}) must be >= k ({k})")

    vdt = A.vector_dtype
    if X0 is None:
        gen = generator if generator is not None else default_generator("cpu")
        Xh = (torch.rand((n, b), generator=gen, dtype=torch.float64, device=gen.device) * 2
              - 1).cpu().to(vdt)
    else:
        Xh = torch.as_tensor(X0).cpu().to(vdt)
        if tuple(Xh.shape) != (n, b):
            raise ValueError(f"distributed_subspace_iteration: X0 must be ({n}, {b})")
    Xf = torch.stack([encode_vec_il_sharded(Xh[:, j], A, mesh) for j in range(b)])

    prev = None
    total = 0
    converged = False
    ritz = np.zeros(k, np.complex128)
    max_checks = -(-opts.max_iterations // sweeps_per_check)
    for _ in range(max_checks):
        Xf, B = _dist_subspace_chunk(A, Xf, sweeps_per_check, mesh)
        total += sweeps_per_check
        w = np.linalg.eigvals(B.cpu().numpy())
        w = w[np.argsort(-np.abs(w))][:k]
        if prev is not None:
            close = all(bool(is_close_relative(w[i], prev[i], opts.tolerance))
                        for i in range(k))
            if close:
                ritz = w
                converged = True
                break
        prev = w
        ritz = w
    return _result(ritz, total, converged, mesh.device)
