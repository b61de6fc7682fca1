"""Distributed Lanczos: top-k eigenvalues of a row-partitioned
symmetric/Hermitian operator (the port of the JAX package's
``parallel/lanczos.py``).

The single-device ``lanczos_decomposition`` (``solvers/lanczos.py``) runs
on the ranks: the basis is row-partitioned, the matvec is the shard SpMV
(the ELL halo or all-gather product, the row-major banded window product,
or B1's window entry for ``PartitionedILDIA``), and the inner products and
the reorthogonalisation projection are all-reduced. The m x m tridiagonal
solve, the same on every rank, runs once on the host with the Ritz
residual bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import QRResult
from ..solvers.lanczos import _default_project, _ritz_from_tridiag, _values, lanczos_decomposition
from ..utils.timing import spanned
from .dia import PartitionedDIA, PartitionedILDIA
from .mesh import ROW_AXIS, RowMesh, all_reduce_sum, axis_size
from .power import host_start_vector, reductions
from .sharded import PartitionedELL


@spanned
def distributed_lanczos_eigenvalues(A, mesh: RowMesh, k: int = 6, *, m: int | None = None,
                                    opts: SolverOptions = SolverOptions(), which: str = "LM",
                                    reorth: bool = True, axis: str = ROW_AXIS,
                                    exchange: str = "auto",
                                    generator: torch.Generator | None = None,
                                    x0=None) -> QRResult:
    """Top-``k`` eigenvalues of a row-partitioned Hermitian operator
    (``PartitionedELL``, ``PartitionedDIA`` or ``PartitionedILDIA``);
    ``iterations`` counts the basis steps."""
    if not isinstance(A, (PartitionedELL, PartitionedDIA, PartitionedILDIA)):
        raise ValueError(
            "distributed_lanczos_eigenvalues: operator must be a "
            "PartitionedELL, PartitionedDIA or PartitionedILDIA, got "
            f"{type(A).__name__}")
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"distributed_lanczos_eigenvalues: unknown which={which!r}")
    axis_size(mesh, axis)
    n = A.n_orig
    if k < 1:
        raise ValueError("distributed_lanczos_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"distributed_lanczos_eigenvalues: k ({k}) must be <= m ({m})")

    vdt = torch.promote_types(A.dtype, torch.float32)
    x0_local = A.local_block(host_start_vector(n, vdt, generator, x0, normalise=False), mesh)
    vdot, norm = reductions(mesh)
    _, alpha, beta, brk = lanczos_decomposition(
        A.local_matvec(mesh, exchange), x0_local, m, vdot=vdot, norm=norm,
        project=lambda V, w: all_reduce_sum(_default_project(V, w), mesh), reorth=reorth)
    steps = max(min(int(brk), m), 1)
    ritz, converged, _ = _ritz_from_tridiag(alpha.cpu().numpy()[:steps],
                                            beta.cpu().numpy()[:steps], min(k, steps), which,
                                            float(opts.tolerance))
    return _values(np.asarray(ritz), steps, converged, mesh.device)
