"""Distributed power iteration over a row-partitioned operator (the port of
the JAX package's ``parallel/power.py``).

Each rank runs the single-device loop of ``solvers/power.py``
(``power_iteration_loop``: masked blocks of iterations, one host read of
``done`` a block) on its row block, with the shard SpMV and its exchange as
the matvec and all-reduced norms and Rayleigh quotients. Every scalar of the
carry is the same on every rank, so every rank takes the same branches and
the stopping rule and iteration counts are those of ``power_method``
(power_method.hpp:47-99).

Start vectors: ``x0`` (the whole (n,) vector, the same on every rank), or
drawn from ``generator`` (default: ``utils.prng.default_generator`` on the
CPU), the same draw on every rank; normalised on the host and zero-padded,
as JAX does, so that the padded operator's spurious zero modes stay dark.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..solvers.power import power_iteration_loop
from ..utils.prng import default_generator, random_unit_vector
from ..utils.timing import spanned
from .mesh import ROW_AXIS, RowMesh, axis_size
from .sharded import PartitionedELL, psum_norm, psum_vdot


def host_start_vector(n: int, dtype, generator=None, x0=None, *,
                      normalise: bool = True) -> np.ndarray:
    """The whole (n,) start vector on the host in ``dtype`` (a torch dtype):
    ``x0``, or a uniform [-1, 1] unit vector drawn from ``generator``;
    ``normalise`` divides ``x0`` by its 2-norm (numpy's, as JAX's entry
    points do)."""
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    if x0 is None:
        gen = generator if generator is not None else default_generator("cpu")
        return random_unit_vector(gen, n, dtype).cpu().numpy()
    xh = np.asarray(x0.cpu() if isinstance(x0, torch.Tensor) else x0, dtype=np_dt)
    if normalise:
        nrm = np.linalg.norm(xh)
        if nrm != 0:
            xh = xh / nrm
    return xh


def reductions(mesh: RowMesh):
    """``(vdot, norm)`` over the row shards, for the single-device loops."""
    return (lambda a, b: psum_vdot(a, b, mesh)), (lambda v: psum_norm(v, mesh))


def partition_power(A, mesh: RowMesh, opts: SolverOptions, x0_local, exchange="auto"):
    """The power loop on any partition kind from this rank's start block."""
    vdot, norm = reductions(mesh)
    return power_iteration_loop(A.local_matvec(mesh, exchange), vdot, norm, x0_local,
                                opts.max_iterations, opts.tolerance)


@spanned
def distributed_power_method(A: PartitionedELL, mesh: RowMesh,
                             opts: SolverOptions = SolverOptions(), *, axis: str = ROW_AXIS,
                             exchange: str = "auto", generator: torch.Generator | None = None,
                             x0=None) -> EigenResult:
    """Dominant eigenpair of a row-partitioned operator.

    ``A`` comes from ``partition_ell``; its padding rows and columns are
    zero, so the padded operator's spectrum is the original one plus zero
    eigenvalues, harmless for the dominant pair as long as the start
    vector's padding entries are zero (enforced here). ``eigenvector`` is
    this rank's block of the padded iterate."""
    axis_size(mesh, axis)
    xh = host_start_vector(A.n_orig, A.dtype, generator, x0)
    return partition_power(A, mesh, opts, A.local_block(xh, mesh), exchange)
