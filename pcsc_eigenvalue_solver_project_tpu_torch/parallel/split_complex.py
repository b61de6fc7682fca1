"""Distributed split-plane complex power iteration (the port of the JAX
package's ``parallel/split_complex.py``).

The operator is re/im diagonal planes ``(2, k, n)`` column-sliced over the
ranks, the iterate is ``(2, rows_per_shard)`` planes, one exchange a matvec
moves both planes' boundary strips (cyclically, as JAX's ring), and the
plane product runs on shifted window slices in plain PyTorch, as JAX
computes it in ``jnp``. The planes stay planes: no copy to a complex
tensor. Reductions are all-reduced plane forms; the loop is the split power
loop of ``solvers/power.py`` (``power_carry_loop`` with the plane stopping
rule).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.split_complex import SplitComplexDIA
from ..ops.split_complex import splitc_is_close_relative
from ..solvers.power import carry_to_result, power_carry_loop, power_init_carry
from ..utils.prng import default_generator
from ..utils.timing import spanned
from .mesh import ROW_AXIS, RowMesh, all_reduce_sum, axis_size, neighbour_exchange, row_block


@dataclasses.dataclass(frozen=True)
class PartitionedSplitComplexDIA:
    """Complex banded operator as row-partitioned re/im diagonal planes:
    ``planes`` is this rank's (2, k, rows_per_shard) slice."""

    planes: torch.Tensor  # (2, k, rows_per_shard)
    offsets: tuple
    n_orig: int
    n_shards: int
    halo: int

    @property
    def rows_per_shard(self) -> int:
        return self.planes.shape[2]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.planes.dtype

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        def matvec(x_local):
            w = _splitc_halo_window(x_local, self.halo, mesh)
            return _splitc_window_matvec(self.planes, self.offsets, w, self.halo)

        return matvec

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        """This rank's (2, rows_per_shard) block of host (2, n) planes."""
        xh = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        xp = np.zeros((2, self.n_padded), xh.dtype)
        xp[:, :self.n_orig] = xh
        return row_block(xp, mesh, dim=1)


def partition_splitc_dia(m: SplitComplexDIA, mesh: RowMesh, *,
                         axis: str = ROW_AXIS) -> PartitionedSplitComplexDIA:
    n = m.shape[0]
    p = axis_size(mesh, axis)
    rps = -(-n // p)
    n_pad = rps * p
    bw = max((abs(o) for o in m.offsets), default=0)
    if bw > rps:
        raise ValueError(f"partition_splitc_dia: bandwidth ({bw}) exceeds rows per "
                         f"shard ({rps})")
    host = m.planes.cpu()
    planes = torch.zeros((2, host.shape[1], n_pad), dtype=host.dtype)
    planes[:, :, :n] = host
    return PartitionedSplitComplexDIA(planes=row_block(planes, mesh, dim=2),
                                      offsets=tuple(m.offsets), n_orig=n, n_shards=p,
                                      halo=max(bw, 1))


def _splitc_halo_window(x_local, halo, mesh: RowMesh):
    """[left | local | right] on both planes: x_local (2, rps) ->
    (2, rps + 2*halo), one exchange for both planes."""
    left, right = neighbour_exchange(mesh, x_local[:, :halo], x_local[:, -halo:], cyclic=True)
    return torch.cat([left, x_local, right], dim=1)


def _splitc_window_matvec(planes_local, offsets, w, halo):
    """Plane banded matvec from a haloed window: planes_local (2, k, rps),
    w (2, rps + 2*halo) -> (2, rps)."""
    rps = planes_local.shape[2]
    yr = torch.zeros(rps, dtype=w.dtype, device=w.device)
    yi = torch.zeros(rps, dtype=w.dtype, device=w.device)
    for d, off in enumerate(offsets):
        sr = w[0, halo + off:halo + off + rps]
        si = w[1, halo + off:halo + off + rps]
        vr = planes_local[0, d]
        vi = planes_local[1, d]
        yr = yr + vr * sr - vi * si
        yi = yi + vr * si + vi * sr
    return torch.stack([yr, yi])


def _psum_splitc_norm(v, mesh: RowMesh):
    return torch.sqrt(all_reduce_sum(torch.sum(v * v), mesh))


def _psum_splitc_vdot(a, b, mesh: RowMesh):
    return all_reduce_sum(torch.stack([torch.sum(a[0] * b[0] + a[1] * b[1]),
                                       torch.sum(a[0] * b[1] - a[1] * b[0])]), mesh)


@spanned
def distributed_splitc_power_method(A: PartitionedSplitComplexDIA, mesh: RowMesh,
                                    opts: SolverOptions = SolverOptions(), *,
                                    axis: str = ROW_AXIS,
                                    generator: torch.Generator | None = None,
                                    x0=None) -> EigenResult:
    """Dominant eigenpair of a row-partitioned complex banded operator.

    ``eigenvalue`` is a (2,) plane scalar; ``eigenvector`` this rank's
    (2, rows_per_shard) block of the padded plane iterate (convert with
    ``ops.split_complex.from_planes``). The planes iterate in
    ``promote(planes dtype, float32)``; the stopping rule is decided in
    float64, as JAX decides it under x64."""
    axis_size(mesh, axis)
    n = A.n_orig
    rdt = torch.promote_types(A.dtype, torch.float32)
    if x0 is None:
        gen = generator if generator is not None else default_generator("cpu")
        xh = (torch.rand((2, n), generator=gen, dtype=rdt, device=gen.device) * 2 - 1)
        xh = xh.cpu().numpy()
    else:
        xh = np.asarray(x0.cpu() if isinstance(x0, torch.Tensor) else x0,
                        torch.empty(0, dtype=rdt).numpy().dtype)
        if xh.shape != (2, n):
            raise ValueError("distributed_splitc_power_method: x0 must be (2, n) planes")
    nrm = np.linalg.norm(xh)
    if nrm != 0:
        xh = xh / nrm
    x0_local = A.local_block(xh, mesh)
    matvec = A.local_matvec(mesh)
    carry = power_init_carry(matvec, x0_local)
    carry = carry[:4] + (torch.zeros(2, dtype=rdt, device=x0_local.device),) + carry[5:]
    tol = torch.tensor(opts.tolerance, dtype=torch.float64, device=x0_local.device)
    carry = power_carry_loop(matvec, lambda a, b: _psum_splitc_vdot(a, b, mesh),
                             lambda v: _psum_splitc_norm(v, mesh), carry, opts.max_iterations,
                             tol, splitc_is_close_relative)
    return carry_to_result(carry)
