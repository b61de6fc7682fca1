"""Row-partitioned banded (DIA) operators (the port of the JAX package's
``parallel/dia.py``).

Row-major: each rank holds its column slice of the diagonal planes
``(k, rows_per_shard)``, exchanges ``halo`` entries of x with each
neighbour (cyclically, as JAX's ``ppermute`` ring does), and multiplies
shifted slices of the haloed window (plain PyTorch, as JAX computes it in
``jnp``).

Interleaved: each rank's diagonal block lives in the lane-major layout of
``ops/dia_spmv.py`` and the iterate stays interleaved across iterations.
The shard-boundary halo is the seam-lane column of the local window: one
(pr, 1) strip to each neighbour a matvec (not cyclic: the edge ranks read
zeros, the matrix boundary). The shard product is B1 through
``dia_matvec_il_window`` on the card (its plain version on the CPU).

Zero padding rows keep the spectrum clean, as in ``PartitionedELL``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import as_torch_dtype
from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.dia import SparseDIA
from ..ops.dia_spmv import (DEFAULT_IL_TILE, LANES, dia_matvec_il_window, il_rows,
                            il_window_halo)
from ..utils.timing import spanned
from .mesh import ROW_AXIS, RowMesh, all_gather_rows, axis_size, neighbour_exchange, row_block
from .power import host_start_vector, partition_power
from .sharded import padded_block


@dataclasses.dataclass(frozen=True)
class PartitionedDIA:
    """Banded operator with its diagonal planes column-sliced over the
    ranks: ``data`` is this rank's (k, rows_per_shard) slice of the
    (k, n_padded) planes; ``nnz`` counts the whole operator's nonzeros."""

    data: torch.Tensor  # (k, rows_per_shard)
    offsets: tuple
    n_orig: int
    n_shards: int
    halo: int
    nnz: int

    @property
    def rows_per_shard(self) -> int:
        return self.data.shape[1]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        def matvec(x_local):
            w = dia_halo_window(x_local, self.halo, mesh)
            return dia_window_matvec(self.data, self.offsets, w, self.halo)

        return matvec

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        return padded_block(x, self.n_padded, mesh)


def partition_dia(m: SparseDIA, mesh: RowMesh, *, axis: str = ROW_AXIS) -> PartitionedDIA:
    """Pad a banded operator and keep this rank's slice on its device."""
    n = m.shape[0]
    n_shards = axis_size(mesh, axis)
    rows_per_shard = -(-n // n_shards)
    n_padded = rows_per_shard * n_shards
    bw = m.bandwidth
    if bw > rows_per_shard:
        raise ValueError(
            f"partition_dia: bandwidth ({bw}) exceeds rows per shard "
            f"({rows_per_shard}); use the ELL partition with all_gather instead")
    host = m.data.cpu()
    data = torch.zeros((host.shape[0], n_padded), dtype=host.dtype)
    data[:, :n] = host
    return PartitionedDIA(data=row_block(data, mesh, dim=1), offsets=tuple(m.offsets),
                          n_orig=n, n_shards=n_shards, halo=max(bw, 1),
                          nnz=int(torch.count_nonzero(data)))


def dia_window_matvec(vals_local, offsets, x_window, halo):
    """Local banded matvec: ``y[i] = sum_d vals[d, i] * window[halo + i + off]``.

    ``x_window`` has ``halo`` neighbour entries on each side of the local
    block."""
    rps = vals_local.shape[1]
    y = torch.zeros(rps, dtype=torch.promote_types(vals_local.dtype, x_window.dtype),
                    device=x_window.device)
    for d, off in enumerate(offsets):
        y.addcmul_(vals_local[d], x_window[halo + off:halo + off + rps])
    return y


def dia_halo_window(x_local, halo, mesh: RowMesh):
    """``[left halo | x_local | right halo]``: the previous rank's tail and
    the next rank's head, cyclically (zeros at world size 1)."""
    left, right = neighbour_exchange(mesh, x_local[:halo], x_local[-halo:], cyclic=True)
    return torch.cat([left, x_local, right])


def distributed_dia_matvec(A: PartitionedDIA, x_local, mesh: RowMesh, *,
                           axis: str = ROW_AXIS):
    """One distributed banded SpMV: this rank's block of x -> its block of y."""
    axis_size(mesh, axis)
    return A.local_matvec(mesh)(x_local)


@spanned
def distributed_dia_power_method(A: PartitionedDIA, mesh: RowMesh,
                                 opts: SolverOptions = SolverOptions(), *,
                                 axis: str = ROW_AXIS, generator: torch.Generator | None = None,
                                 x0=None) -> EigenResult:
    """Dominant eigenpair of a row-partitioned banded operator;
    ``eigenvector`` is this rank's block of the padded iterate."""
    axis_size(mesh, axis)
    xh = host_start_vector(A.n_orig, A.dtype, generator, x0)
    return partition_power(A, mesh, opts, A.local_block(xh, mesh))


# --------------------------------------------------------------------------
# Interleaved variant: each rank's diagonal block in the lane-major layout,
# the iterate interleaved across iterations, the shard-boundary halo the
# seam-lane columns of the local window; B1 computes.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionedILDIA:
    """Banded operator, row-partitioned, each rank's block lane-major:
    ``data_il`` is this rank's (k, R, 128) block."""

    data_il: torch.Tensor  # (k, R, 128)
    offsets: tuple
    n_orig: int
    n_shards: int
    tile_s: int

    @property
    def R(self) -> int:
        """Sublane rows per rank."""
        return self.data_il.shape[1]

    @property
    def shard_capacity(self) -> int:
        return self.R * LANES

    @property
    def dtype(self) -> torch.dtype:
        return self.data_il.dtype

    @property
    def vector_dtype(self) -> torch.dtype:
        """The iterate's dtype: ``promote(dtype, float32)``."""
        return torch.promote_types(self.dtype, torch.float32)

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        pr = il_window_halo(self.offsets)

        def matvec(x_il):
            return dia_matvec_il_window(self.data_il, self.offsets,
                                        dia_il_halo_window(x_il, pr, mesh))

        return matvec

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        return encode_vec_il_sharded(x, self, mesh)


def partition_dia_il(m: SparseDIA, mesh: RowMesh, *, axis: str = ROW_AXIS,
                     tile_s: int | None = None, dtype=None) -> PartitionedILDIA:
    """Pad and interleave a banded operator; keep this rank's block."""
    ts = DEFAULT_IL_TILE if tile_s is None else tile_s
    n = m.shape[0]
    p = axis_size(mesh, axis)
    k = m.data.shape[0]
    R = il_rows(-(-n // p), ts)
    pr = il_window_halo(m.offsets)
    if pr > R:
        raise ValueError(f"partition_dia_il: halo ({pr}) exceeds shard sublanes ({R})")
    cap = R * LANES
    dt = m.dtype if dtype is None else as_torch_dtype(dtype)
    own = m.data.cpu()[:, mesh.rank * cap:(mesh.rank + 1) * cap].to(dt)
    data = torch.zeros((k, cap), dtype=dt)
    data[:, :own.shape[1]] = own
    # this rank's lane-major interleave
    data_il = data.reshape(k, LANES, R).transpose(1, 2).contiguous()
    return PartitionedILDIA(data_il=data_il.to(mesh.device), offsets=tuple(m.offsets),
                            n_orig=n, n_shards=p, tile_s=ts)


def encode_vec_il_sharded(x, A: PartitionedILDIA, mesh: RowMesh, *,
                          axis: str = ROW_AXIS) -> torch.Tensor:
    """Host (n,) vector -> this rank's (R, 128) interleaved block."""
    xh = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    cap = A.shard_capacity
    xp = np.zeros(cap, xh.dtype)
    own = xh[mesh.rank * cap:(mesh.rank + 1) * cap]
    xp[:own.shape[0]] = own
    return torch.from_numpy(np.ascontiguousarray(xp.reshape(LANES, A.R).T)).to(mesh.device)


def decode_vec_il_sharded(x_il, A: PartitionedILDIA, mesh: RowMesh | None = None) -> np.ndarray:
    """The ranks' interleaved blocks -> the host (n,) vector, on every rank
    (a collective: every rank of ``mesh``, default the whole world, calls
    it)."""
    if mesh is None:
        from .mesh import make_row_mesh
        mesh = make_row_mesh(device=x_il.device)
    full = all_gather_rows(x_il, mesh).cpu().numpy()
    return full.reshape(A.n_shards, A.R, LANES).transpose(0, 2, 1).reshape(-1)[:A.n_orig]


def dia_il_halo_window(x_il_local, pr, mesh: RowMesh):
    """The (..., R + 2*pr, 128) window of interleaved blocks (leading
    dimensions, the vectors of a block, each get their own): the local
    lane-shifted halos plus the seam-lane columns exchanged with the
    neighbouring ranks (not cyclic: the edge ranks read zeros, the matrix
    boundary)."""
    R = x_il_local.shape[-2]
    top = F.pad(x_il_local[..., R - pr:, :-1], (1, 0))
    bot = F.pad(x_il_local[..., :pr, 1:], (0, 1))
    if mesh.world_size > 1:
        from_prev, from_next = neighbour_exchange(mesh, x_il_local[..., :pr, :1],
                                                  x_il_local[..., R - pr:, -1:], cyclic=False)
        top[..., :1] = from_prev
        bot[..., -1:] = from_next
    return torch.cat([top, x_il_local, bot], dim=-2)


def distributed_dia_il_matvec(A: PartitionedILDIA, x_il, mesh: RowMesh, *,
                              axis: str = ROW_AXIS):
    """One distributed interleaved banded SpMV (B1 on the card)."""
    axis_size(mesh, axis)
    return A.local_matvec(mesh)(x_il)


@spanned
def distributed_dia_il_power_method(A: PartitionedILDIA, mesh: RowMesh,
                                    opts: SolverOptions = SolverOptions(), *,
                                    axis: str = ROW_AXIS,
                                    generator: torch.Generator | None = None,
                                    x0=None) -> EigenResult:
    """Dominant eigenpair via the interleaved distributed path. The returned
    ``eigenvector`` is this rank's interleaved block; ``decode_vec_il_sharded``
    gathers the whole vector."""
    axis_size(mesh, axis)
    xh = host_start_vector(A.n_orig, A.vector_dtype, generator, x0)
    return partition_power(A, mesh, opts, A.local_block(xh, mesh))
