"""Row-partitioned general sparse operators (the port of the JAX package's
``parallel/gell.py``).

Each rank owns a contiguous block of rows, packed on its own by the port's
``ops/gell_spmv.py::pack_gell`` over (rows_per_shard, n_padded) with global
column indices; the iterate is gathered on every rank, the correct
exchange for unstructured sparsity (any column may be referenced by any
rank), and each rank's product is B6 (``gell_matvec``) on the card, its
plain version on the CPU.

The row blocks are those of JAX's partition: ``tile_rows`` (JAX's rule
``auto_tile_rows`` when not given) fixes the rows a rank holds,
``rows_per_shard = ceil(ceil(n / n_shards) / tile_rows) * tile_rows``,
though it does not shape the port's pack. Each rank keeps only its own
pack, so JAX's stacking of every shard's pack into one sharded array, and
its padding of the spill tails to one length, have no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.sparse import SparseCSR
from ..ops.gell_spmv import LANES, GELLPack, gell_matvec, pack_gell
from ..utils.timing import spanned
from .mesh import ROW_AXIS, RowMesh, all_gather_rows, axis_size
from .power import host_start_vector, partition_power
from .sharded import padded_block


def auto_tile_rows(n_rows: int, nnz: int) -> int:
    """JAX's tile height (``ops/pallas/gell_spmv.py::auto_tile_rows``): an
    expected bucket fill of ~0.75, ``tile_rows * (nnz / n_rows) / 128 ~= 96``,
    rounded to a multiple of 128 in [128, 1024]. Here it fixes the row
    blocks of a partition."""
    avg = max(nnz / max(n_rows, 1), 1e-9)
    t = int(round(96.0 * LANES / avg / LANES)) * LANES
    return int(np.clip(t, LANES, 1024))


def shard_rows(n: int, n_shards: int, tile_rows: int) -> int:
    """Rows a rank holds: whole tiles covering ``ceil(n / n_shards)``."""
    return -(-(-(-n // n_shards)) // tile_rows) * tile_rows


def host_coo(m: SparseCSR):
    """(rows, cols, values) of a CSR on the host, int64 indices."""
    return (m.rows.cpu().numpy().astype(np.int64), m.indices.cpu().numpy().astype(np.int64),
            m.data.cpu().numpy())


@dataclasses.dataclass(frozen=True)
class PartitionedGELL:
    """A square operator row-partitioned in per-rank packs: ``pack`` holds
    this rank's rows (local row ids) over the padded global columns."""

    pack: GELLPack      # (rows_per_shard, n_padded)
    n_orig: int
    n_shards: int
    tile_rows: int

    @property
    def rows_per_shard(self) -> int:
        return self.pack.shape[0]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.pack.dtype

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        return lambda x_local: gell_local_matvec(self.pack, all_gather_rows(x_local, mesh))

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        return padded_block(x, self.n_padded, mesh)


def partition_gell(m: SparseCSR, mesh: RowMesh, *, axis: str = ROW_AXIS,
                   tile_rows: int | None = None) -> PartitionedGELL:
    """Pack this rank's rows of a square sparse matrix on its device."""
    n, n_cols = m.shape
    if n != n_cols:
        raise ValueError("partition_gell: matrix must be square")
    n_shards = axis_size(mesh, axis)
    if tile_rows is None:
        tile_rows = auto_tile_rows(n, m.nnz)
    rps = shard_rows(n, n_shards, tile_rows)
    rows, cols, vals = host_coo(m)
    if np.dtype(vals.dtype).kind == "c":
        raise ValueError("partition_gell: complex operators use the "
                         "split-complex partitions (parallel/split_complex.py)")
    s = mesh.rank
    sel = rows // rps == s
    pack = pack_gell(rows[sel] - s * rps, cols[sel], vals[sel], (rps, rps * n_shards),
                     tile_rows=tile_rows, device=mesh.device)
    return PartitionedGELL(pack=pack, n_orig=n, n_shards=n_shards, tile_rows=tile_rows)


def gell_local_matvec(pack: GELLPack, x_full):
    """A rank's block product: its pack times the gathered iterate (B6 on
    the card). JAX passes the pack's leaves and static fields one by one."""
    return gell_matvec(pack, x_full)


def distributed_gell_matvec(A: PartitionedGELL, x_local, mesh: RowMesh, *,
                            axis: str = ROW_AXIS):
    """One distributed SpMV: this rank's block of x -> its block of y."""
    axis_size(mesh, axis)
    return A.local_matvec(mesh)(x_local)


@spanned
def distributed_gell_power_method(A: PartitionedGELL, mesh: RowMesh,
                                  opts: SolverOptions | None = None, *,
                                  axis: str = ROW_AXIS,
                                  generator: torch.Generator | None = None,
                                  x0=None) -> EigenResult:
    """Dominant eigenpair of a row-partitioned unstructured operator: the
    single-device loop (power_method.hpp:47-99 semantics) on the shards."""
    axis_size(mesh, axis)
    opts = SolverOptions() if opts is None else opts
    xh = host_start_vector(A.n_orig, A.dtype, generator, x0)
    return partition_power(A, mesh, opts, A.local_block(xh, mesh))
