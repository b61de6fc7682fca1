"""Row-partitioned sparse operators and the distributed SpMV (the port of the
JAX package's ``parallel/sharded.py``).

The matrix rows are block-partitioned over a row mesh (``parallel/mesh.py``)
in a padded ELL layout; each rank holds its block of rows and its block of
the iterate, and each SpMV fetches the x entries it needs:

- ``"all_gather"``: general matrices; the full vector is gathered on every
  rank. O(n) communication, always correct.
- ``"halo"``: banded matrices whose every row block's columns fall in the
  neighbouring blocks (``halo_ok``): only the two neighbours' blocks are
  exchanged, cyclically, so periodic corners work. O(2 n / p).

The shard product is ELL in plain PyTorch (a gather and a row sum), as JAX
computes it in ``jnp``. ``psum_norm`` and ``psum_vdot`` are the reductions
over the row shards that the distributed solvers inject into the
single-device loops.

Unlike JAX's global sharded arrays, a partition here holds this rank's
block only, and ``distributed_matvec`` maps this rank's block of x to its
block of y. Every partition kind of the distributed layer answers
``local_matvec(mesh, exchange)`` (the shard SpMV with its exchange, a
closure over this rank's blocks) and ``local_block(x, mesh)`` (this rank's
block of a host vector in the operator's vector domain), which the solvers
of ``parallel/`` are written against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..matrix.sparse import SparseCSR, SparseELL
from .mesh import (ROW_AXIS, RowMesh, all_gather_rows, all_reduce_sum, axis_size,
                   neighbour_exchange, row_block)

EXCHANGES = ("auto", "all_gather", "halo")


def padded_block(x, n_padded: int, mesh: RowMesh) -> torch.Tensor:
    """This rank's block of the host (n,) vector ``x`` zero-padded to
    ``n_padded`` (padding entries start, and stay, at zero)."""
    xh = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    xp = np.zeros((n_padded,) + xh.shape[1:], xh.dtype)
    xp[:xh.shape[0]] = xh
    return row_block(xp, mesh)


@dataclasses.dataclass(frozen=True)
class PartitionedELL:
    """A square operator row-partitioned over a row mesh: this rank's rows.

    ``data``/``indices`` are this rank's (rows_per_shard, width) block of
    the (n_padded, width) padded ELL arrays (global column indices). Of
    the n_padded rows ``n_orig`` are real and the rest are zero, so that
    every rank holds ``n_padded / n_shards`` rows; zero rows contribute
    nothing to products or norms as long as the iterate's padding starts
    at zero. ``halo_ok`` records whether every structural entry's column
    falls within its row's block +/- one neighbour block (cyclically);
    ``nnz`` counts the nonzeros of the whole operator."""

    data: torch.Tensor     # (rows_per_shard, width)
    indices: torch.Tensor  # (rows_per_shard, width) int32
    n_orig: int
    n_shards: int
    halo_ok: bool
    nnz: int

    @property
    def rows_per_shard(self) -> int:
        return self.data.shape[0]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        body = spmv_halo if resolve_exchange(self, exchange) == "halo" else spmv_all_gather
        return lambda x_local: body(self.data, self.indices, x_local, mesh)

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        return padded_block(x, self.n_padded, mesh)


def partition_ell(m: SparseCSR | SparseELL, mesh: RowMesh, *,
                  axis: str = ROW_AXIS) -> PartitionedELL:
    """Pad a square sparse matrix and keep this rank's rows on its device."""
    ell = m.to_ell() if isinstance(m, SparseCSR) else m
    n, n_cols = ell.shape
    if n != n_cols:
        raise ValueError("partition_ell: matrix must be square")
    n_shards = axis_size(mesh, axis)
    rows_per_shard = -(-n // n_shards)
    n_padded = rows_per_shard * n_shards

    ell_data = ell.data.cpu().numpy()
    data = np.zeros((n_padded, ell_data.shape[1]), dtype=ell_data.dtype)
    indices = np.zeros((n_padded, ell_data.shape[1]), dtype=np.int32)
    data[:n] = ell_data
    indices[:n] = ell.indices.cpu().numpy()

    # halo feasibility: every structural entry's column within owner block
    # +/- one neighbour block
    row_blk = np.arange(n_padded)[:, None] // rows_per_shard
    col_blk = indices // rows_per_shard
    structural = data != 0
    diff = np.abs(row_blk - col_blk)
    diff = np.minimum(diff, n_shards - diff)  # cyclic distance: periodic bands OK
    halo_ok = bool(n_shards == 1 or not structural.any() or (diff[structural].max() <= 1))
    return PartitionedELL(data=row_block(data, mesh), indices=row_block(indices, mesh),
                          n_orig=n, n_shards=n_shards, halo_ok=halo_ok,
                          nnz=int(np.count_nonzero(data)))


# --- shard SpMV bodies (x arguments are this rank's blocks) ----------------

def spmv_all_gather(data_local, indices_local, x_local, mesh: RowMesh):
    """y_local = A_local @ all_gather(x). General-purpose exchange."""
    x_full = all_gather_rows(x_local, mesh)
    return torch.sum(data_local * x_full[indices_local.long()], dim=1)


def spmv_halo(data_local, indices_local, x_local, mesh: RowMesh):
    """y_local from the left/right neighbours' x blocks only.

    Valid when ``halo_ok``: the columns of rank i fall in blocks i-1, i,
    i+1 (cyclically). The window ``[x_{i-1} | x_i | x_{i+1}]`` is indexed
    by the columns rebased to it; at world size 1 the neighbours are
    zeros and every column lies in the middle block."""
    p, i = mesh.world_size, mesh.rank
    rps = x_local.shape[0]
    right_of_left, left_of_right = neighbour_exchange(mesh, x_local, x_local, cyclic=True)
    window = torch.cat([right_of_left, x_local, left_of_right])
    idx = indices_local.long() - (i - 1) * rps
    # cyclic wrap: rank 0's left neighbour is p-1, whose global indices are
    # high; map them into window slot 0. Same for the last rank's right.
    idx = torch.where(idx < 0, idx + p * rps, idx)
    idx = torch.where(idx >= 3 * rps, idx - p * rps, idx)
    # padding entries (data == 0) may still carry index 0; clamp for safety
    idx = torch.clamp(idx, 0, 3 * rps - 1)
    return torch.sum(data_local * window[idx], dim=1)


def psum_norm(v_local, mesh: RowMesh):
    """Global 2-norm of a row-partitioned vector."""
    return torch.sqrt(all_reduce_sum(torch.sum(torch.abs(v_local) ** 2), mesh))


def psum_vdot(a_local, b_local, mesh: RowMesh):
    """Global conjugating dot product of row-partitioned vectors."""
    return all_reduce_sum(torch.vdot(a_local.reshape(-1), b_local.reshape(-1)), mesh)


def resolve_exchange(A: PartitionedELL, exchange: str) -> str:
    """``"auto"`` -> ``"halo"`` when ``A.halo_ok``, else ``"all_gather"``;
    ``"halo"`` on an operator wider than the halo window raises."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r} (one of {EXCHANGES})")
    if exchange == "auto":
        return "halo" if A.halo_ok else "all_gather"
    if exchange == "halo" and not A.halo_ok:
        # fail loudly: the halo window only covers blocks i-1, i, i+1 — a
        # wider operator through this path would silently clamp its columns
        # into the window and return wrong values
        raise ValueError(
            "distributed_matvec: exchange='halo' requested but the operator's "
            "column span exceeds the +/-1-block halo window (halo_ok=False); "
            "use exchange='all_gather'")
    return exchange


def distributed_matvec(A: PartitionedELL, x_local, mesh: RowMesh, *, axis: str = ROW_AXIS,
                       exchange: str = "auto"):
    """One distributed SpMV: this rank's block of x -> its block of y."""
    axis_size(mesh, axis)
    return A.local_matvec(mesh, exchange)(x_local)
