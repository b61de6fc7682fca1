"""Segment-pruned distributed general-sparse SpMV with an overlapped exchange
(the port of the JAX package's ``parallel/gell_pruned.py``).

- At partition time each rank's **column footprint** is recorded: the
  128-wide column segments its nonzeros touch outside its own row block.
  Communication scales with the footprint, not with n.
- The footprint is split by owning rank and exchanged once per mesh
  distance that some rank needs (the plan: for each active distance d,
  the owner-local segment rows this rank sends to rank + d, and the rows of
  the compact footprint buffer that the segments from rank - d fill; padding
  entries point at the dump row ``max_fp``). The plan, the footprint and the
  distances are built exactly as JAX builds them.
- The local rows x local columns block is packed separately and computes
  from the rank's own x block. A matvec posts the sends and receives first,
  runs the own-block B6 launch, then waits and runs the remote-footprint B6
  launch: the overlap JAX asks XLA's scheduler for.

A block-diagonal matrix exchanges nothing; one whose every rank references
every segment exchanges everything (all-gather volume). Each rank keeps its
own packs, so JAX's ``_stack_packs`` (one sharded array of every shard's
pack, spill tails padded to one length) has nothing to do here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.options import SolverOptions
from ..core.results import EigenResult
from ..matrix.sparse import SparseCSR
from ..ops.gell_spmv import LANES, GELLPack, pack_gell
from ..utils.timing import spanned
from .gell import auto_tile_rows, gell_local_matvec, host_coo, shard_rows
from .mesh import ROW_AXIS, RowMesh, axis_size, post_exchange
from .power import host_start_vector, partition_power
from .sharded import padded_block


@dataclasses.dataclass(frozen=True)
class PrunedGELL:
    """This rank's share of a row-partitioned operator: the own-block pack,
    the footprint pack (None when no rank references a remote column) and
    the exchange plan, ``((send_idx, recv_pos), ...)`` one pair a distance
    of ``distances``."""

    own: GELLPack             # (rows_per_shard, rows_per_shard): local columns
    rem: GELLPack | None      # (rows_per_shard, (max_fp + 1) * 128): footprint columns
    plan: tuple               # ((send_idx (M_d,), recv_pos (M_d,)) int64, ...)
    footprint: tuple          # this rank's remote segments (global ids), ascending
    n_orig: int
    n_shards: int
    tile_rows: int
    max_fp: int
    distances: tuple
    has_remote: bool

    @property
    def rows_per_shard(self) -> int:
        return self.own.shape[0]

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.own.dtype

    @property
    def comm_bytes_per_matvec(self) -> int:
        """This rank's payload sent per SpMV: M_d segment rows of 128
        scalars for each active distance (the same on every rank)."""
        item = torch.empty(0, dtype=self.dtype).element_size()
        return sum(int(send.shape[0]) * LANES * item for send, _ in self.plan)

    def local_matvec(self, mesh: RowMesh, exchange: str = "auto"):
        return lambda x_local: _pruned_local(self, x_local, mesh)

    def local_block(self, x, mesh: RowMesh) -> torch.Tensor:
        return padded_block(x, self.n_padded, mesh)


def partition_gell_pruned(m: SparseCSR, mesh: RowMesh, *, axis: str = ROW_AXIS,
                          tile_rows: int | None = None) -> PrunedGELL:
    """Pack this rank's rows with the pruned-exchange plan."""
    n, n_cols = m.shape
    if n != n_cols:
        raise ValueError("partition_gell_pruned: matrix must be square")
    S = axis_size(mesh, axis)
    if tile_rows is None:
        tile_rows = auto_tile_rows(n, m.nnz)
    rps = shard_rows(n, S, tile_rows)
    segs_per_shard = rps // LANES

    rows, cols, vals = host_coo(m)
    if np.dtype(vals.dtype).kind == "c":
        raise ValueError("partition_gell_pruned: complex operators use the "
                         "split-complex partitions")
    shard_of = rows // rps

    # --- every rank's footprint (the plan needs them all) -------------------
    fps = []
    for s in range(S):
        c_ = cols[shard_of == s]
        own = (c_ >= s * rps) & (c_ < (s + 1) * rps)
        fps.append(np.unique(c_[~own] // LANES))
    max_fp = max((len(f) for f in fps), default=0)
    has_remote = max_fp > 0

    # --- this rank's packs ----------------------------------------------------
    r = mesh.rank
    sel = shard_of == r
    r_, c_, v_ = rows[sel] - r * rps, cols[sel], vals[sel]
    own = (c_ >= r * rps) & (c_ < (r + 1) * rps)
    own_pack = pack_gell(r_[own], c_[own] - r * rps, v_[own], (rps, rps),
                         tile_rows=tile_rows, device=mesh.device)
    rem_pack = None
    if has_remote:
        pos = {g: i for i, g in enumerate(fps[r])}
        cr = c_[~own]
        loc = (np.array([pos[g] for g in cr // LANES], np.int64) * LANES + cr % LANES
               if len(cr) else np.zeros(0, np.int64))
        rem_pack = pack_gell(r_[~own], loc, v_[~own], (rps, (max_fp + 1) * LANES),
                             tile_rows=tile_rows, device=mesh.device)

    # --- the exchange plan: this rank's rows of JAX's (S, M_d) arrays -------
    plan, distances = [], []
    for d in range(1, S):
        # owner of segment g is g // segs_per_shard (segments never straddle
        # shard boundaries: rps is a multiple of 128)
        needs = [[g for g in fps[s] if g // segs_per_shard == (s - d) % S] for s in range(S)]
        M_d = max((len(need) for need in needs), default=0)
        if M_d == 0:
            continue
        send_idx = np.zeros(M_d, np.int64)
        to_send = needs[(r + d) % S]
        send_idx[:len(to_send)] = [g - r * segs_per_shard for g in to_send]
        recv_pos = np.full(M_d, max_fp, np.int64)  # pad -> dump row
        pos = {g: i for i, g in enumerate(fps[r])}
        recv_pos[:len(needs[r])] = [pos[g] for g in needs[r]]
        plan.append((torch.from_numpy(send_idx).to(mesh.device),
                     torch.from_numpy(recv_pos).to(mesh.device)))
        distances.append(d)

    return PrunedGELL(own=own_pack, rem=rem_pack, plan=tuple(plan),
                      footprint=tuple(int(g) for g in fps[r]), n_orig=n, n_shards=S,
                      tile_rows=tile_rows, max_fp=max_fp, distances=tuple(distances),
                      has_remote=has_remote)


def _pruned_local(A: PrunedGELL, x_local, mesh: RowMesh):
    """This rank's block of A x: the exchange posted, the own block, then
    the footprint block once the segments have arrived."""
    S, r = A.n_shards, mesh.rank
    xseg = x_local.reshape(-1, LANES)
    # 1) post the segment exchange, one send and one receive a distance
    sends, recvs = [], []
    for tag, (d, (send_idx, recv_pos)) in enumerate(zip(A.distances, A.plan)):
        sends.append(((r + d) % S, xseg[send_idx], tag))
        recvs.append(((r - d) % S, xseg.new_empty((recv_pos.shape[0], LANES)), tag))
    pending = post_exchange(mesh, sends, recvs)
    # 2) the own block: no communication dependency (the overlap target)
    y = gell_local_matvec(A.own, x_local)
    # 3) the received segments into the compact footprint buffer, then the
    #    footprint block
    for work in pending:
        work.wait()
    if A.has_remote:
        xc = xseg.new_zeros((A.max_fp + 1, LANES))
        for (_, recv_pos), (_, buf, _) in zip(A.plan, recvs):
            xc[recv_pos] = buf
        y = y + gell_local_matvec(A.rem, xc.reshape(-1))
    return y


def pruned_gell_matvec(A: PrunedGELL, x_local, mesh: RowMesh, *, axis: str = ROW_AXIS):
    """One distributed SpMV: this rank's block of x -> its block of y;
    ``A.comm_bytes_per_matvec`` sent per rank instead of all-gather's O(n)."""
    axis_size(mesh, axis)
    return A.local_matvec(mesh)(x_local)


@spanned
def distributed_gell_power_pruned(A: PrunedGELL, mesh: RowMesh,
                                  opts: SolverOptions | None = None, *, axis: str = ROW_AXIS,
                                  generator: torch.Generator | None = None,
                                  x0=None) -> EigenResult:
    """Dominant eigenpair via pruned-exchange power iteration (reference loop
    semantics, power_method.hpp:47-99, with distributed reductions)."""
    axis_size(mesh, axis)
    opts = SolverOptions() if opts is None else opts
    xh = host_start_vector(A.n_orig, A.dtype, generator, x0)
    return partition_power(A, mesh, opts, A.local_block(xh, mesh))
