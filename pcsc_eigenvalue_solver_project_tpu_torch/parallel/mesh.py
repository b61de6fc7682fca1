"""Row meshes on process groups, and the collectives of the distributed layer.

The port of the JAX package's ``parallel/mesh.py``. JAX runs the
distributed layer single-controller: one process, ``shard_map`` over a
1-D device mesh. The port runs it SPMD: one process per rank, each holding
its row block of the operator and of every vector, over a
``torch.distributed`` process group (NCCL for a CUDA rank, gloo for a CPU
rank). A ``RowMesh`` names the group, this rank, the world size and the
rank's device.

What the JAX collectives become:

- ``psum`` -> ``all_reduce`` (``all_reduce_sum``);
- ``all_gather(tiled=True)`` -> ``all_gather_single`` where this torch has
  it, else ``all_gather_into_tensor`` (``all_gather_rows``);
- ``ppermute`` -> ``batch_isend_irecv`` (``neighbour_exchange``,
  ``post_exchange``). At world size 1 nothing is sent: the halos read zeros,
  as JAX's edge shards do.

Complex tensors travel as ``torch.view_as_real`` views, so that gloo and
NCCL see real buffers. Every rank calls the same collectives in the same
order: the reductions give every rank the same bits, so the host decisions
taken from them (a loop's ``done``, a restart's basis size) agree.

JAX's ``row_sharding`` and ``replicated`` place a host array on the mesh;
here ``row_block`` takes this rank's block of a host array, and a
replicated array is the whole array on the rank's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..utils.interop import to_tensor

ROW_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D row mesh: the process group, this rank, the world size, the
    rank's device and the axis name."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    axis: str = ROW_AXIS

    @property
    def shape(self) -> dict:
        """``{axis: world_size}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.world_size}

    def global_rank(self, rank: int) -> int:
        """The global rank of the group's ``rank`` (peers of point-to-point
        operations are global ranks)."""
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)


def initialize_distributed(*, device=None, **kwargs) -> None:
    """Multi-process entry: call once per process before building meshes.

    ``init_process_group`` with NCCL when ``device`` (default: the card) is
    a CUDA device and gloo otherwise; ``kwargs`` (``init_method``,
    ``world_size``, ``rank``, ``timeout``, ...) go to it as given."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", **kwargs)


def make_row_mesh(n_devices: int | None = None, *, axis: str = ROW_AXIS, group=None,
                  device=None) -> RowMesh:
    """The row mesh of ``group`` (default: the whole world) with this rank
    on ``device`` (default: the card, the current CUDA device).

    ``n_devices``, when given, must be the group's size. A CUDA device needs
    an NCCL group and a CPU device a gloo group: anything else raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_row_mesh: no process group; call initialize_distributed "
                           "(or torch.distributed.init_process_group) first")
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_row_mesh: requested {n_devices} devices, the process group "
                         f"has {world} ranks")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if device.type == "cuda" and "nccl" not in backend:
        raise ValueError(f"make_row_mesh: a CUDA rank needs an NCCL group, got {backend!r}")
    if device.type != "cuda" and "gloo" not in backend:
        raise ValueError(f"make_row_mesh: a {device.type} rank needs a gloo group, "
                         f"got {backend!r}")
    return RowMesh(group=group, rank=dist.get_rank(group), world_size=world, device=device,
                   axis=axis)


def axis_size(mesh: RowMesh, axis: str) -> int:
    """The number of shards along ``axis`` (``mesh.shape[axis]`` in JAX)."""
    return mesh.shape[axis]


def row_block(a, mesh: RowMesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of the host array ``a`` along ``dim`` (whose length
    the world size divides), as a tensor on the rank's device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    size = t.shape[dim]
    if size % mesh.world_size:
        raise ValueError(f"row_block: {size} rows do not split over {mesh.world_size} ranks")
    rows = size // mesh.world_size
    return to_tensor(t.narrow(dim, mesh.rank * rows, rows), device=mesh.device)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce_sum(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (``lax.psum``), a new tensor."""
    out = t.clone()
    dist.all_reduce(_real(out), group=mesh.group)
    return out


def all_gather_rows(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along dim 0, rank order
    (``lax.all_gather(tiled=True)``)."""
    t = t.contiguous()
    out = t.new_empty((mesh.world_size * t.shape[0],) + tuple(t.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(_real(out), _real(t), group=mesh.group)
    return out


def post_exchange(mesh: RowMesh, sends, recvs) -> list:
    """Post sends ``(peer, tensor, tag)`` and receives ``(peer, buffer, tag)``
    (peers are ranks of the mesh's group) in one ``batch_isend_irecv``;
    received data lands in the buffers once every returned work has been
    waited on. The peers of a pair of ranks must post their transfers in the
    same order."""
    ops = [dist.P2POp(dist.isend, _real(t.contiguous()), mesh.global_rank(peer), mesh.group,
                      tag) for peer, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, _real(buf), mesh.global_rank(peer), mesh.group, tag)
            for peer, buf, tag in recvs]
    return dist.batch_isend_irecv(ops) if ops else []


def neighbour_exchange(mesh: RowMesh, to_prev: torch.Tensor, to_next: torch.Tensor, *,
                       cyclic: bool):
    """Send ``to_next`` to rank + 1 and ``to_prev`` to rank - 1; return
    ``(from_prev, from_next)``: what rank - 1 sent forward (shaped like
    ``to_next``) and what rank + 1 sent back (shaped like ``to_prev``).

    ``cyclic`` wraps the ends around (rank 0's previous rank is the last);
    otherwise, and at world size 1, a missing neighbour reads zeros."""
    p, r = mesh.world_size, mesh.rank
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    if p == 1:
        return from_prev, from_next
    nxt = (r + 1) % p if cyclic or r + 1 < p else None
    prv = (r - 1) % p if cyclic or r > 0 else None
    # tag 0 travels forward, tag 1 back; sends and receives in that order on
    # every rank, so that two ranks that are each other's both neighbours
    # (world size 2, cyclic) match them up under NCCL too
    sends = [(nxt, to_next, 0)] if nxt is not None else []
    sends += [(prv, to_prev, 1)] if prv is not None else []
    recvs = [(prv, from_prev, 0)] if prv is not None else []
    recvs += [(nxt, from_next, 1)] if nxt is not None else []
    for work in post_exchange(mesh, sends, recvs):
        work.wait()
    return from_prev, from_next
