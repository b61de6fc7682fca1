"""Moving state across from numpy and from the JAX package.

``to_tensor`` turns any array-like into a tensor (copying, so the tensor
never aliases the caller's array). ``from_numpy_leaves`` rebuilds one of the
port's matrices from the leaves and static fields of the JAX package's
matrix of the same kind, so both sides compute on identical data. The leaves
come in as numpy arrays (``np.asarray`` of each JAX leaf, in pytree order),
so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import as_torch_dtype


def to_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """A copy of ``a`` as a tensor on ``device`` (default: where ``a`` lies,
    the CPU for host arrays), cast to ``dtype`` when given.

    numpy ``bfloat16`` arrays (``ml_dtypes``, which ``torch.from_numpy``
    rejects) move bit-exactly: viewed as int16, then as ``torch.bfloat16``.
    """
    if isinstance(a, torch.Tensor):
        t = a.clone()
    else:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=None if dtype is None else as_torch_dtype(dtype))


# kind -> names of its tensor leaves, in the JAX pytree's order
_LEAVES = {
    "DenseMatrix": ("array",),
    "SparseCSR": ("data", "indices", "rows", "indptr"),
    "SparseELL": ("data", "indices"),
    "SparseDIA": ("data",),
    "InterleavedDIA": ("data_il",),
    "SplitComplexDIA": ("planes",),
    "InterleavedSplitComplexDIA": ("planes_il",),
    "SparseGELL": ("seg_packed", "val", "inv", "sp_rows", "sp_cols", "sp_vals", "chunk_ids",
                   "diag"),
    "PartitionedELL": ("data", "indices"),
    "PartitionedDIA": ("data",),
    "PartitionedILDIA": ("data_il",),
    "PartitionedSplitComplexDIA": ("planes",),
}

# partitioned kind -> the axis of its stacked leaves that the ranks split
_ROW_AXIS = {"PartitionedELL": 0, "PartitionedDIA": 1, "PartitionedILDIA": 1,
             "PartitionedSplitComplexDIA": 2}


def from_numpy_leaves(kind: str, leaves: Sequence[np.ndarray], static: dict,
                      device=None, *, mesh=None):
    """Build the port's ``kind`` matrix from a JAX matrix's leaves.

    ``kind`` is the class name (``"DenseMatrix"``, ``"SparseCSR"``,
    ``"SparseELL"``, ``"SparseDIA"``, ``"InterleavedDIA"``, ``"SplitComplexDIA"``,
    ``"InterleavedSplitComplexDIA"`` or ``"SparseGELL"``); ``leaves`` are
    its array leaves in pytree order; ``static`` holds its static fields
    (``shape``, ``offsets``, ``tile_s`` as the kind has them; for
    ``SparseGELL`` the pack's ``shape``, ``tile_rows`` and ``is_complex`` and
    the matrix's ``nnz``). The tensors go to ``device`` (default: the card).

    A JAX ``SparseGELL`` is decoded back to COO (``unpack_gell_leaves``) and
    packed in the port's own layout; its ``chunk_ids`` leaf is not needed.

    The partitioned kinds of the distributed layer (``"PartitionedELL"``,
    ``"PartitionedDIA"``, ``"PartitionedILDIA"``,
    ``"PartitionedSplitComplexDIA"``) take the JAX partition's leaves, which
    stack every shard, and its static fields, and return the block of the
    rank of ``mesh`` (a ``parallel.mesh.RowMesh`` of ``n_shards`` ranks) on
    ``device`` (default: the mesh's device).
    """
    from ..matrix.dense import DenseMatrix
    from ..matrix.dia import InterleavedDIA, SparseDIA
    from ..matrix.gell import SparseGELL
    from ..matrix.sparse import SparseCSR, SparseELL
    from ..matrix.split_complex import InterleavedSplitComplexDIA, SplitComplexDIA

    classes = {"DenseMatrix": DenseMatrix, "SparseCSR": SparseCSR,
               "SparseELL": SparseELL, "SparseDIA": SparseDIA,
               "InterleavedDIA": InterleavedDIA, "SplitComplexDIA": SplitComplexDIA,
               "InterleavedSplitComplexDIA": InterleavedSplitComplexDIA,
               "SparseGELL": SparseGELL}
    if kind not in classes and kind not in _ROW_AXIS:
        raise ValueError(f"from_numpy_leaves: unknown matrix kind {kind!r}")
    names = _LEAVES[kind]
    if len(leaves) != len(names):
        raise ValueError(f"from_numpy_leaves: {kind} has {len(names)} leaves, "
                         f"got {len(leaves)}")
    if kind in _ROW_AXIS:
        return _partition_from_leaves(kind, leaves, static, device, mesh)
    device = resolve_device(device)
    if kind == "SparseGELL":
        return _gell_from_leaves(leaves, static, device)
    fields = {name: to_tensor(leaf, device=device)
              for name, leaf in zip(names, leaves)}
    for key in ("shape", "offsets"):
        if key in static:
            fields[key] = tuple(int(v) for v in static[key])
    if "tile_s" in static:
        fields["tile_s"] = int(static["tile_s"])
    return classes[kind](**fields)


def _gell_from_leaves(leaves, static: dict, device: torch.device):
    """The port's ``SparseGELL`` holding the entries of a JAX GELL pack."""
    from ..matrix.gell import SparseGELL
    from ..ops.gell_spmv import build_pack, unpack_gell_leaves

    seg_packed, val, inv, sp_rows, sp_cols, sp_vals, _, diag = leaves
    is_complex = bool(static["is_complex"])
    row, col, values = unpack_gell_leaves(seg_packed, val, inv, sp_rows, sp_cols, sp_vals,
                                          int(static["tile_rows"]), is_complex)
    pack = build_pack(row, col, to_tensor(values), tuple(int(v) for v in static["shape"]),
                      is_complex=is_complex, tile_rows=int(static["tile_rows"]), device=device)
    return SparseGELL(pack=pack, diag=to_tensor(diag, device=device), nnz=int(static["nnz"]))


def _partition_from_leaves(kind: str, leaves, static: dict, device, mesh):
    """This rank's block of a JAX partition (see ``from_numpy_leaves``)."""
    from ..parallel import dia, sharded, split_complex

    if mesh is None:
        raise ValueError(f"from_numpy_leaves: {kind} needs the mesh whose rank's block to take")
    n_shards = int(static["n_shards"])
    if n_shards != mesh.world_size:
        raise ValueError(f"from_numpy_leaves: the {kind} has {n_shards} shards, the mesh "
                         f"{mesh.world_size} ranks")
    device = mesh.device if device is None else resolve_device(device)
    dim = _ROW_AXIS[kind]

    def block(leaf):
        t = to_tensor(leaf)
        rows = t.shape[dim] // n_shards
        return t.narrow(dim, mesh.rank * rows, rows).contiguous().to(device)

    fields = {name: block(leaf) for name, leaf in zip(_LEAVES[kind], leaves)}
    common = {"n_orig": int(static["n_orig"]), "n_shards": n_shards}
    nnz = int(np.count_nonzero(np.asarray(leaves[0])))
    if kind == "PartitionedELL":
        return sharded.PartitionedELL(**fields, **common, halo_ok=bool(static["halo_ok"]),
                                      nnz=nnz)
    offsets = tuple(int(o) for o in static["offsets"])
    if kind == "PartitionedDIA":
        return dia.PartitionedDIA(**fields, offsets=offsets, **common,
                                  halo=int(static["halo"]), nnz=nnz)
    if kind == "PartitionedILDIA":
        return dia.PartitionedILDIA(**fields, offsets=offsets, **common,
                                    tile_s=int(static["tile_s"]))
    return split_complex.PartitionedSplitComplexDIA(**fields, offsets=offsets, **common,
                                                    halo=int(static["halo"]))
