"""``SparseGELL`` — the execution format for general unstructured sparse.

The operator type behind the fast path for the reference's sparse ``A * x``
(reference src/power_method/power_method.hpp:69, sparse arm of
src/matrix/matrix.hpp:39-44). ``SparseCSR`` stays the ingest and storage
format; ``SparseCSR.to_gell()`` re-packs its nonzeros for the CUDA kernel B6
(``ops/gell_spmv.py``, ``csrc/gell_spmv.cu``). The packing is a one-time
cost, like the reference's ``makeCompressed()``, made on the device that
holds the pack (``ops/gell_spmv.py::pack_device``; ``diag`` beside it); the
matvec runs there.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.dtypes import canonical_dtype
from ..ops.gell_spmv import (PACK_CHUNK, GELLPack, gell_matvec, index_tensor, pack_device,
                             pack_gell, value_tensor)
from .protocol import AbstractMatrix


@dataclasses.dataclass(frozen=True)
class SparseGELL(AbstractMatrix):
    """General sparse matrix in the GELL pack (see module docstring).

    ``diag`` is computed at pack time where the pack is built, duplicates
    summed, over ``min(n_rows, n_cols)``; ``nnz`` counts the input entries,
    duplicates included."""

    pack: GELLPack
    diag: torch.Tensor
    nnz: int

    # --- constructors ---
    @staticmethod
    def from_coo(row, col, values, shape, dtype=None,
                 tile_rows: int | None = None, device=None) -> "SparseGELL":
        """Pack COO triplets (``pack_gell``) on ``device`` when given, else
        where card tensors lie, else on the card (``pack_device``), and sum
        ``diag`` there. ``tile_rows`` is the JAX keyword, checked and
        recorded (``GELLPack``)."""
        n_rows, n_cols = map(int, shape)
        dev = pack_device(device, row, col, values)
        r, c, v = index_tensor(row, dev), index_tensor(col, dev), value_tensor(values, dev)
        v = v.to(canonical_dtype(v.dtype if dtype is None else dtype))
        if not (r.shape == c.shape == v.shape) or r.ndim != 1:
            raise ValueError("SparseGELL.from_coo: row/col/values must be 1-D of equal length")
        # pack_gell raises "Sparse indices out of range", as JAX's from_coo does
        pack = pack_gell(r, c, v, (n_rows, n_cols), tile_rows=tile_rows, device=dev)
        return SparseGELL(pack=pack, diag=coo_diagonal(r, c, v, min(n_rows, n_cols)),
                          nnz=r.numel())

    @staticmethod
    def from_csr(csr, tile_rows: int | None = None) -> "SparseGELL":
        """Re-pack a ``SparseCSR`` on the device where it lies."""
        return SparseGELL.from_coo(csr.rows, csr.indices, csr.data, csr.shape,
                                   tile_rows=tile_rows, device=csr.device)

    # --- queries ---
    @property
    def shape(self) -> tuple:
        return self.pack.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.pack.dtype

    @property
    def device(self) -> torch.device:
        return self.pack.device

    @property
    def is_dense(self) -> bool:
        return False

    # --- compute ---
    def matvec(self, x):
        return gell_matvec(self.pack, x)

    def diagonal(self):
        return self.diag


def coo_diagonal(row: torch.Tensor, col: torch.Tensor, values: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The first ``k`` diagonal entries of a COO, duplicates summed in input
    order, on its device: ``PACK_CHUNK`` entries a step."""
    d = torch.zeros(k, dtype=values.dtype, device=values.device)
    for s in range(0, row.numel(), PACK_CHUNK):
        r, c = row[s:s + PACK_CHUNK], col[s:s + PACK_CHUNK]
        on = ((r == c) & (r < k)).nonzero().squeeze(1)
        d.index_add_(0, r[on].long(), values[s:s + PACK_CHUNK][on])
    return d
