"""``SparseGELL`` — the execution format for general unstructured sparse.

The operator type behind the fast path for the reference's sparse ``A * x``
(reference src/power_method/power_method.hpp:69, sparse arm of
src/matrix/matrix.hpp:39-44). ``SparseCSR`` stays the ingest and storage
format; ``SparseCSR.to_gell()`` re-packs its nonzeros for the CUDA kernel B6
(``ops/gell_spmv.py``, ``csrc/gell_spmv.cu``). The packing is a one-time
host cost, like the reference's ``makeCompressed()``; the matvec runs on the
device where the pack lies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dtypes import canonical_dtype, numpy_dtype
from ..ops.gell_spmv import GELLPack, gell_matvec, pack_gell
from .protocol import AbstractMatrix


@dataclasses.dataclass(frozen=True)
class SparseGELL(AbstractMatrix):
    """General sparse matrix in the GELL pack (see module docstring).

    ``diag`` is computed at pack time on the host, duplicates summed, over
    ``min(n_rows, n_cols)``; ``nnz`` counts the input entries, duplicates
    included."""

    pack: GELLPack
    diag: torch.Tensor
    nnz: int

    # --- constructors ---
    @staticmethod
    def from_coo(row, col, values, shape, dtype=None,
                 tile_rows: int | None = None, device=None) -> "SparseGELL":
        """Pack COO triplets on ``device`` (default: the card). ``tile_rows``
        is the JAX keyword, checked and recorded (``GELLPack``)."""
        n_rows, n_cols = map(int, shape)
        r = np.asarray(row, np.int64)
        c = np.asarray(col, np.int64)
        v = np.asarray(values, dtype=numpy_dtype(dtype) if dtype else None)
        canonical_dtype(v.dtype)
        if not (r.shape == c.shape == v.shape) or r.ndim != 1:
            raise ValueError("SparseGELL.from_coo: row/col/values must be 1-D of equal length")
        # pack_gell raises "Sparse indices out of range", as JAX's from_coo does
        pack = pack_gell(r, c, v, (n_rows, n_cols), tile_rows=tile_rows, device=device)
        k = min(n_rows, n_cols)
        d = np.zeros(k, v.dtype)
        on = (r == c) & (r < k)
        np.add.at(d, r[on], v[on])
        return SparseGELL(pack=pack, diag=torch.from_numpy(d).to(pack.device),
                          nnz=int(r.size))

    @staticmethod
    def from_csr(csr, tile_rows: int | None = None) -> "SparseGELL":
        """Re-pack a ``SparseCSR`` on the device where it lies."""
        return SparseGELL.from_coo(csr.rows.cpu().numpy(), csr.indices.cpu().numpy(),
                                   csr.data.cpu().numpy(), csr.shape, tile_rows=tile_rows,
                                   device=csr.device)

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
