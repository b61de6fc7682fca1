"""Sparse matrix types: CSR (authoritative) and ELL (padded rows).

Replaces the sparse arm of ``EigSol::Matrix`` (``Matrix::Sparse<Scalar>``;
reference src/matrix/matrix.hpp:39-44,89-94). The reference ingests COO
triplets and compresses (file_matrix_reader.hpp:84-132); here COO is
ingested on the host with NumPy, row-sorted, and stored as CSR plus an
expanded row-id array so SpMV is a gather plus an index-add.

``SparseELL`` is the padded fixed-row-width layout: every row is padded to
the maximum row nnz so the SpMV becomes one 2-D gather + row reduction.
``to_gell`` re-packs a CSR matrix as ``SparseGELL`` (``matrix/gell.py``),
whose matvec is the CUDA kernel B6 on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import canonical_dtype, numpy_dtype
from ..ops.matvec import csr_matvec, ell_matvec
from .protocol import AbstractMatrix


@dataclasses.dataclass(frozen=True)
class SparseCSR(AbstractMatrix):
    """CSR matrix: data/indices/rows/indptr tensors plus the shape.

    ``rows`` is the per-nnz row id (COO expansion of ``indptr``), kept so
    SpMV and conversions need no ``repeat_interleave``.
    """

    data: torch.Tensor      # (nnz,) scalar dtype
    indices: torch.Tensor   # (nnz,) int32 column indices, row-major sorted
    rows: torch.Tensor      # (nnz,) int32 row ids, sorted ascending
    indptr: torch.Tensor    # (n_rows + 1,) int32
    shape: tuple

    # --- constructors ---
    @staticmethod
    def from_coo(row, col, values, shape, dtype=None, *,
                 sum_duplicates: bool = True, device=None) -> "SparseCSR":
        """Build from COO triplets on the host, then place on ``device``
        (default: the card).

        With ``sum_duplicates=False`` a repeated (row, col) raises
        ``ValueError`` — parity with Eigen ``insert()`` which rejects
        duplicate insertion (used by the reference reader,
        file_matrix_reader.hpp:118-128).
        """
        n_rows, n_cols = map(int, shape)
        dtype = numpy_dtype(dtype)
        r = np.asarray(row, dtype=np.int64)
        c = np.asarray(col, dtype=np.int64)
        v = np.asarray(values, dtype=dtype)
        if not (r.shape == c.shape == v.shape) or r.ndim != 1:
            raise ValueError("SparseCSR.from_coo: row/col/values must be 1-D of equal length")
        if r.size and (r.min() < 0 or r.max() >= n_rows or c.min() < 0 or c.max() >= n_cols):
            raise ValueError("Sparse indices out of range")
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        if r.size:
            dup = (np.diff(r) == 0) & (np.diff(c) == 0)
            if dup.any():
                if not sum_duplicates:
                    raise ValueError("SparseCSR.from_coo: duplicate (row, col) entry")
                # segment-sum duplicates on host
                keep = np.concatenate([[True], ~dup])
                group = np.cumsum(keep) - 1
                v = np.bincount(group, weights=v.real).astype(v.real.dtype) if v.dtype.kind != "c" \
                    else (np.bincount(group, weights=v.real) + 1j * np.bincount(group, weights=v.imag)).astype(v.dtype)
                r, c = r[keep], c[keep]
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr)
        canonical_dtype(v.dtype)
        device = resolve_device(device)

        def put(a, dt=None):
            return torch.from_numpy(np.array(a, dtype=dt)).to(device)

        return SparseCSR(data=put(v), indices=put(c, np.int32),
                         rows=put(r, np.int32), indptr=put(indptr, np.int32),
                         shape=(n_rows, n_cols))

    @staticmethod
    def from_scipy(mat, dtype=None, device=None) -> "SparseCSR":
        """Build from a scipy.sparse matrix (host-side convenience)."""
        m = mat.tocoo()
        data = m.data.astype(numpy_dtype(dtype)) if dtype else m.data
        return SparseCSR.from_coo(m.row, m.col, data, m.shape, dtype=dtype,
                                  device=resolve_device(device))

    @staticmethod
    def from_dense(a, dtype=None, device=None) -> "SparseCSR":
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        arr = np.asarray(a, dtype=numpy_dtype(dtype))
        r, c = np.nonzero(arr)
        return SparseCSR.from_coo(r, c, arr[r, c], arr.shape, dtype=dtype,
                                  device=resolve_device(device))

    # --- queries ---
    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    # --- compute ---
    def matvec(self, x):
        return csr_matvec(self.rows, self.indices, self.data, x, self.shape[0])

    def rmatvec(self, x):
        # A^H x: swap roles of rows/cols on the conjugated data.
        contrib = self.data.conj() * x.index_select(0, self.rows)
        out = torch.zeros(self.shape[1], dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices, contrib)

    def diagonal(self):
        k = min(self.shape)
        on_diag = (self.rows == self.indices) & (self.rows < k)
        out = torch.zeros(k, dtype=self.data.dtype, device=self.device)
        return out.index_add_(0, self.rows[on_diag], self.data[on_diag])

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.device)
        return out.index_put_((self.rows.long(), self.indices.long()), self.data,
                              accumulate=True)

    # --- conversions ---
    def to_ell(self, pad_to: int | None = None) -> "SparseELL":
        """Convert to padded ELL layout (host round-trip for packing)."""
        indptr = self.indptr.cpu().numpy().astype(np.int64)
        counts = np.diff(indptr)
        width = int(counts.max()) if counts.size else 0
        if pad_to is not None:
            width = max(width, pad_to)
        n_rows, _ = self.shape
        data = self.data.cpu().numpy()
        cols = self.indices.cpu().numpy()
        rows = self.rows.cpu().numpy().astype(np.int64)
        idx = np.zeros((n_rows, width), dtype=np.int32)
        val = np.zeros((n_rows, width), dtype=data.dtype)
        # vectorised packing: position of each nnz within its row
        slot = np.arange(len(rows)) - indptr[rows]
        idx[rows, slot] = cols
        val[rows, slot] = data
        return SparseELL(data=torch.from_numpy(val).to(self.device),
                         indices=torch.from_numpy(idx).to(self.device),
                         shape=self.shape)

    def to_gell(self, tile_rows: int | None = None):
        """Re-pack as ``SparseGELL`` (``matrix/gell.py``) on this matrix's
        device: the fast path for unstructured SpMV."""
        from .gell import SparseGELL
        return SparseGELL.from_csr(self, tile_rows=tile_rows)

    # --- checked access ---
    def as_csr(self):
        return self


@dataclasses.dataclass(frozen=True)
class SparseELL(AbstractMatrix):
    """Padded fixed-row-width sparse layout (see module docstring)."""

    data: torch.Tensor     # (n_rows, width)
    indices: torch.Tensor  # (n_rows, width) int32; padding entries point at col 0 with value 0
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        # padded layout: count structural (value-carrying) entries
        return int(torch.count_nonzero(self.data))

    def matvec(self, x):
        return ell_matvec(self.indices, self.data, x)

    def diagonal(self):
        n = min(self.shape)
        row_ids = torch.arange(self.data.shape[0], device=self.device)[:, None]
        on_diag = self.indices == row_ids
        d = torch.sum(torch.where(on_diag, self.data, 0), dim=1)
        return d[:n]

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.device)
        row_ids = torch.arange(self.shape[0], device=self.device)[:, None]
        row_ids = row_ids.expand(self.indices.shape)
        return out.index_put_((row_ids, self.indices.long()), self.data,
                              accumulate=True)

    def as_csr(self):
        raise TypeError("SparseELL: stored matrix is not sparse CSR (convert explicitly)")
