"""Text matrix reader.

Implements the exact grammar of the reference reader
(reference src/reader/file_matrix_reader.hpp:170-200):

    <"dense"|"sparse">  <rows> <cols>
    dense:  rows*cols scalars, row-major; complex entries are "re im" pairs
            (file_matrix_reader.hpp:33-66)
    sparse: <nnz>, then nnz lines of "row col value" (or "row col re im"),
            bounds-checked COO triplets (file_matrix_reader.hpp:84-132)

Every reference error case maps to a Python exception with an equivalent
message: unknown storage keyword, unreadable/missing dims, non-positive
dims, non-positive nnz, out-of-range indices, malformed scalar entries.
The scalar type is a ``dtype`` argument (the ``Scalar`` template parameter
analogue); a real dtype reads one token per entry, a complex dtype reads
two. Parsing happens on the host (NumPy); the result is a ``DenseMatrix``
or ``SparseCSR`` on ``device``
(default: the card).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.device import resolve_device
from ..core.dtypes import canonical_dtype, is_complex_dtype, numpy_dtype
from ..matrix.dense import DenseMatrix
from ..matrix.sparse import SparseCSR


class _Tokens:
    """Whitespace token stream mirroring istream ``>>`` extraction."""

    __slots__ = ("_toks", "_i")

    def __init__(self, text: str):
        self._toks = text.split()
        self._i = 0

    def next(self) -> str | None:
        if self._i >= len(self._toks):
            return None
        t = self._toks[self._i]
        self._i += 1
        return t

    def next_int(self) -> int | None:
        t = self.next()
        if t is None:
            return None
        try:
            return int(t)
        except ValueError:
            return None

    def next_float(self) -> float | None:
        t = self.next()
        if t is None:
            return None
        try:
            return float(t)
        except ValueError:
            return None


def _read_scalar(toks: _Tokens, complex_entries: bool):
    if complex_entries:
        re = toks.next_float()
        im = toks.next_float()
        if re is None or im is None:
            return None
        return complex(re, im)
    return toks.next_float()


def read_dense_entries(toks: _Tokens, rows: int, cols: int, dtype, device=None):
    """Parity with readInsideDenseMatrix (file_matrix_reader.hpp:33-66)."""
    if rows < 0 or cols < 0:
        raise ValueError("Negative matrix dimensions")
    complex_entries = is_complex_dtype(dtype)
    out = np.empty((rows, cols), dtype=numpy_dtype(dtype))
    for r in range(rows):
        for c in range(cols):
            v = _read_scalar(toks, complex_entries)
            if v is None:
                kind = "complex" if complex_entries else "scalar"
                raise ValueError(f"Failed to read {kind} entry in dense matrix")
            out[r, c] = v
    return DenseMatrix.from_array(out, dtype=dtype, device=device)


def read_sparse_entries(toks: _Tokens, rows: int, cols: int, dtype, device=None):
    """Parity with readInsideSparseMatrix (file_matrix_reader.hpp:84-132)."""
    if rows < 0 or cols < 0:
        raise ValueError("Negative matrix dimensions")
    nnz = toks.next_int()
    if nnz is None:
        raise ValueError("Cannot read number of non-zero entries in the sparse matrix")
    if nnz <= 0:
        raise ValueError("number of non-zero entries must be positive in a sparse matrix")
    complex_entries = is_complex_dtype(dtype)
    rr = np.empty(nnz, dtype=np.int64)
    cc = np.empty(nnz, dtype=np.int64)
    vv = np.empty(nnz, dtype=numpy_dtype(dtype))
    for k in range(nnz):
        r = toks.next_int()
        c = toks.next_int()
        if r is None or c is None:
            raise ValueError("Error when trying to read indices in sparse matrix")
        if r < 0 or r >= rows or c < 0 or c >= cols:
            raise ValueError("Sparse indices out of range")
        v = _read_scalar(toks, complex_entries)
        if v is None:
            raise ValueError("Failed to read scalar entry in sparse matrix")
        rr[k], cc[k], vv[k] = r, c, v
    # Eigen insert() rejects duplicates -> sum_duplicates=False raises here too.
    return SparseCSR.from_coo(rr, cc, vv, (rows, cols), dtype=dtype,
                              sum_duplicates=False, device=device)


STORAGE_KEYWORDS = ("dense", "sparse")


def read_matrix_from_text(text: str, dtype, device=None):
    """Parse the full format from an in-memory string."""
    dtype = canonical_dtype(dtype)
    device = resolve_device(device)
    toks = _Tokens(text)
    storage = toks.next()
    if storage is None:
        raise ValueError("Failed to read matrix storage type")
    if storage not in STORAGE_KEYWORDS:
        raise ValueError(f"Unknown storage type: {storage}")
    rows = toks.next_int()
    cols = toks.next_int()
    if rows is None or cols is None:
        raise ValueError("Failed to read matrix dimensions")
    if rows <= 0 or cols <= 0:
        raise ValueError("Matrix dimensions must be positive")
    if storage == "dense":
        return read_dense_entries(toks, rows, cols, dtype, device)
    return read_sparse_entries(toks, rows, cols, dtype, device)


def read_matrix_from_file(filename, dtype, *, use_native: bool = True,
                          device=None):
    """Parity with readMatrixFromFile (file_matrix_reader.hpp:170-200).

    ``use_native`` routes parsing through the C++ fast tokenizer when it
    builds (io/native.py); the grammar and errors are identical.
    """
    device = resolve_device(device)
    if not os.path.exists(filename):
        raise FileNotFoundError(f"Impossible to open the file: {filename}")
    if use_native:
        from . import native
        if native.available():
            return native.read_matrix_from_file(filename, dtype, device=device)
    with open(filename, "r", encoding="utf-8") as f:
        return read_matrix_from_text(f.read(), dtype, device=device)
