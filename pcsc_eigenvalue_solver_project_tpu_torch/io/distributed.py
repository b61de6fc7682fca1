"""Distributed matrix loading: row blocks (the port of the JAX package's
``io/distributed.py``).

The reference reads whole matrices into one process
(file_matrix_reader.hpp:170-200). At the distributed scale each rank needs
only its own row block:

- ``read_sparse_row_block``: parse a sparse file keeping only the COO
  entries with ``row_start <= row < row_end`` (column indices stay global,
  as the halo and all-gather SpMVs expect), with the reader's grammar and
  error words;
- ``load_partitioned``: a ``PartitionedELL`` of this rank's rows from a
  sparse file. Every rank calls it with the same arguments.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import is_complex_dtype, numpy_dtype
from .reader import _Tokens


def read_sparse_row_block(filename, dtype, row_start: int, row_end: int):
    """COO triplets (rows, cols, values) of one row block, as numpy arrays,
    and the matrix shape; rows stay global."""
    np_dtype = numpy_dtype(dtype)
    cx = is_complex_dtype(dtype)
    with open(filename, "r", encoding="utf-8") as f:
        toks = _Tokens(f.read())
    storage = toks.next()
    if storage != "sparse":
        raise ValueError(f"read_sparse_row_block: expected a sparse file, got {storage!r}")
    rows = toks.next_int()
    cols = toks.next_int()
    if rows is None or cols is None or rows <= 0 or cols <= 0:
        raise ValueError("Matrix dimensions must be positive")
    nnz = toks.next_int()
    if nnz is None or nnz <= 0:
        raise ValueError("number of non-zero entries must be positive in a sparse matrix")
    rr, cc, vv = [], [], []
    for _ in range(nnz):
        r = toks.next_int()
        c = toks.next_int()
        if r is None or c is None:
            raise ValueError("Error when trying to read indices in sparse matrix")
        if r < 0 or r >= rows or c < 0 or c >= cols:
            raise ValueError("Sparse indices out of range")
        if cx:
            re, im = toks.next_float(), toks.next_float()
            if re is None or im is None:
                raise ValueError("Failed to read scalar entry in sparse matrix")
            v = complex(re, im)
        else:
            v = toks.next_float()
            if v is None:
                raise ValueError("Failed to read scalar entry in sparse matrix")
        if row_start <= r < row_end:
            rr.append(r)
            cc.append(c)
            vv.append(v)
    return (np.asarray(rr, np.int64), np.asarray(cc, np.int64), np.asarray(vv, np_dtype),
            (rows, cols))


def load_partitioned(filename, mesh, dtype, *, axis: str = "rows"):
    """This rank's ``PartitionedELL`` of a sparse matrix file over ``mesh``.

    Every rank reads the file (the halo rule looks at every row) and keeps
    its own rows on its device."""
    from ..matrix.sparse import SparseCSR
    from ..parallel.sharded import partition_ell
    from .reader import read_matrix_from_file

    m = read_matrix_from_file(filename, dtype, device="cpu")
    if not isinstance(m, SparseCSR):
        raise ValueError("load_partitioned: expected a sparse matrix file")
    return partition_ell(m, mesh, axis=axis)
