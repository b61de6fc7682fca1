"""Text matrix writer — emits the reference file format.

The port of the JAX package's ``io/writer.py``: the same ``%.17g`` text,
byte for byte, through the native writer (``io/native.py``) when the
library has it, else through the Python formatter below. Output is
readable by both packages' readers and by the reference's
``readMatrixFromFile``. This is host file I/O: a matrix on the card is
copied to the host once per call (each of its tensors once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..matrix.dense import DenseMatrix
from ..matrix.sparse import SparseCSR


def _fmt(v, complex_entries: bool) -> str:
    if complex_entries:
        return f"{v.real:.17g} {v.imag:.17g}"
    return f"{v:.17g}"


def _host(t: torch.Tensor) -> np.ndarray:
    """One copy to the host; bfloat16, which numpy lacks, as its exact
    float32 values."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def write_matrix_to_file(filename, matrix) -> None:
    if isinstance(matrix, DenseMatrix):
        _write_dense(filename, matrix)
    elif isinstance(matrix, SparseCSR):
        _write_sparse(filename, matrix)
    else:
        raise TypeError(f"write_matrix_to_file: unsupported matrix type {type(matrix).__name__}")


def _write_dense(filename, m: DenseMatrix) -> None:
    a = _host(m.array)
    cx = np.iscomplexobj(a)
    try:
        from . import native
        if native.writer_available():
            native.write_dense(filename, a)
            return
    except ImportError:
        pass
    with open(filename, "w", encoding="utf-8") as f:
        f.write("dense\n")
        f.write(f"{a.shape[0]} {a.shape[1]}\n")
        for r in range(a.shape[0]):
            f.write(" ".join(_fmt(a[r, c], cx) for c in range(a.shape[1])) + "\n")


def _write_sparse(filename, m: SparseCSR) -> None:
    rows = _host(m.rows)
    cols = _host(m.indices)
    data = _host(m.data)
    cx = np.iscomplexobj(data)
    try:
        from . import native
        if native.writer_available():
            native.write_sparse(filename, m.shape, rows, cols, data)
            return
    except ImportError:
        pass
    with open(filename, "w", encoding="utf-8") as f:
        f.write("sparse\n")
        f.write(f"{m.shape[0]} {m.shape[1]}\n")
        f.write(f"{len(data)}\n")
        # vectorised row formatting (the 1M-row bench files)
        if cx:
            stacked = np.column_stack([rows, cols, data.real, data.imag])
            np.savetxt(f, stacked, fmt=["%d", "%d", "%.17g", "%.17g"])
        else:
            stacked = np.column_stack([rows, cols, data])
            np.savetxt(f, stacked, fmt=["%d", "%d", "%.17g"])
