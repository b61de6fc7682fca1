"""Matrix-vector products of the dense and general-sparse kinds.

The reference's ``A * x`` inside power iteration (power_method.hpp:69) is a
sequential Eigen dense-GEMV / CSC-SpMV. The JAX package leaves these three
to XLA, so the port leaves them to PyTorch's own operators:

- dense matvec is ``torch.matmul`` (full float32: TF32 stays off);
- CSR SpMV is a gather plus ``index_add_`` over the expanded row ids;
- ELL SpMV is a gather plus a row sum.

The banded kinds have kernels of their own (ops/dia_spmv.py).
"""

from __future__ import annotations

import torch


def dense_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x``."""
    return torch.matmul(a, x)


def dense_rmatvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a^H @ x``."""
    return torch.matmul(a.conj().T, x)


def csr_matvec(rows: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
               x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CSR/COO SpMV via gather + index-add.

    ``rows``/``indices``/``data`` are the nnz-length expanded-row-id, column
    index, and value arrays (row-sorted).
    """
    contrib = data * x.index_select(0, indices)
    out = torch.zeros(n_rows, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, rows, contrib)


def ell_matvec(ell_indices: torch.Tensor, ell_data: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMV: per-row padded gather then row reduction.

    ``ell_indices``/``ell_data`` have shape (n_rows, max_row_nnz); padding
    entries carry value 0 (their column index is arbitrary but in range).
    """
    gathered = x.index_select(0, ell_indices.reshape(-1)).reshape(ell_indices.shape)
    return torch.sum(ell_data * gathered, dim=1)
