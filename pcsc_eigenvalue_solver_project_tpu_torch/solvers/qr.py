"""Householder QR decomposition.

Reference parity (reference src/qr_method/qr_decompose.hpp:25-132):
``A = Q R`` for any m x n dense matrix via Householder reflectors with the
complex phase-correct sign, skip rules for already-eliminated columns, and
accumulation of the full m x m unitary Q. Empty input raises (:38-40); the
wrapper is dense-only (:110-112) and returns ``(Q, R)``.

``qr_decompose`` sends a square matrix through the B9 dispatcher
``householder_qr`` (``ops/qr_kernels.py``): kernel B9 on a CUDA tensor, its
plain version on the CPU. Rectangular matrices take the torch column loop
``qr_decompose_dense``, as the JAX package keeps them on XLA.
"""

from __future__ import annotations

import torch

from ..core.dtypes import check_scalar_type
from ..matrix.protocol import AbstractMatrix
from ..utils.timing import spanned
from .hessenberg import vector_norm


def qr_decompose_dense(a: torch.Tensor):
    """Householder QR of an m x n dense matrix; returns (Q, R)."""
    m, n = a.shape
    if m == 0 or n == 0:
        raise ValueError("qr_decompose_dense: empty matrix")
    row_idx = torch.arange(m, device=a.device)
    col_idx = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    Q = torch.eye(m, dtype=a.dtype, device=a.device)
    R = a.clone()
    for k in range(min(m, n)):
        col = R[:, k]
        x = torch.where(row_idx >= k, col, zero)
        norm_x = vector_norm(x)
        tail_zero = vector_norm(torch.where(row_idx >= k + 1, col, zero)) == 0
        x0 = col[k]
        sign = torch.where(x0 != 0, x0 / torch.abs(x0).to(a.dtype), 1)
        v = x - (-sign * norm_x) * (row_idx == k).to(a.dtype)
        vnorm = vector_norm(v)
        degenerate = vnorm == 0
        v = v / torch.where(degenerate, 1, vnorm).to(a.dtype)
        # R(k:, k:) -= 2 v (v^H R)  (qr_decompose.hpp:77-79)
        w = torch.where(col_idx >= k, v.conj() @ R, zero)
        R1 = R - 2.0 * torch.outer(v, w)
        # Q(:, k:) -= 2 (Q v) v^H  (qr_decompose.hpp:82-84)
        Q1 = Q - 2.0 * torch.outer(Q @ v, v.conj())
        skip = tail_zero | degenerate
        Q, R = torch.where(skip, Q, Q1), torch.where(skip, R, R1)
    return Q, R


@spanned
def qr_decompose(M: AbstractMatrix, *, dtype=None):
    """Wrapper with the reference's dense-only and scalar-type guards;
    returns ``(Q, R)`` where the matrix lies."""
    from ..ops.qr_kernels import householder_qr
    if not M.is_dense:
        raise ValueError("qr_decompose: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "qr_decompose")
    a = M.as_dense()
    m, n = a.shape
    if m == n and m > 0:
        R, Q = householder_qr(a)
        return Q, R
    return qr_decompose_dense(a)
