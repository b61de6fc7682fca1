"""Hessenberg reduction via Householder similarity transforms.

Reference parity (reference src/qr_method/to_hessenberg.hpp:23-119): per
column k, build a reflector from the subcolumn below the diagonal with the
phase-correct sign ``x0/|x0|`` for complex scalars (:51-57), skip when the
column is already zero below the subdiagonal (:46-48) or the reflector
degenerates (:62-64), and apply the left (:69-71) and right (:74-76) rank-1
similarity updates. Dense only — the wrapper raises for sparse matrices
exactly like the reference (:104-106).

``hessenberg_dense`` is the JAX package's XLA column loop, here a torch loop
with the same masks; ``qr_eigenvalues`` runs it on CPU tensors.
``to_hessenberg`` goes through the dispatcher ``hessenberg_reduce``
(``ops/qr_kernels.py``): the blocked kernel B11 at
``n >= HESSENBERG_BLOCKED_MIN_N``, the unblocked B7 below it, on CUDA
tensors; their plain versions, with the same boundary, on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type
from ..matrix.protocol import AbstractMatrix
from ..utils.timing import spanned


# The n from which a Hessenberg reduction runs the blocked B11 rather than
# the unblocked B7. chip_smoke.py's sweep on an H100 (700 W), with B7 as one
# cluster kernel, had B11 ahead from n = 1024 on in float32 and complex64
# alike (15.1 against 20.7 ms and 17.5 against 29.6 ms there; B7's H leaves
# shared memory beyond 912 rows in float32, 628 in complex64) and behind up
# to 768 (2.72 against 8.22 ms and 3.99 against 9.31 ms at 512, 6.14
# against 14.18 ms and 15.67 against 16.09 ms at 768; PERF.md).
HESSENBERG_BLOCKED_MIN_N = 1024


def vector_norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of a vector: ``sqrt(sum(re(x * conj(x))))``."""
    return torch.sqrt((x * x.conj()).real.sum())


def hessenberg_dense(a: torch.Tensor) -> torch.Tensor:
    """Reduce a square dense matrix to upper Hessenberg form (similar to A)."""
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("hessenberg_dense: A must be square")
    idx = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    H = a
    # k ranges over 0..n-3 (to_hessenberg.hpp:38); empty range for n <= 2.
    for k in range(max(n - 2, 0)):
        col = H[:, k]
        x = torch.where(idx >= k + 1, col, zero)  # H[k+1:, k] in a full-length vector
        norm_x = vector_norm(x)
        tail_zero = vector_norm(torch.where(idx >= k + 2, col, zero)) == 0
        e_next = (idx == k + 1).to(a.dtype)
        x0 = col[k + 1]
        sign = torch.where(x0 != 0, x0 / torch.abs(x0).to(a.dtype), 1)
        v = x - (-sign * norm_x) * e_next
        vnorm = vector_norm(v)
        degenerate = vnorm == 0
        v = v / torch.where(degenerate, 1, vnorm).to(a.dtype)
        # Left: H(k+1:, k:) -= 2 v (v^H H); the column mask restricts to
        # cols >= k (to_hessenberg.hpp:69-71).
        w = torch.where(idx >= k, v.conj() @ H, zero)
        H1 = H - 2.0 * torch.outer(v, w)
        # Right: H(:, k+1:) -= 2 (H v) v^H; v's sparsity restricts the cols.
        H2 = H1 - 2.0 * torch.outer(H1 @ v, v.conj())
        H = torch.where(tail_zero | degenerate, H, H2)
    return H.clone() if H is a else H


def hessenberg_host(a) -> np.ndarray:
    """Host (NumPy) Householder Hessenberg reduction — the same algorithm as
    ``hessenberg_dense`` (to_hessenberg.hpp:23-80 semantics), kept as the
    tests' oracle."""
    H = np.array(a)
    n = H.shape[0]
    for k in range(n - 2):
        x = H[k + 1:, k].copy()
        if np.linalg.norm(x[1:]) == 0:
            continue
        norm_x = np.linalg.norm(x)
        x0 = x[0]
        sign = x0 / abs(x0) if x0 != 0 else 1.0
        alpha = -sign * norm_x
        v = x
        v[0] -= alpha
        vn = np.linalg.norm(v)
        if vn == 0:
            continue
        v = v / vn
        H[k + 1:, k:] -= 2.0 * np.outer(v, np.conj(v) @ H[k + 1:, k:])
        H[:, k + 1:] -= 2.0 * np.outer(H[:, k + 1:] @ v, np.conj(v))
    return H


@spanned
def to_hessenberg(M: AbstractMatrix, *, dtype=None) -> torch.Tensor:
    """Wrapper with the reference's dense-only and scalar-type guards. The
    result lies where the matrix lies."""
    from ..ops.qr_kernels import hessenberg_reduce
    if not M.is_dense:
        raise ValueError("to_hessenberg: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "to_hessenberg")
    if M.shape[0] != M.shape[1]:
        raise ValueError("to_hessenberg_dense: A must be square")
    return hessenberg_reduce(M.as_dense())
