"""Block (subspace) iteration: top-k eigenvalues with the block SpMM.

The port of the JAX package's ``solvers/subspace.py``. Single-vector power
iteration on a bandwidth-bound SpMV leaves the card waiting on device
memory; iterating a block of b vectors reads the operator once per chunk of
up to 8 vectors (the block kernel B5, ``ops/dia_spmv.py``). Each sweep
orthonormalises with CholeskyQR2: two passes of Gram, Cholesky and
triangular solve, left to ``torch.matmul``, ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular`` as the JAX package leaves them to XLA, in
full float32 (TF32 stays off). ``cholesky_ex`` raises nothing, as XLA's
Cholesky does not, and so needs no host read of its status on the card. The
triangular solve against the n-wide block is taken as the b x b inverse of
the factor (``solve_triangular`` on the identity) times the block, a matmul:
``solve_triangular`` with n right-hand sides is slow on the card at n = 1M
(``chip_smoke.py`` phase 16 times both there). Convergence is checked on the host between
chunks of sweeps, on the Ritz values of the projected b x b block, with
numpy as in the JAX package.

Start blocks come from an explicit ``torch.Generator`` on the operand's
device (seeded with ``utils.prng.DEFAULT_SEED`` unless given); ``X0``
overrides it, and is how the tests hand both packages the same block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..core.tolerance import is_close_relative
from ..matrix.dia import InterleavedDIA, SparseDIA
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..ops.dia_spmv import dia_matmat_cols
from ..utils.prng import default_generator
from ..utils.timing import spanned


def _apply_block(M: AbstractMatrix, X: torch.Tensor) -> torch.Tensor:
    """A @ X for X (n, b): the block kernel for DIA (on the (n, b) block as
    it lies, read and written by strides), a matmul for dense, a matvec per
    column otherwise."""
    if isinstance(M, SparseDIA):
        return dia_matmat_cols(M.data, M.offsets, X.contiguous())
    if M.is_dense:
        return M.as_dense() @ X
    return torch.stack([M.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)


def _shifted_gram(G: torch.Tensor, single: bool) -> torch.Tensor:
    eps = 1e-7 if single else 1e-14
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return G + eps * torch.trace(G).real.to(G.dtype) * eye


def _single(dtype: torch.dtype) -> bool:
    return dtype in (torch.float32, torch.complex64)


def _conj_factor_inverse(G: torch.Tensor) -> torch.Tensor:
    """conj(L)^{-1} for the Cholesky factor L of the shifted Gram matrix G."""
    L, _ = torch.linalg.cholesky_ex(_shifted_gram(G, _single(G.dtype)))
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return torch.linalg.solve_triangular(L.conj(), eye, upper=False)


def _cholqr2(X: torch.Tensor) -> torch.Tensor:
    """Orthonormalise the columns of X (n, b) by two rounds of Cholesky QR:
    X <- X L^{-H}, i.e. (conj(L)^{-1} X^T)^T."""
    def one(Xc):
        return Xc @ _conj_factor_inverse(Xc.conj().T @ Xc).T

    return one(one(X))


def _subspace_chunk(M: AbstractMatrix, X: torch.Tensor, sweeps: int):
    for _ in range(sweeps):
        X = _cholqr2(_apply_block(M, X))
    B = X.conj().T @ _apply_block(M, X)  # projected block (b, b)
    return X, B


# --- row-domain variant (InterleavedDIA) ------------------------------------
# Block vectors live as Xf (b, N): each row is one flattened interleaved
# domain vector. Gram matrices and triangular combinations are permutation-
# invariant over N, so the CholeskyQR2 algebra transposes cleanly:
# Q = X L^{-H}  (columns)  <=>  Qf = conj(L)^{-1} Xf  (rows).


def _apply_block_rows(M: InterleavedDIA, Xf: torch.Tensor) -> torch.Tensor:
    b = Xf.shape[0]
    return M.matmat(Xf.reshape(b, M.R, -1)).reshape(b, -1)


def _cholqr2_rows(Xf: torch.Tensor) -> torch.Tensor:
    def one(Xc):
        return _conj_factor_inverse(Xc.conj() @ Xc.T) @ Xc

    return one(one(Xf))


def _subspace_chunk_rows(M: InterleavedDIA, Xf: torch.Tensor, sweeps: int):
    for _ in range(sweeps):
        Xf = _cholqr2_rows(_apply_block_rows(M, Xf))
    B = Xf.conj() @ _apply_block_rows(M, Xf).T
    return Xf, B


# --------------------------------------------------------------------------
# Chebyshev-filtered subspace iteration. A degree-m Chebyshev polynomial
# mapped onto the unwanted spectral interval [a, b] damps it by
# ~1/cosh(m*acosh(gamma)) while amplifying everything above b; each sweep
# costs m block SpMMs. Symmetric operators, largest-algebraic end.
# --------------------------------------------------------------------------


def _cheb_apply_block(apply, X, deg: int, c, e):
    """p(A) X by the three-term recurrence on the interval (c-e, c+e); both
    carries are rescaled together every step by 1/max(1, max|Yn|) (the
    recurrence is linear, so joint scaling is exact), which keeps float32
    from overflowing at high amplification."""
    Y1 = (apply(X) - c * X) / e
    if deg <= 1:
        return Y1
    Ym1, Y = X, Y1
    for _ in range(deg - 1):
        Yn = 2.0 * (apply(Y) - c * Y) / e - Ym1
        s = 1.0 / torch.clamp(torch.max(torch.abs(Yn)), min=1.0)
        Ym1, Y = Y * s, Yn * s
    return Y


def _subspace_chunk_cheb(M: AbstractMatrix, X: torch.Tensor, sweeps: int, deg: int, a, b):
    c, e = (a + b) * 0.5, (b - a) * 0.5
    for _ in range(sweeps):
        X = _cholqr2(_cheb_apply_block(lambda Z: _apply_block(M, Z), X, deg, c, e))
    B = X.conj().T @ _apply_block(M, X)  # Rayleigh-Ritz on A itself
    return X, B


def _subspace_chunk_cheb_rows(M: InterleavedDIA, Xf: torch.Tensor, sweeps: int, deg: int,
                              a, b):
    c, e = (a + b) * 0.5, (b - a) * 0.5
    for _ in range(sweeps):
        Xf = _cholqr2_rows(_cheb_apply_block(lambda Z: _apply_block_rows(M, Z), Xf, deg, c, e))
    B = Xf.conj() @ _apply_block_rows(M, Xf).T
    return Xf, B


def _start_block(M, n: int, b: int, vec_dt, generator, X0, rows_mode: bool):
    """The orthonormalised start block: X0 (n, b) when given, else uniform
    [-1, 1] from ``generator`` (real entries, also for complex operators, as
    the JAX package draws them); rows of the interleaved domain in rows mode."""
    if X0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        real = torch.float64 if vec_dt.is_complex else vec_dt
        X = torch.rand((n, b), generator=gen, dtype=real, device=gen.device) * 2 - 1
        X = X.to(device=M.device, dtype=vec_dt)
    else:
        X = torch.as_tensor(X0).to(device=M.device, dtype=vec_dt)
    if rows_mode:
        X = torch.stack([M.encode_vec(X[:, j]) for j in range(b)]).reshape(b, -1)
        return _cholqr2_rows(X)
    return _cholqr2(X)


def _host(B: torch.Tensor) -> np.ndarray:
    return B.detach().cpu().numpy()


def _result(ritz, total: int, converged: bool, device) -> QRResult:
    return QRResult(eigenvalues=torch.as_tensor(np.ascontiguousarray(ritz), device=device),
                    iterations=torch.tensor(total, dtype=torch.int32, device=device),
                    converged=torch.tensor(converged, device=device))


@spanned
def chebyshev_subspace_iteration(M: AbstractMatrix, k: int = 4, *,
                                 block: int | None = None, degree: int = 10,
                                 opts: SolverOptions = SolverOptions(),
                                 sweeps_per_check: int = 2,
                                 interval: tuple | None = None,
                                 dtype=None, generator: torch.Generator | None = None,
                                 X0=None) -> QRResult:
    """Top-``k`` algebraic eigenvalues of a symmetric operator by
    Chebyshev-filtered block iteration.

    Each sweep applies a degree-``degree`` Chebyshev filter over the
    unwanted interval ``[lo, edge]`` (``lo`` from the operator's Gershgorin
    enclosure, ``edge`` re-estimated every check from the block's weakest
    Ritz value), so ``opts.max_iterations`` counts sweeps and each sweep
    costs ``degree`` block SpMMs.
    """
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "chebyshev_subspace_iteration")
    require_square(M, "chebyshev_subspace_iteration")
    require_nonempty(M, "chebyshev_subspace_iteration")
    n = M.shape[0]
    if k < 1:
        raise ValueError("chebyshev_subspace_iteration: k must be >= 1")
    if degree < 1:
        raise ValueError("chebyshev_subspace_iteration: degree must be >= 1")
    b_sz = block if block is not None else min(max(k + 4, 8), n)
    if b_sz < k:
        raise ValueError(
            f"chebyshev_subspace_iteration: block ({b_sz}) must be >= k ({k})")
    b_sz = min(b_sz, n)

    rows_mode = isinstance(M, InterleavedDIA)
    vec_dt = torch.promote_types(M.dtype, torch.float32)
    if vec_dt.is_complex:
        raise ValueError("chebyshev_subspace_iteration: symmetric real "
                         "operators only (Hermitian complex: use lanczos)")
    X = _start_block(M, n, b_sz, vec_dt, generator, X0, rows_mode)

    # spectrum enclosure for the filter's lower edge
    if interval is not None:
        lo, hi = float(interval[0]), float(interval[1])
        if not lo < hi:
            raise ValueError(
                f"chebyshev_subspace_iteration: interval must satisfy "
                f"lo < hi, got ({lo}, {hi})")
    elif hasattr(M, "gershgorin_interval"):
        g = M.gershgorin_interval()
        lo, hi = float(g[0]), float(g[1])
    else:
        rho = float(torch.max(torch.abs(M.to_dense()))) * n  # crude fallback
        lo, hi = -rho, rho
    span = hi - lo

    # bootstrap: one unfiltered chunk to seed the edge estimate
    X, B = (_subspace_chunk_rows(M, X, sweeps_per_check) if rows_mode
            else _subspace_chunk(M, X, sweeps_per_check))
    w_all = np.sort(np.linalg.eigvalsh(_host(B)))
    total = sweeps_per_check
    prev = None
    converged = False
    ritz = w_all[::-1][:k]
    while total < opts.max_iterations:
        # damp everything below the block's weakest Ritz value (clamped
        # inside the enclosure so the filter interval never degenerates)
        edge = float(np.clip(w_all[0], lo + 1e-3 * span, hi - 1e-3 * span))
        a_t = torch.tensor(lo, dtype=vec_dt, device=M.device)
        b_t = torch.tensor(edge, dtype=vec_dt, device=M.device)
        X, B = (_subspace_chunk_cheb_rows(M, X, sweeps_per_check, degree, a_t, b_t)
                if rows_mode
                else _subspace_chunk_cheb(M, X, sweeps_per_check, degree, a_t, b_t))
        total += sweeps_per_check
        w_all = np.sort(np.linalg.eigvalsh(_host(B)))
        w = w_all[::-1][:k]
        if prev is not None:
            close = all(bool(is_close_relative(w[i], prev[i], opts.tolerance))
                        for i in range(k))
            if close:
                ritz = w
                converged = True
                break
        prev = w
        ritz = w
    return _result(ritz, total, converged, M.device)


@spanned
def subspace_iteration(M: AbstractMatrix, k: int = 4, *, block: int | None = None,
                       opts: SolverOptions = SolverOptions(), dtype=None,
                       sweeps_per_check: int = 10,
                       generator: torch.Generator | None = None,
                       X0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) by block iteration.

    ``block`` defaults to ``max(k + 4, 8)`` (at most n). Convergence: the
    top-k Ritz values of the projected block satisfy the reference relative
    criterion between consecutive checks.
    """
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "subspace_iteration")
    require_square(M, "subspace_iteration")
    require_nonempty(M, "subspace_iteration")
    n = M.shape[0]
    if k < 1:
        raise ValueError("subspace_iteration: k must be >= 1")
    b = block if block is not None else min(max(k + 4, 8), n)
    if b < k:
        raise ValueError(f"subspace_iteration: block ({b}) must be >= k ({k})")
    b = min(b, n)

    rows_mode = isinstance(M, InterleavedDIA)
    vec_dt = torch.promote_types(M.dtype, torch.float32)
    X = _start_block(M, n, b, vec_dt, generator, X0, rows_mode)

    prev = None
    total = 0
    converged = False
    ritz = np.zeros(k, np.complex128)
    max_checks = -(-opts.max_iterations // sweeps_per_check)
    for _ in range(max_checks):
        X, B = (_subspace_chunk_rows(M, X, sweeps_per_check) if rows_mode
                else _subspace_chunk(M, X, sweeps_per_check))
        total += sweeps_per_check
        w = np.linalg.eigvals(_host(B))
        w = w[np.argsort(-np.abs(w))][:k]
        if prev is not None:
            close = all(bool(is_close_relative(w[i], prev[i], opts.tolerance))
                        for i in range(k))
            if close:
                ritz = w
                converged = True
                break
        prev = w
        ritz = w
    return _result(ritz, total, converged, M.device)
