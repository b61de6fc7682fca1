"""LOBPCG — block top-k eigensolver for symmetric operators.

The port of the JAX package's ``solvers/lobpcg.py``. Locally Optimal Block
Preconditioned Conjugate Gradient iterates k vectors together, so each
step's operator work is block applies: on a banded operator the block SpMM
B5 reads the diagonals once per chunk of vectors
(``solvers/subspace.py::_apply_block`` for ``SparseDIA``,
``_apply_block_rows`` for ``InterleavedDIA``). The small dense algebra (the
Rayleigh-Ritz ``eigh`` of the 3k x 3k projection, the k x k Gram ``eigh``
calls of SVQB, one thin QR) runs on the operand's device through
``torch.linalg`` (cuSOLVER on the card), as XLA's ``eigh`` and ``qr`` run
it in JAX.

The JAX package calls ``jax.experimental.sparse.linalg.lobpcg_standard``;
its numerics are copied here as private functions, from
``jax/experimental/sparse/linalg.py`` (``_lobpcg_standard_callable``,
``_svqb``, ``_project_out``, ``_orthonormalize``, ``_rayleigh_ritz_orth``,
``_extend_basis``), Copyright 2022 The JAX Authors, licensed under the
Apache License, Version 2.0 (https://www.apache.org/licenses/LICENSE-2.0).
Changes: torch in place of jax.numpy; the ``while_loop`` runs as masked
blocks of iterations (``utils/loops.py``), so the host reads the
convergence count once a block; ``eigh`` symmetrises its input, as
``jnp.linalg.eigh`` does by default; the block reflector of
``_extend_basis`` takes ``w[k:k+m]^T`` for ``w[k:]^T [I; 0]`` (the same
numbers); no debug diagnostics.

``which="SA"`` (smallest algebraic) maps to the largest of ``sigma I - A``
with ``sigma`` the operator's Gershgorin ``spectral_bound()`` where it has
one, else a 30-step power overestimate of the spectral radius.
"""

from __future__ import annotations

import torch

from ..core.dtypes import check_scalar_type
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..matrix.dia import InterleavedDIA
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..utils.loops import count, flag, run_masked
from ..utils.prng import default_generator
from ..utils.timing import spanned
from .subspace import _apply_block, _apply_block_rows


def _block_apply(M: AbstractMatrix):
    """Column-block apply X (n, b) -> A X through the operator's block
    kernel: B5 on the (n, b) block as it lies for ``SparseDIA``, B5 on the
    block's rows in the interleaved domain for ``InterleavedDIA``, a matmul
    for dense, a matvec per column otherwise."""
    if isinstance(M, InterleavedDIA):
        n, R = M.shape[0], M.R

        def apply(X):
            b = X.shape[1]
            rows = X.new_zeros((b, R * 128))
            rows[:, :n] = X.T
            rows = rows.reshape(b, 128, R).transpose(1, 2).reshape(b, -1)  # encode_vec, by rows
            Y = _apply_block_rows(M, rows).reshape(b, R, 128)
            return Y.transpose(1, 2).reshape(b, -1)[:, :n].T           # decode_vec, by rows
        return apply
    return lambda X: _apply_block(M, X)


def _spectral_radius_overestimate(apply, x0: torch.Tensor, iters: int):
    """||A||_2 overestimate: power iteration + a 1.05 safety factor."""
    x, lam = x0, torch.zeros((), dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        y = apply(x[:, None])[:, 0]
        nrm = torch.linalg.vector_norm(y)
        x, lam = y / torch.where(nrm == 0, 1.0, nrm), nrm
    return 1.05 * lam + 1e-3


# ---------------------------------------------------------------------------
# The upstream LOBPCG core (jax/experimental/sparse/linalg.py:37-516)
# ---------------------------------------------------------------------------

def _mm(a, b):
    return torch.matmul(a, b)


def _col_norms(X, keepdim=True):
    return torch.linalg.vector_norm(X, dim=0, keepdim=keepdim)


def _eigh_ascending(A):
    """Eigenpairs with the eigenvalues in descending order (the upstream
    name), of the symmetrised input."""
    w, V = torch.linalg.eigh((A + A.T) / 2)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """A truncated orthonormal basis for ``X`` (n, k) by SVQB: the columns
    whose Gram eigenvalue is at most ``eps * w[0]`` are zeroed, and the
    shapes stay fixed."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = _mm(X.T, X)
    w, V = _eigh_ascending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = _mm(X, V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _col_norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """The component of U in the orthogonal complement of the orthonormal
    (zero columns allowed) ``basis``: subtract and orthonormalise twice, end
    on two subtractions, and zero every column whose norm fell below 0.99,
    so that [basis, U] stays zero-or-orthogonal."""
    for _ in range(2):
        U = U - _mm(basis, _mm(basis.T, U))
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - _mm(basis, _mm(basis.T, U))
    return U * (_col_norms(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S):
    """The Rayleigh-Ritz eigenpairs of A on the orthonormal S (zero columns
    allowed), eigenvalues descending."""
    return _eigh_ascending(_mm(S.T, A(S)))


def _extend_basis(X, m: int):
    """``m`` columns that extend the orthonormal (n, k) ``X`` to an
    orthonormal (n, k + m) basis, by a block Householder reflector."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + _mm(u, vt), Xlower], dim=0)
    w = _mm(y, vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    # upstream: h = -2 w (w[k:]^T other) with other = [I_m; 0], (n - k, m)
    h = -2 * _mm(w, w[k:k + m].T)
    h[k:k + m] += torch.eye(m, dtype=X.dtype, device=X.device)
    return h


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {test_output.dtype}, {X.dtype})")
    if tuple(test_output.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output "
                         f"{tuple(test_output.shape)}")


def _lobpcg_standard(A, X: torch.Tensor, m: int, tol=None):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    (n, b) blocks) from the start block ``X`` (n, k): ``(theta (k,), U (n,
    k), iterations)``. An eigenpair converges when ``|A u - theta u| < tol
    * 10 n (theta + |A u|)`` (tol defaults to the dtype's eps); the loop
    stops after ``m`` iterations or when all k have converged."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    def body(carry):
        i, done, X, P, R, theta = carry
        Rn = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, Rn), dim=1)
        theta_n, Q = _rayleigh_ritz_orth(A, XPR)
        B = Q[:, :k]
        B = B / _col_norms(B)
        Xn = _mm(XPR, B)
        Xn = Xn / _col_norms(Xn)
        # difference terms: concat(0, Q[k:, :k]) orthogonalised against
        # Q[:, :k] in the standard basis, then mapped by XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        Pn = _mm(XPR, _mm(Q[:, k:], q))
        normP = _col_norms(Pn)
        Pn = Pn / torch.where(normP == 0, 1.0, normP)
        AXn = A(Xn)
        Rn = AXn - theta_n[None, :k] * Xn
        reltol = (_col_norms(AXn, keepdim=False) + theta_n[:k]) * n * 10
        converged = torch.sum(_col_norms(Rn, keepdim=False) < tol * reltol)
        live = ~done
        return (torch.where(live, i + 1, i), done | (converged >= k),
                torch.where(live, Xn, X), torch.where(live, Pn, P),
                torch.where(live, Rn, R), torch.where(live, theta_n[None, :k], theta))

    dev = X.device
    carry = (count(dev), flag(False, dev), X, P, R, theta)
    i, _, X, _, _, theta = run_masked(body, carry, m, span="eigsol.lobpcg.block")
    return theta[0, :], X, i


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

@spanned
def lobpcg_eigenvalues(M: AbstractMatrix, k: int = 4, *,
                       opts: SolverOptions = SolverOptions(), which: str = "LA",
                       dtype=None, generator: torch.Generator | None = None,
                       X0=None) -> QRResult:
    """Top-``k`` (``which="LA"``) or bottom-``k`` (``which="SA"``)
    eigenvalues of a real symmetric operator (JAX ``lobpcg_eigenvalues``).

    ``opts.max_iterations`` caps LOBPCG sweeps; ``converged`` applies the
    relative criterion ``||A x - theta x|| <= tol (1+|theta|)`` to every
    returned pair. Returns a ``QRResult`` with real eigenvalues sorted
    descending ("LA") / ascending ("SA").

    ``which="SA"``: the spectral-shift mapping gives absolute accuracy at the
    scale of ``sigma``, so eigenvalues much smaller than ``sigma`` keep only
    absolute precision; for tight smallest eigenvalues use
    ``lanczos_eigenvalues(which="SA")`` or ``shifted_inverse_power_method``."""
    if which not in ("LA", "SA"):
        raise ValueError(f"lobpcg_eigenvalues: unknown which={which!r}")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lobpcg_eigenvalues")
    require_square(M, "lobpcg_eigenvalues")
    require_nonempty(M, "lobpcg_eigenvalues")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lobpcg_eigenvalues: k must be >= 1")
    if 5 * k >= n:
        raise ValueError(
            f"lobpcg_eigenvalues: n ({n}) must exceed 5k ({5 * k}) — "
            "use the dense QR solver for small problems")
    vec_dt = torch.promote_types(M.dtype, torch.float32)
    if vec_dt.is_complex:
        raise ValueError("lobpcg_eigenvalues: complex operators are not "
                         "supported by the upstream routine; use "
                         "lanczos_eigenvalues")
    if X0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        X0 = torch.randn((n, k), generator=gen, dtype=vec_dt, device=gen.device).to(M.device)
    else:
        X0 = torch.as_tensor(X0).to(device=M.device, dtype=vec_dt)
        if tuple(X0.shape) != (n, k):
            raise ValueError(f"lobpcg_eigenvalues: X0 must be (n, k) = ({n}, {k})")

    apply = _block_apply(M)
    if which == "SA":
        if hasattr(M, "spectral_bound"):
            # deterministic Gershgorin bound (banded formats): one pass
            sigma = (1.0 + 1e-6) * M.spectral_bound().to(vec_dt)
        else:
            sigma = _spectral_radius_overestimate(apply, X0[:, 0], 30).to(vec_dt)

        def op(X):
            return sigma * X - apply(X)
    else:
        op = apply

    # upstream at machine tolerance within the user's sweep budget, then
    # this framework's convergence contract as a post-check on the
    # per-pair residuals (tolerance.hpp:29-33's shape)
    theta, U, iters = _lobpcg_standard(op, X0, int(opts.max_iterations))
    resid = torch.linalg.vector_norm(op(U) - U * theta[None, :], dim=0)
    converged = torch.all(resid <= opts.tolerance * (1.0 + theta.abs()))
    vals = (torch.sort(sigma - theta).values if which == "SA"
            else torch.sort(theta, descending=True).values)
    return QRResult(eigenvalues=vals, iterations=iters, converged=converged)

