"""Lanczos iteration — top-k eigenvalues of symmetric/Hermitian operators.

The port of the JAX package's ``solvers/lanczos.py``: the symmetric
specialisation of Arnoldi (``solvers/arnoldi.py``). The projected matrix
is tridiagonal, so the small solve is an ``eigh`` of a real tridiagonal on
the host (numpy, as in the JAX package), with the Ritz-residual bounds
``|beta_m * s_{m,i}|`` for free.

The basis build runs eagerly on the operand's device: one matvec a step on
the operator's kernel (B1/B2 banded, B6 general sparse), the three-term
recurrence, and the full reorthogonalisation pass as two products with the
(m + 1, n) basis seen as a matrix (``torch.matmul``, which XLA's
``tensordot`` plays in JAX), so that the interleaved (R, 128) vector domain
of ``InterleavedDIA`` works as it does there. Every update after a
breakdown is masked on the device (``torch.where``); the host reads the
breakdown step once a basis build, not once a step.

Hermitian input is the caller's contract (as with every Lanczos
implementation); the Rayleigh coefficients are taken as their real parts.
Start vectors come from a ``torch.Generator`` on the operand's device
(seeded with ``utils.prng.DEFAULT_SEED`` unless given); ``x0`` overrides
it, and is how the tests hand both packages the same start.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..utils.prng import default_generator, random_unit_vector
from ..utils.timing import spanned
from .power import norm as _norm
from .power import vdot as _vdot


def _default_project(V, w):
    """c_i = <V_i, w> for the reorthogonalisation pass, over the basis seen
    as (m + 1, -1) (vector axes of w may be multi-dimensional, e.g. the
    interleaved (R, 128) layout)."""
    return torch.matmul(V.reshape(V.shape[0], -1).conj(), w.reshape(-1))


def _combine(c, V):
    """sum_i c_i V_i with V's vector shape (JAX ``tensordot(c, V, [[0], [0]])``)."""
    return torch.matmul(c, V.reshape(V.shape[0], -1)).reshape(V.shape[1:])


def _start_vector(M: AbstractMatrix, generator, x0):
    """The start vector in ``promote(M.dtype, float32)`` on M's device, in the
    operator's vector domain."""
    vec_dt = torch.promote_types(M.dtype, torch.float32)
    if x0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        x0 = random_unit_vector(gen, M.shape[0], vec_dt, device=M.device)
    else:
        x0 = torch.as_tensor(x0).to(device=M.device, dtype=vec_dt)
    return M.encode_vec(x0)


def _host_steps(brk, m: int) -> int:
    """The steps a basis build ran: its breakdown step, read once."""
    return min(int(brk), m)


def lanczos_decomposition(matvec, x0: torch.Tensor, m: int, *, vdot=_vdot, norm=_norm,
                          project=_default_project, reorth: bool = True):
    """Three-term Lanczos factorisation ``A V_m = V_m T_m + beta_m v_{m+1}``
    (JAX ``solvers/lanczos.py:43``).

    Returns ``(V, alpha, beta, breakdown_at)``: V ``(m+1, *x0.shape)``,
    ``alpha`` (m,) real diagonal, ``beta`` (m,) real subdiagonal
    (``beta[j] = T[j+1, j]``; ``beta[m-1]`` is the residual norm used in
    Ritz bounds), ``breakdown_at`` (a 0-d tensor) the step where the
    subspace became invariant (m if none). Fixed shapes; masked updates
    after breakdown.

    ``reorth=True`` adds one full classical Gram-Schmidt pass per step (two
    products with the basis): without it, finite-precision Lanczos loses
    orthogonality once Ritz values converge (ghost eigenvalues)."""
    dtype = x0.dtype
    rdt = real_dtype_of(dtype)
    dev = x0.device
    eps = torch.finfo(rdt).eps
    V = torch.zeros((m + 1,) + tuple(x0.shape), dtype=dtype, device=dev)
    V[0] = x0 / norm(x0).to(dtype)
    alpha = torch.zeros(m, dtype=rdt, device=dev)
    beta = torch.zeros(m, dtype=rdt, device=dev)
    brk = torch.tensor(m + 1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    for j in range(m):
        v = V[j]
        w = matvec(v)
        a = vdot(v, w).real.to(rdt)
        # three-term recurrence; at j == 0 the coefficient is 0 (JAX reads
        # the zero row V[0] there)
        b_prev = beta[j - 1] if j > 0 else zero
        w = w - a.to(dtype) * v - b_prev.to(dtype) * V[max(j - 1, 0)]
        if reorth:
            # rows > j of V are zero -> the unmasked full pass is exact
            w = w - _combine(project(V, w), V)
        b = norm(w).to(rdt)
        # epsilon-relative breakdown (invariant subspace), in the real
        # dtype of the vectors
        breakdown = b <= 100 * eps * torch.maximum(a.abs(), b_prev)
        safe = torch.where(breakdown, 1, b).to(dtype)
        still = ~(brk < j + 1)
        grow = still & ~breakdown
        V[j + 1] = torch.where(grow, w / safe, V[j + 1])
        alpha[j] = torch.where(still, a, alpha[j])
        beta[j] = torch.where(grow, b, beta[j])
        brk = torch.where(still & breakdown, torch.clamp(brk, max=j + 1), brk)
    return V, alpha, beta, torch.clamp(brk, max=m)


def _ritz_from_tridiag(alpha: np.ndarray, beta: np.ndarray, k: int, which: str, tol: float):
    """Host-side m x m tridiagonal eigensolve + Ritz residual bounds (JAX
    :118, numpy).

    Returns (ritz (k,), converged, S[:, idx]); ``converged`` is True when
    every selected Ritz pair's residual bound |beta_m s_{m,i}| passes the
    reference relative criterion against its Ritz value."""
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[:m - 1], 1) + np.diag(beta[:m - 1], -1)
    theta, S = np.linalg.eigh(T)
    if which == "LA":
        idx = np.argsort(-theta)[:k]
    elif which == "SA":
        idx = np.argsort(theta)[:k]
    else:  # "LM"
        idx = np.argsort(-np.abs(theta))[:k]
    resid = np.abs(beta[m - 1] * S[m - 1, idx])
    converged = bool(np.all(resid <= tol * (1.0 + np.abs(theta[idx]))))
    return theta[idx], converged, S[:, idx]


def lanczos_extend(matvec, W_init: torch.Tensor, l: int, m: int, *, vdot=_vdot, norm=_norm,
                   project=_default_project):
    """Extend a thick-restart basis (JAX :141): rows ``0..l`` of ``W_init``
    ((m+1, *vec_shape)) hold the retained Ritz vectors plus the residual
    vector; steps ``l..m-1`` run the Lanczos recurrence with a FULL
    reorthogonalisation pass (which also removes the arrowhead coupling at
    the seam step). Returns ``(W, alpha, beta, breakdown_at)`` with
    ``alpha[j]``/``beta[j]`` defined for ``j >= l``."""
    dtype = W_init.dtype
    rdt = real_dtype_of(dtype)
    dev = W_init.device
    eps = torch.finfo(rdt).eps
    W = W_init.clone()
    alpha = torch.zeros(m, dtype=rdt, device=dev)
    beta = torch.zeros(m, dtype=rdt, device=dev)
    brk = torch.tensor(m + 1, dtype=torch.int32, device=dev)
    for j in range(l, m):
        v = W[j]
        w = matvec(v)
        a = vdot(v, w).real.to(rdt)
        # the full classical Gram-Schmidt pass against the whole basis (rows
        # beyond the frontier are zero) subsumes the three-term subtraction
        # and the restart coupling
        c = project(W, w)
        w = w - _combine(c, W)
        b = norm(w).to(rdt)
        breakdown = b <= 100 * eps * torch.maximum(a.abs(), c.abs().max().to(rdt))
        safe = torch.where(breakdown, 1, b).to(dtype)
        still = ~(brk < j + 1)
        grow = still & ~breakdown
        W[j + 1] = torch.where(grow, w / safe, W[j + 1])
        alpha[j] = torch.where(still, a, alpha[j])
        beta[j] = torch.where(grow, b, beta[j])
        brk = torch.where(still & breakdown, torch.clamp(brk, max=j + 1), brk)
    return W, alpha, beta, torch.clamp(brk, max=m)


def _values(theta, total_mv: int, converged: bool, device) -> QRResult:
    """The host Ritz values as a ``QRResult`` on the operand's device."""
    from .qr_eigenvalues import _result
    return _result(torch.from_numpy(np.array(theta, np.float64)).to(device), total_mv,
                   converged)


@spanned
def lanczos_thick_restart(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                          restarts: int = 50, opts: SolverOptions = SolverOptions(),
                          which: str = "LA", dtype=None,
                          generator: torch.Generator | None = None, x0=None) -> QRResult:
    """Thick-restart Lanczos (TRLan): top-``k`` eigenvalues of a
    symmetric/Hermitian operator with a memory-bounded basis (JAX :194).

    The basis is capped at ``m`` vectors and restarted: each cycle keeps the
    ``l ~ 2k`` best Ritz vectors plus the residual vector and extends back to
    ``m`` (the restart coupling is an arrowhead in the projected matrix,
    assembled on the host). ``which``: "LA" or "SA". ``iterations`` reports
    total matvecs spent on basis building."""
    if which not in ("LA", "SA"):
        raise ValueError(f"lanczos_thick_restart: unknown which={which!r} "
                         "(LA or SA; use lanczos_eigenvalues for LM)")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lanczos_thick_restart")
    require_square(M, "lanczos_thick_restart")
    require_nonempty(M, "lanczos_thick_restart")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lanczos_thick_restart: k must be >= 1")
    if m is None:
        m = min(max(3 * k + 10, 20), n)
    m = min(m, n)
    l = min(2 * k, m - 2)
    if l < k:
        raise ValueError(
            f"lanczos_thick_restart: m ({m}) too small for k ({k}); need "
            f"m >= k + 2")
    x0 = _start_vector(M, generator, x0)
    sign = -1.0 if which == "LA" else 1.0  # eigh sorts ascending

    # first cycle: plain Lanczos
    V, alpha, beta, brk = lanczos_decomposition(M.matvec, x0, m)
    steps = _host_steps(brk, m)
    total_mv = steps
    alpha, beta = alpha.cpu().numpy(), beta.cpu().numpy()
    T = np.diag(alpha[:steps])
    if steps > 1:
        off = beta[:steps - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
    beta_last = float(beta[steps - 1]) if steps >= 1 else 0.0

    tol = float(opts.tolerance)
    for _ in range(restarts):
        theta, S = np.linalg.eigh(T)
        order = np.argsort(sign * theta)
        sel_k = order[:k]
        resid_k = np.abs(beta_last * S[-1, sel_k])
        if np.all(resid_k <= tol * (1.0 + np.abs(theta[sel_k]))) or beta_last == 0.0:
            return _values(theta[sel_k], total_mv, True, M.device)
        # retain l Ritz pairs + the residual direction
        sel_l = order[:min(l, steps - 1)]
        l_eff = len(sel_l)
        S_l = torch.from_numpy(np.ascontiguousarray(S[:, sel_l])).to(V.device, V.dtype)
        W0 = torch.zeros_like(V)
        W0[:l_eff] = torch.matmul(S_l.T, V[:steps].reshape(steps, -1)).reshape(
            (l_eff,) + V.shape[1:])
        W0[l_eff] = V[steps]                              # residual vector
        coupling = beta_last * S[-1, sel_l]               # (l_eff,)

        V, alpha2, beta2, brk2 = lanczos_extend(M.matvec, W0, l_eff, m)
        steps2 = _host_steps(brk2, m)
        total_mv += max(steps2 - l_eff, 0)
        # assemble the arrowhead + tridiagonal projected matrix
        T = np.zeros((steps2, steps2))
        T[:l_eff, :l_eff] = np.diag(theta[sel_l])
        T[:l_eff, l_eff] = coupling[:l_eff]
        T[l_eff, :l_eff] = coupling[:l_eff]
        a2, b2 = alpha2.cpu().numpy(), beta2.cpu().numpy()
        for j in range(l_eff, steps2):
            T[j, j] = a2[j]
            if j + 1 < steps2:
                T[j + 1, j] = T[j, j + 1] = b2[j]
        beta_last = float(b2[steps2 - 1]) if steps2 > l_eff else 0.0
        steps = steps2

    theta, S = np.linalg.eigh(T)
    order = np.argsort(sign * theta)[:k]
    return _values(theta[order], total_mv, False, M.device)


@spanned
def lanczos_eigenpairs(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                       opts: SolverOptions = SolverOptions(), which: str = "LM",
                       reorth: bool = True, dtype=None,
                       generator: torch.Generator | None = None, x0=None):
    """Like ``lanczos_eigenvalues`` but also returns the Ritz VECTORS.

    Returns ``(result, vectors)`` with ``vectors`` an ``(n, k)`` tensor of
    Ritz vectors ``Y = V_m^T S`` decoded to the natural domain (unit
    columns). Residuals ``||A y - theta y||`` match the bounds used for
    ``result.converged``."""
    return _lanczos_impl(M, k, m=m, opts=opts, which=which, reorth=reorth, dtype=dtype,
                         generator=generator, x0=x0, want_vectors=True)


@spanned
def lanczos_eigenvalues(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                        opts: SolverOptions = SolverOptions(), which: str = "LM",
                        reorth: bool = True, dtype=None,
                        generator: torch.Generator | None = None, x0=None) -> QRResult:
    """Top-``k`` eigenvalues of a symmetric/Hermitian operator.

    ``which``: "LM" (largest magnitude, default), "LA" (largest algebraic)
    or "SA" (smallest algebraic). ``m`` defaults to ``min(max(2k+10, 20), n)``
    Lanczos steps. Returns a ``QRResult`` whose (real, float64)
    ``eigenvalues`` are the selected Ritz values, ``iterations`` the Krylov
    steps actually run, and ``converged`` the all-pairs Ritz-residual test
    at ``opts.tolerance``."""
    return _lanczos_impl(M, k, m=m, opts=opts, which=which, reorth=reorth, dtype=dtype,
                         generator=generator, x0=x0, want_vectors=False)


def _lanczos_impl(M: AbstractMatrix, k: int, *, m, opts, which, reorth, dtype, generator, x0,
                  want_vectors: bool):
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"lanczos_eigenvalues: unknown which={which!r}")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "lanczos_eigenvalues")
    require_square(M, "lanczos_eigenvalues")
    require_nonempty(M, "lanczos_eigenvalues")
    n = M.shape[0]
    if k < 1:
        raise ValueError("lanczos_eigenvalues: k must be >= 1")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"lanczos_eigenvalues: k ({k}) must be <= m ({m})")
    x0 = _start_vector(M, generator, x0)

    V, alpha, beta, brk = lanczos_decomposition(M.matvec, x0, m, reorth=reorth)
    steps = max(_host_steps(brk, m), 1)
    ritz, converged, S = _ritz_from_tridiag(alpha.cpu().numpy()[:steps],
                                            beta.cpu().numpy()[:steps],
                                            min(k, steps), which, float(opts.tolerance))
    res = _values(ritz, steps, converged, M.device)
    if not want_vectors:
        return res
    # Ritz vectors: Y = sum_j S[j, :] V_j, decoded to the natural domain
    S = torch.from_numpy(np.ascontiguousarray(S[:steps])).to(V.device, V.dtype)
    Y = torch.matmul(S.T, V[:steps].reshape(steps, -1)).reshape((S.shape[1],) + V.shape[1:])
    return res, torch.stack([M.decode_vec(y) for y in Y], dim=1)  # (n, k)
