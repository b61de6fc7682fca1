"""Arnoldi iteration — top-k eigenvalues of large (sparse) operators.

The port of the JAX package's ``solvers/arnoldi.py``. An m-dimensional
Krylov basis is built with the operator's matvec as the only O(n)
operation (B1/B2 banded, B6 general sparse on the card), projected to an
m x m Hessenberg matrix, and the small projection is solved where it lies:
on a CPU tensor by ``_qr_eigenvalues_accel`` (the function JAX calls), on a
CUDA tensor by the port's accelerated sweeps on a Hessenberg input, B8
(``ops/qr_kernels.py::qr_eig_sweeps``) up to ``UNBLOCKED_MAX_N`` and B13
(``ops/qr_eig_blocked.py::blocked_sweeps``) beyond.

``krylov_schur_eigenvalues`` restarts: each cycle extends the basis on the
device, reads the small projected matrix to the host once, takes its
ordered Schur form there (numpy/scipy, as in JAX), and contracts the basis
with ``torch.matmul`` (XLA's ``tensordot`` in JAX). The basis loops keep
every update masked on the device after a breakdown; the host reads the
breakdown step once a cycle.

Unlike the JAX functions, the start vector is put in the operator's vector
domain (``M.encode_vec``) and in ``promote(M.dtype, float32)``, so that
``InterleavedDIA`` operators (B1) and bf16 diagonals run here too; on every
other operand the two are the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type, complex_dtype_of, real_dtype_of
from ..core.options import SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix, require_nonempty, require_square
from ..utils.timing import annotate, host_read, host_write, spanned
from .lanczos import _combine, _default_project, _host_steps, _start_vector
from .qr_eigenvalues import _result
from .power import norm as _norm
from .power import vdot as _vdot


def arnoldi_decomposition(matvec, x0: torch.Tensor, m: int, *, vdot=_vdot, norm=_norm):
    """Krylov factorisation ``A V_m = V_{m+1} H`` via modified Gram-Schmidt
    (JAX ``solvers/arnoldi.py:30``).

    Returns ``(V, H, breakdown_at)`` with V (m+1, ...) leading with the
    Krylov index over ``x0``'s shape, H (m+1, m); ``breakdown_at`` (a 0-d
    tensor) is the step where the subspace became invariant (m if none).
    Fixed shapes and masked updates after a breakdown, as in JAX; the
    projection of step j runs over the j + 1 basis vectors it has (JAX's
    masked terms beyond them are exact zeros)."""
    dtype = x0.dtype
    rdt = real_dtype_of(dtype)
    dev = x0.device
    V = torch.zeros((m + 1,) + tuple(x0.shape), dtype=dtype, device=dev)
    V[0] = x0 / norm(x0).to(dtype)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    brk = host_write(m + 1, dev, torch.int32)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(m):
        with annotate("eigsol.arnoldi.spmv"):
            w = matvec(V[j])
        with annotate("eigsol.arnoldi.orthogonalize"):
            h = []
            for i in range(j + 1):
                hij = vdot(V[i], w)
                w = w - hij * V[i]
                h.append(hij)
            hjj = norm(w).to(rdt)
            breakdown = hjj == 0
            safe = torch.where(breakdown, 1, hjj).to(dtype)
            hcol = torch.stack(h + [hjj.to(dtype)] + [zero] * (m - j - 1))
            still = ~(brk < j + 1)  # no earlier breakdown
            V[j + 1] = torch.where(still & ~breakdown, w / safe, V[j + 1])
            H[:, j] = torch.where(still, hcol, H[:, j])
            brk = torch.where(still & breakdown, torch.clamp(brk, max=j + 1), brk)
    return V, H, torch.clamp(brk, max=m)


def _projection_eigenvalues(Hm: torch.Tensor, max_sweeps: int, tol: float):
    """All eigenvalues of the complex m x m Hessenberg projection, where it
    lies: ``(eigenvalues, sweeps, converged)``. A CPU tensor takes
    ``_qr_eigenvalues_accel``; a CUDA tensor B8 up to ``UNBLOCKED_MAX_N``,
    B13 beyond."""
    from ..ops.qr_eig_blocked import blocked_sweeps
    from ..ops.qr_kernels import qr_eig_sweeps
    from . import qr_eigenvalues as qe
    engine = qe.qr_dispatch(Hm.shape[0], Hm.device)
    with annotate("eigsol.arnoldi.projection"):
        if engine == "torch":
            r = qe._qr_eigenvalues_accel(Hm, int(max_sweeps), float(tol))
            return r.eigenvalues, int(r.iterations), bool(r.converged)
        sweeps = qr_eig_sweeps if engine == "cuda_unblocked" else blocked_sweeps
        eig, count, hi = sweeps(Hm, int(max_sweeps), float(tol))[:3]
        return eig, host_read(count), host_read(hi) <= 1


def _arnoldi_eigs(M: AbstractMatrix, x0: torch.Tensor, m: int, k: int, qr_tol: float,
                  qr_max: int):
    """The basis on the operand's device (SpMV-dominated), then the m x m
    projection's solve where H lies (JAX ``_arnoldi_eigs``, :82)."""
    V, H, _ = arnoldi_decomposition(M.matvec, x0, m)
    Hm = H[:m, :m].to(complex_dtype_of(H.dtype))
    eigs, sweeps, converged = _projection_eigenvalues(Hm, qr_max, qr_tol)
    order = torch.argsort(-eigs.abs(), stable=True)
    return eigs[order][:k], converged, sweeps, V, H


def _check(M: AbstractMatrix, k: int, dtype, what: str) -> int:
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, what)
    require_square(M, what)
    require_nonempty(M, what)
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1")
    return M.shape[0]


@spanned
def arnoldi_eigenvalues(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                        opts: SolverOptions = SolverOptions(), dtype=None,
                        generator: torch.Generator | None = None, x0=None) -> QRResult:
    """Top-``k`` eigenvalues (by magnitude) via an m-step Arnoldi projection.

    ``m`` defaults to ``min(max(2k + 10, 20), n)``. Returns a ``QRResult``
    whose ``eigenvalues`` are the k dominant Ritz values (complex dtype),
    ``iterations`` the QR sweeps spent on the projection, and ``converged``
    the small-solve convergence flag."""
    n = _check(M, k, dtype, "arnoldi_eigenvalues")
    if m is None:
        m = min(max(2 * k + 10, 20), n)
    m = min(m, n)
    if k > m:
        raise ValueError(f"arnoldi_eigenvalues: k ({k}) must be <= m ({m})")
    x0 = _start_vector(M, generator, x0)
    ritz, converged, iterations, _, _ = _arnoldi_eigs(M, x0, m, k, opts.tolerance,
                                                      opts.max_iterations)
    return _result(ritz, iterations, converged)


# ---------------------------------------------------------------------------
# Krylov-Schur restarting (nonsymmetric thick restart)
# ---------------------------------------------------------------------------

def arnoldi_extend(matvec, W_init: torch.Tensor, l: int, m: int, *, norm=_norm, project=None):
    """Extend a Krylov-Schur basis (JAX :136): rows ``0..l`` of ``W_init``
    ((m+1, *vec_shape)) hold the retained (contracted) basis plus the
    residual vector at row ``l``; steps ``l..m-1`` run the Arnoldi
    recurrence with a FULL classical-Gram-Schmidt pass (which also removes
    the restart coupling at the seam). Returns ``(W, H, brk)`` with ``H``
    (m+1, m): columns ``j >= l`` are the projection coefficients,
    ``H[j+1, j]`` the new subdiagonal norm."""
    if project is None:
        project = _default_project
    dtype = W_init.dtype
    rdt = real_dtype_of(dtype)
    dev = W_init.device
    eps = torch.finfo(rdt).eps
    W = W_init.clone()
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    brk = host_write(m + 1, dev, torch.int32)
    for j in range(l, m):
        w = matvec(W[j])
        c = project(W, w)                      # (m+1,) coefficients
        w = w - _combine(c, W)
        b = norm(w).to(rdt)
        scale = torch.clamp(c.abs().max().to(rdt), min=1e-30)
        breakdown = b <= 100 * eps * scale
        safe = torch.where(breakdown, 1, b).to(dtype)
        hcol = c.clone()
        hcol[j + 1] = b.to(dtype)
        still = ~(brk < j + 1)
        W[j + 1] = torch.where(still & ~breakdown, w / safe, W[j + 1])
        H[:, j] = torch.where(still, hcol, H[:, j])
        brk = torch.where(still & breakdown, torch.clamp(brk, max=j + 1), brk)
    return W, H, torch.clamp(brk, max=m)


def _sort_threshold(moduli: np.ndarray, l: int) -> float:
    """A modulus between the ``l`` largest (with any within 1e-10 of the
    l-th) and the rest, halfway across the gap; 0 when nothing is left out."""
    mods = np.sort(moduli)[::-1]
    cut = max(l, 1)
    while cut < len(mods) and mods[cut] >= mods[cut - 1] * (1 - 1e-10):
        cut += 1
    return 0.0 if cut >= len(mods) else float(mods[cut - 1] + mods[cut]) / 2


def _ks_contract(Hm: np.ndarray, beta: float, k: int, l_target: int, tol: float):
    """Host-side Krylov-Schur restart math on the small projected matrix
    (JAX :185, numpy/scipy).

    Returns ``(wanted, resid, converged, Q_l, S_new, b_new)``: the k wanted
    Ritz values (largest magnitude), their residual estimates ``|beta *
    s_last|``, the convergence flag, and — when not converged — the
    ordered-Schur contraction: orthonormal ``Q_l`` (steps, l_eff) with the
    wanted invariant subspace leading, ``S_new = Q^H Hm Q``
    (quasi-)triangular, and the transformed residual coupling row ``b_new =
    beta * Q[last, :]``. Real input keeps everything real (conjugate pairs
    stay paired in the real Schur form), so the basis contraction stays in
    the basis' real dtype."""
    import scipy.linalg as sla
    steps = Hm.shape[0]
    w, X = np.linalg.eig(Hm)
    order = np.argsort(-np.abs(w))
    sel_k = order[:k]
    resid = np.abs(beta * X[-1, sel_k])
    converged = bool(np.all(resid <= tol * (1.0 + np.abs(w[sel_k]))) or beta == 0.0)
    if converged:
        return w[sel_k], resid, True, None, None, None
    l_target = min(l_target, steps - 1)
    # The ordered Schur form in double precision, sorted at a gap of the
    # moduli: JAX sorts at the l-th modulus itself (times 1 - 1e-12), where
    # the reordering's rounding can move that eigenvalue below the bar and
    # LAPACK then refuses the sort (a float32 projection of the port's
    # card runs did so). The kept set is JAX's but for moduli within 1e-10
    # of the l-th, and float64 input gives JAX's factors.
    is_real = not np.iscomplexobj(Hm)
    wide = Hm.astype(np.float64 if is_real else np.complex128)
    thr = _sort_threshold(np.abs(np.linalg.eigvals(wide)), l_target)
    if is_real:
        T, Z, sdim = sla.schur(wide, output="real", sort=lambda re, im: np.hypot(re, im) >= thr)
    else:
        T, Z, sdim = sla.schur(wide, output="complex", sort=lambda lam: np.abs(lam) >= thr)
    T, Z = T.astype(Hm.dtype), Z.astype(Hm.dtype)
    l_eff = int(min(max(sdim, 1), steps - 1))
    if is_real and T[l_eff, l_eff - 1] != 0.0:
        # The clamp landed inside a real-Schur 2x2 conjugate block (ties in
        # |lambda| can make scipy select sdim == steps). Cutting there would
        # discard the coupling T[l_eff, l_eff-1] and corrupt the Krylov
        # relation A V_l = V_l S + v b^T, so move the cut to a block
        # boundary: retreat one column, or, when the block is the leading
        # 2x2 (l_eff == 1), grow to include it (2 <= steps - 1 because
        # steps >= k + 2 >= 3).
        l_eff = l_eff - 1 if l_eff >= 2 else l_eff + 1
    Q_l = Z[:, :l_eff]
    S_new = T[:l_eff, :l_eff]
    b_new = beta * Z[steps - 1, :l_eff]
    return w[sel_k], resid, False, Q_l, S_new, b_new


@spanned
def krylov_schur_eigenvalues(M: AbstractMatrix, k: int = 6, *, m: int | None = None,
                             restarts: int = 60, opts: SolverOptions = SolverOptions(),
                             dtype=None, generator: torch.Generator | None = None,
                             x0=None) -> QRResult:
    """Top-``k`` eigenvalues (largest magnitude) of a general operator by
    Krylov-Schur restarted Arnoldi (JAX :235), the nonsymmetric analogue of
    ``lanczos_thick_restart``.

    Each cycle: extend the basis to ``m`` on the operand's device (the SpMV
    is the only O(n) op), compute the ordered Schur form of the small
    projected matrix on the host, contract to the leading wanted invariant
    subspace, and restart. ``iterations`` reports total matvecs; the
    eigenvalues (complex128) come back on the operand's device."""
    n = _check(M, k, dtype, "krylov_schur_eigenvalues")
    if restarts < 1:
        raise ValueError("krylov_schur_eigenvalues: restarts must be >= 1")
    if m is None:
        m = min(max(3 * k + 10, 20), n)
    m = min(m, n)
    if k + 2 > m:
        raise ValueError(f"krylov_schur_eigenvalues: m ({m}) too small "
                         f"for k ({k}); need m >= k + 2")
    l_target = min(2 * k, m - 2)
    x0 = _start_vector(M, generator, x0)

    wanted, total_mv, converged = krylov_schur_cycles(
        M.matvec, arnoldi_decomposition(M.matvec, x0, m), m, k, l_target,
        float(opts.tolerance), restarts, arnoldi_extend)
    return _result(torch.from_numpy(np.asarray(wanted)).to(M.device), total_mv, converged)


def krylov_schur_cycles(matvec, basis, m: int, k: int, l_target: int, tol: float,
                        restarts: int, extend):
    """The restart cycles of Krylov-Schur from the first basis ``basis = (V,
    H, brk)``: the ordered-Schur contraction on the host (``_ks_contract``),
    the basis contracted where it lies (``torch.matmul``), and
    ``extend(matvec, W0, l, m)`` back to ``m``. Returns ``(wanted, matvecs,
    converged)``; the distributed solver passes its all-reduced extension."""
    V, H, brk = basis
    steps = _host_steps(brk, m)
    total_mv = steps
    Hnp = H.cpu().numpy()
    Hm = Hnp[:steps, :steps]
    beta = float(np.abs(Hnp[steps, steps - 1])) if steps == m else 0.0
    wanted = None
    for _ in range(restarts):
        wanted, _resid, conv, Q_l, S_new, b_new = _ks_contract(Hm, beta, k, l_target, tol)
        if conv:
            return wanted, total_mv, True
        l_eff = Q_l.shape[1]
        Qd = torch.from_numpy(np.ascontiguousarray(Q_l)).to(V.device, V.dtype)
        W0 = torch.zeros_like(V)
        W0[:l_eff] = torch.matmul(Qd.T, V[:steps].reshape(steps, -1)).reshape(
            (l_eff,) + V.shape[1:])
        W0[l_eff] = V[steps]
        V, H2, brk2 = extend(matvec, W0, l_eff, m)
        steps2 = _host_steps(brk2, m)
        total_mv += max(steps2 - l_eff, 0)
        H2np = H2.cpu().numpy()
        cdt = S_new.dtype
        Hm = np.zeros((steps2, steps2), cdt)
        Hm[:, l_eff:] = H2np[:steps2, l_eff:steps2].astype(cdt)
        Hm[:l_eff, :l_eff] = S_new
        Hm[l_eff, :l_eff] = b_new
        beta = float(np.abs(H2np[steps2, steps2 - 1])) if steps2 == m else 0.0
        steps = steps2
    return wanted, total_mv, False
