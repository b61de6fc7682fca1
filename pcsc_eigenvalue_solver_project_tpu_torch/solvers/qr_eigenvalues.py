"""QR eigenvalue iteration.

Two modes (``QROptions.mode``):

``"parity"`` — the reference algorithm exactly (reference
src/qr_method/qr_eigenvalues.hpp:40-108): Hessenberg reduction, then
unshifted sweeps ``H = Q R; H := R Q`` using the FULL Householder QR each
sweep, stopping when ``max_i |H(i, i-1)| <= tol * (1 + ||H||_F)`` (:77-93).
Iteration-count semantics preserved: ``iterations == iter+1`` at the
converging sweep and ``max_iterations + 1`` on non-convergence (:69,104);
n == 0 returns an empty converged result (:55-57).

``"accelerated"`` — Wilkinson-shifted sweeps with deflation, O(n^2) per
sweep on the Hessenberg form, run so that conjugate pairs of real matrices
converge (the reference's real unshifted iteration cannot separate them).

Where it runs (``qr_dispatch``): a CPU tensor takes the JAX package's CPU
route — parity through ``_qr_eigenvalues_parity``, accelerated through the
real Francis iteration for real input and complex Givens sweeps for complex
input, eigenpairs through ``_qr_eigenvectors_xla`` — so the CPU tests
compare like with like. A CUDA tensor takes the kernels for every dtype:
parity runs the Hessenberg reduction (B7, or B11 from
``HESSENBERG_BLOCKED_MIN_N`` on) then B10 at every n; accelerated mode runs
the reduction then the unblocked sweeps B8 up to ``UNBLOCKED_MAX_N`` and
beyond it ``blocked_eigenvalues``: the blocked sweeps B13, between rounds of
aggressive early deflation from ``AED_MIN_N`` on (``ops/qr_aed.py``);
eigenpairs run the reduction with Q, the same sweeps with Schur Q (AED's
from ``SCHUR_AED_MIN_N`` on), then B14 (``ops/qr_kernels.py``,
``ops/qr_eig_blocked.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import check_scalar_type, complex_dtype_of, real_dtype_of
from ..core.options import QROptions, SolverOptions
from ..core.results import QRResult
from ..matrix.protocol import AbstractMatrix
from ..utils.timing import host_write, spanned
from .hessenberg import hessenberg_dense, vector_norm
from .qr import qr_decompose_dense


def _result(eigenvalues, iterations, converged) -> QRResult:
    device = eigenvalues.device
    return QRResult(eigenvalues=eigenvalues,
                    iterations=host_write(int(iterations), device, torch.int32),
                    converged=host_write(bool(converged), device))


# ---------------------------------------------------------------------------
# parity mode
# ---------------------------------------------------------------------------

def _qr_eigenvalues_parity(a: torch.Tensor, max_iterations: int, tol: float) -> QRResult:
    n = a.shape[0]
    if n == 0:
        return _result(torch.zeros((0,), dtype=a.dtype, device=a.device), 0, True)
    tol = torch.tensor(tol, dtype=real_dtype_of(a.dtype), device=a.device)
    H = hessenberg_dense(a)
    it, converged = 0, False
    while it < max_iterations and not converged:
        Q, R = qr_decompose_dense(H)
        H = R @ Q  # (qr_eigenvalues.hpp:74)
        max_subdiag = (torch.abs(torch.diagonal(H, offset=-1)).max() if n > 1
                       else torch.zeros_like(tol))
        converged = bool(max_subdiag <= tol * (1.0 + vector_norm(H.reshape(-1))))
        it += 1
    # reference reports iter+1: converging sweep i (0-based) -> i+1 == it;
    # non-convergence -> max_iterations + 1 (qr_eigenvalues.hpp:69,104).
    return _result(torch.diagonal(H).clone(), it if converged else it + 1, converged)


# ---------------------------------------------------------------------------
# accelerated mode, complex arithmetic: Givens sweeps + Wilkinson shift
# ---------------------------------------------------------------------------

def _givens_sweep_q(H: torch.Tensor, Q, hi: int, shift: torch.Tensor):
    """One shifted QR sweep on the active window H[:hi, :hi] via Givens.

    Computes ``H - shift I = Q R`` with hi-1 Givens rotations (only the
    Hessenberg subdiagonal needs elimination), then ``R Q + shift I``. When
    ``Q`` is given (not None) it is right-multiplied by the sweep's rotations
    too, so that ``A = Q H Q^H`` stays invariant. Returns ``(H, Q)``."""
    n = H.shape[0]
    one = torch.ones((), dtype=H.dtype, device=H.device)
    diag_shift = torch.diag(torch.where(torch.arange(n, device=H.device) < hi, shift, 0))
    H = H - diag_shift
    rotations = []
    for k in range(hi - 1):
        a, b = H[k, k], H[k + 1, k]
        r = torch.sqrt(torch.abs(a) ** 2 + torch.abs(b) ** 2)
        zero = r == 0
        rs = torch.where(zero, 1, r).to(H.dtype)
        g00 = torch.where(zero, one, a.conj() / rs)
        g01 = torch.where(zero, 0, b.conj() / rs)
        row_k, row_k1 = H[k].clone(), H[k + 1].clone()
        H[k] = g00 * row_k + g01 * row_k1
        H[k + 1] = -g01.conj() * row_k + g00.conj() * row_k1
        rotations.append((g00, g01))
    if Q is not None:
        Q = Q.clone()
    for M in (H,) if Q is None else (H, Q):
        for k, (g00, g01) in enumerate(rotations):
            ck, ck1 = M[:, k].clone(), M[:, k + 1].clone()
            M[:, k] = g00.conj() * ck + g01.conj() * ck1
            M[:, k + 1] = -g01 * ck + g00 * ck1
    return H + diag_shift, Q


def _wilkinson_shift(H: torch.Tensor, hi: int) -> torch.Tensor:
    """Eigenvalue of the trailing active 2x2 closest to its bottom entry."""
    a, b = H[hi - 2, hi - 2], H[hi - 2, hi - 1]
    c, d = H[hi - 1, hi - 2], H[hi - 1, hi - 1]
    delta = (a - d) / 2.0
    sq = torch.sqrt(delta * delta + b * c)  # complex sqrt
    mu_plus, mu_minus = d + delta + sq, d + delta - sq
    return torch.where(torch.abs(mu_plus - d) < torch.abs(mu_minus - d), mu_plus, mu_minus)


def _qr_eigenvalues_accel_schur(H0: torch.Tensor, max_sweeps: int, tol: float,
                                with_q: bool = True):
    """Shifted Givens sweeps with deflation on a complex Hessenberg ``H0``.
    Returns ``(T, Q, sweeps, hi)`` with ``H0 = Q T Q^H`` (``Q`` None unless
    ``with_q``); converged when ``hi <= 1``."""
    n = H0.shape[0]
    tol = torch.tensor(tol, dtype=real_dtype_of(H0.dtype), device=H0.device)

    def deflate(H, hi):
        while hi > 1:
            scale = torch.abs(H[hi - 2, hi - 2]) + torch.abs(H[hi - 1, hi - 1])
            if not bool(torch.abs(H[hi - 1, hi - 2]) <= tol * torch.clamp(scale, min=1.0)):
                break
            hi -= 1
        return hi

    H = H0.clone()
    Q = torch.eye(n, dtype=H0.dtype, device=H0.device) if with_q else None
    hi, sweeps = deflate(H, n), 0
    while hi > 1 and sweeps < max_sweeps:
        H, Q = _givens_sweep_q(H, Q, hi, _wilkinson_shift(H, hi))
        hi = deflate(H, hi)
        sweeps += 1
    return H, Q, sweeps, hi


def _qr_eigenvalues_accel(H0: torch.Tensor, max_sweeps: int, tol: float) -> QRResult:
    """Input MUST already be upper Hessenberg and complex."""
    if H0.shape[0] <= 1:
        return _result(torch.diagonal(H0).clone(), 0, True)
    H, _, sweeps, hi = _qr_eigenvalues_accel_schur(H0, max_sweeps, tol, with_q=False)
    return _result(torch.diagonal(H).clone(), sweeps, hi <= 1)


def _hessenberg_dense_q(a: np.ndarray):
    """Host Hessenberg reduction that also returns the accumulated unitary
    (``A = Q H Q^H``): the numpy mirror of ``hessenberg_host``."""
    H = np.array(a)
    n = H.shape[0]
    Q = np.eye(n, dtype=H.dtype)
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
        Q[:, k + 1:] -= 2.0 * np.outer(Q[:, k + 1:] @ v, np.conj(v))
    return H, Q


def _qr_eigenvectors_xla(a: torch.Tensor, max_it: int, dtol: float) -> QRResult:
    """The eigenvector path of the JAX package's CPU route: the Schur form
    by shifted Givens sweeps with Q, then the eigenvectors by triangular
    back-substitution (numpy), normalised. Computes in the complex dtype of
    the input's precision."""
    from ..ops.qr_kernels import triangular_eigenvectors
    cdt = complex_dtype_of(a.dtype)
    H0, Qh = _hessenberg_dense_q(a.to(cdt).numpy())
    T, Qs, sweeps, hi = _qr_eigenvalues_accel_schur(torch.from_numpy(H0), max_it, dtol)
    T = T.numpy()
    Q = Qh @ Qs.numpy()
    src_rdt = np.float32 if cdt == torch.complex64 else np.float64
    V = Q.astype(np.complex128) @ triangular_eigenvectors(T.astype(np.complex128),
                                                          source_real_dtype=src_rdt)
    V = V / np.maximum(np.linalg.norm(V, axis=0, keepdims=True), 1e-300)
    res = _result(torch.from_numpy(np.diagonal(T).copy()), sweeps, hi <= 1)
    res.eigenvectors = torch.from_numpy(V).to(cdt)
    return res


# ---------------------------------------------------------------------------
# accelerated mode, real arithmetic: single-shift real QR with 1x1/2x2
# deflation; complex conjugate pairs are extracted analytically from trailing
# 2x2 blocks into (re, im) planes.
# ---------------------------------------------------------------------------

def _eig2x2_planes(a, b, c, d):
    """Eigenvalues of a real 2x2 [[a,b],[c,d]] as ((re1,im1),(re2,im2))."""
    half_tr = (a + d) / 2.0
    delta = (a - d) / 2.0
    disc = delta * delta + b * c
    s = torch.sqrt(torch.abs(disc))
    real_case = disc >= 0
    re1 = torch.where(real_case, half_tr + s, half_tr)
    re2 = torch.where(real_case, half_tr - s, half_tr)
    im1 = torch.where(real_case, torch.zeros_like(s), s)
    return (re1, im1), (re2, -im1)


def _householder3(x, y, z):
    """3-vector Householder P = I - 2 v v^T zeroing y and z; the identity
    when the vector degenerates."""
    nrm = torch.sqrt(x * x + y * y + z * z)
    alpha = -torch.where(x >= 0, 1.0, -1.0).to(x.dtype) * nrm
    v0 = x - alpha
    v = torch.stack([v0, y, z])
    vn2 = v0 * v0 + y * y + z * z
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    if bool(vn2 == 0):
        return eye
    return eye - (2.0 / vn2) * torch.outer(v, v)


def _francis_sweep(H: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """One implicit double-shift (Francis) QR sweep on the trailing
    unreduced block H[lo:hi, lo:hi] via bulge chasing. ``lo`` MUST be the
    top of the trailing unreduced block; the caller guarantees hi - lo >= 3.
    """
    a_, b_ = H[hi - 2, hi - 2], H[hi - 2, hi - 1]
    c_, d_ = H[hi - 1, hi - 2], H[hi - 1, hi - 1]
    s = a_ + d_
    t = a_ * d_ - b_ * c_
    # first column of (H - l1 I)(H - l2 I) restricted to the block
    h00, h10 = H[lo, lo], H[lo + 1, lo]
    x0 = h00 * h00 + H[lo, lo + 1] * h10 - s * h00 + t
    y0 = h10 * (h00 + H[lo + 1, lo + 1] - s)
    z0 = h10 * H[lo + 2, lo + 1]
    H = H.clone()
    # chase k = lo .. hi-3; the leftover bulge element is cleaned by the
    # explicit 2x2 rotation below.
    for k in range(lo, hi - 2):
        if k == lo:
            P = _householder3(x0, y0, z0)
        else:
            P = _householder3(H[k, k - 1], H[k + 1, k - 1], H[k + 2, k - 1])
        H[k:k + 3, :] = P @ H[k:k + 3, :]
        H[:, k:k + 3] = H[:, k:k + 3] @ P.T
    # final step: zero the leftover bulge H[hi-1, hi-3] with a 2-rotation
    # of rows/cols (hi-2, hi-1)
    x, y = H[hi - 2, hi - 3], H[hi - 1, hi - 3]
    r = torch.sqrt(x * x + y * y)
    zero = r == 0
    safe = torch.where(zero, 1, r)
    cth = torch.where(zero, 1, x / safe)
    sth = torch.where(zero, 0, y / safe)
    rk, rk1 = H[hi - 2].clone(), H[hi - 1].clone()
    H[hi - 2] = cth * rk + sth * rk1
    H[hi - 1] = -sth * rk + cth * rk1
    ck, ck1 = H[:, hi - 2].clone(), H[:, hi - 1].clone()
    H[:, hi - 2] = cth * ck + sth * ck1
    H[:, hi - 1] = -sth * ck + cth * ck1
    return H


def _qr_eigenvalues_accel_real(H0: torch.Tensor, max_sweeps: int, tol: float):
    """Real-arithmetic accelerated QR over an ALREADY-HESSENBERG input.
    Returns (eig_planes (2, n), iterations, converged)."""
    n = H0.shape[0]
    eig = torch.zeros((2, n), dtype=H0.dtype, device=H0.device)
    if n <= 1:
        eig[0] = torch.diagonal(H0)
        return eig, 0, True
    tol = torch.tensor(tol, dtype=H0.dtype, device=H0.device)

    def small(H, i):
        # |H[i, i-1]| negligible relative to its diagonal neighbourhood
        scale = torch.abs(H[i - 1, i - 1]) + torch.abs(H[i, i])
        return bool(torch.abs(H[i, i - 1]) <= tol * torch.clamp(scale, min=1.0))

    def write2(i, H):
        (r1, i1), (r2, i2) = _eig2x2_planes(H[i, i], H[i, i + 1], H[i + 1, i], H[i + 1, i + 1])
        eig[:, i] = torch.stack([r1, i1])
        eig[:, i + 1] = torch.stack([r2, i2])

    if n == 2:  # solve analytically
        write2(0, H0)
        return eig, 0, True

    def deflate(H, hi):
        while hi > 2 and (small(H, hi - 1) or small(H, hi - 2)):
            if small(H, hi - 1):
                eig[0, hi - 1] = H[hi - 1, hi - 1]
                hi -= 1
            else:
                write2(hi - 2, H)
                hi -= 2
        return hi

    def find_lo(H, hi):
        """Top of the trailing unreduced block: the largest i < hi with a
        negligible subdiagonal H[i, i-1] (0 if none)."""
        sub = torch.abs(torch.diagonal(H, offset=-1))  # entry i-1 -> H[i, i-1]
        d = torch.abs(torch.diagonal(H))
        negligible = sub <= tol * torch.clamp(d[:-1] + d[1:], min=1.0)
        i = torch.arange(1, n, device=H.device)
        return int(torch.where(negligible & (i < hi), i, 0).max())

    H = H0
    hi, sweeps = deflate(H, n), 0
    while hi > 2 and sweeps < max_sweeps:
        H = _francis_sweep(H, find_lo(H, hi), hi)  # deflate guarantees hi - lo >= 3
        hi = deflate(H, hi)
        sweeps += 1
    # finish the trailing <=2 window analytically
    if hi == 1:
        eig[0, 0] = H[0, 0]
    elif hi == 2:
        write2(0, H)
    return eig, sweeps, hi <= 2


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

# The largest n at which the accelerated sweeps run unblocked (B8); beyond it
# they run blocked (B13). chip_smoke.py's boundary sweep (phase 13) on an
# NVIDIA H100 80GB HBM3 at 700 W (complex64, PERF.md section 6), with B8 as
# one block and B13 as one cooperative launch: B8 ahead in every measure at
# 128 (per full-window sweep, whole solves of the bench and of a
# non-symmetric operand: 0.0853 against 0.1266 ms a sweep, 1.990 against
# 3.103 ms and 8.093 against 11.379 ms a solve); at 256 B13 ahead a sweep
# (0.1518 against 0.1814 ms) and on the non-symmetric solve (35.334 against
# 45.375 ms), level on the bench operand (3.113 against 3.090 ms); B13 ahead
# in every measure from 512 on.
UNBLOCKED_MAX_N: int | None = 128


def qr_dispatch(n: int, device) -> str:
    """Which engine a QR eigenvalue solve of an n x n matrix uses:
    ``"torch"`` for a CPU tensor (the JAX package's CPU route);
    ``"cuda_unblocked"`` for a CUDA tensor with ``n <= UNBLOCKED_MAX_N``
    (accelerated sweeps B8) and ``"cuda_blocked"`` beyond it (accelerated
    sweeps B13), of any dtype. Parity mode runs B10 on either CUDA engine:
    the JAX package has no blocked parity kernel. The Hessenberg reduction
    before the sweeps is B11 from ``HESSENBERG_BLOCKED_MIN_N`` on and B7
    below it (``solvers/hessenberg.py``)."""
    if torch.device(device).type == "cpu":
        return "torch"
    if UNBLOCKED_MAX_N is None or n <= UNBLOCKED_MAX_N:
        return "cuda_unblocked"
    return "cuda_blocked"


@spanned
def qr_eigenvalues(M: AbstractMatrix, opts: SolverOptions = QROptions(), *,
                   dtype=None) -> QRResult:
    """All eigenvalues of a dense square matrix via QR iteration, where the
    matrix lies.

    Dense-only like the reference (qr_eigenvalues.hpp:131-133); ``dtype``
    asserts the stored scalar type (TypeError on mismatch, :135-138). Plain
    ``SolverOptions`` select parity mode. Accelerated mode returns complex
    eigenvalues; parity mode keeps the input's dtype. With
    ``QROptions(mode="accelerated", compute_vectors=True)`` the result also
    carries ``eigenvectors`` (n x n, complex, unit columns; column k pairs
    with ``eigenvalues[k]``): on a CUDA tensor from B7 or B11, B8 or B13 and
    B14 at every n and dtype, on a CPU tensor from the JAX package's CPU route.
    """
    from ..ops.qr_eig_blocked import blocked_eigenvalues
    from ..ops.qr_kernels import (accelerated_eigenpairs, accelerated_eigenvalues,
                                  parity_eigenvalues)
    if not M.is_dense:
        raise ValueError("qr_eigenvalues: only dense matrices are supported")
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "qr_eigenvalues")
    if M.shape[0] != M.shape[1]:
        raise ValueError("qr_eigenvalues_dense: A must be square")

    mode = opts.mode if isinstance(opts, QROptions) else "parity"
    n = M.shape[0]
    a = M.as_dense()
    max_it = opts.max_iterations
    dtol = opts.deflation_tolerance if isinstance(opts, QROptions) and \
        opts.deflation_tolerance is not None else opts.tolerance
    engine = qr_dispatch(n, a.device)

    if mode == "accelerated" and opts.compute_vectors and n > 0:
        if engine == "torch":
            return _qr_eigenvectors_xla(a, max_it, dtol)
        if engine == "cuda_blocked":
            eigs, sweeps, conv, V = blocked_eigenvalues(a, max_it, dtol, compute_vectors=True)
        else:
            eigs, sweeps, conv, V = accelerated_eigenpairs(a, max_it, dtol)
        res = _result(eigs, sweeps, conv)
        res.eigenvectors = V
        return res

    if engine != "torch":
        if n == 0:
            empty_dt = a.dtype if mode == "parity" else complex_dtype_of(a.dtype)
            return _result(torch.zeros((0,), dtype=empty_dt, device=a.device), 0, True)
        if mode == "parity":
            eigs, iterations, conv, _ = parity_eigenvalues(a, max_it, opts.tolerance)
            return _result(eigs, iterations, conv)
        if engine == "cuda_blocked":
            eigs, sweeps, conv = blocked_eigenvalues(a, max_it, dtol)
        else:
            eigs, sweeps, conv = accelerated_eigenvalues(a, max_it, dtol)
        return _result(eigs, sweeps, conv)

    if mode == "parity":
        return _qr_eigenvalues_parity(a, max_it, opts.tolerance)
    if not a.is_complex():
        # real input: real-arithmetic Francis iteration; complex conjugate
        # pairs come out of analytic 2x2 deflation
        planes, sweeps, converged = _qr_eigenvalues_accel_real(hessenberg_dense(a), max_it, dtol)
        return _result(torch.complex(planes[0], planes[1]), sweeps, converged)
    return _qr_eigenvalues_accel(hessenberg_dense(a), max_it, dtol)
