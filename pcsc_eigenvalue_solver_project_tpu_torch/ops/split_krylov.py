"""Split-plane complex Krylov solvers: BiCGStab and restarted GMRES on
``(2, ...)`` real planes (the port of the JAX package's
``ops/split_krylov.py``).

The reference's complex shifted solve is ``Eigen::SparseLU`` over
``std::complex`` (reference src/matrix/solve_shifted.hpp:96-115). The
split-plane operators (``SplitComplexDIA``, ``InterleavedSplitComplexDIA``)
keep their vectors as re/im planes, so their inverse iteration solves in
planes too: every scalar (rho, alpha, omega) is a (2,) plane pair and every
vector a (2, ...) plane tensor, and the SpMV is the planes kernel (B3's
planes entry, B4). Vectors may carry more than one trailing axis (the
interleaved (2, R, 128) layout): the reductions run over all of them.

The loops follow the port's idiom (``utils/loops.py``): BiCGStab in blocks
of ``parallel.krylov.BICGSTAB_BLOCK`` with masked updates, GMRES one host
read a restart; ``stop`` as in ``parallel/krylov.py``.

Not ported: ``splitc_gmres_unrolled`` (:274), the ``unroll`` choice of
``solve_shifted_splitc_gmres`` (:399-433) and ``splitc_gmres``'s
``ls="householder"`` with ``_real_ls_householder`` (:241), which exist for a
TPU remote-compiler fault in the QR lowering; the port takes JAX's CPU
route, the least squares by QR, on every device.
"""

from __future__ import annotations

import torch

from ..parallel.krylov import BICGSTAB_BLOCK
from ..utils.loops import count, flag, run_masked
from .split_complex import splitc_mul, splitc_norm, splitc_vdot


def splitc_dotu(a, b):
    """The UNCONJUGATED bilinear form sum(a * b) over trailing axes: the
    classical choice for complex BiCG-family rho/alpha (the conjugated form
    loses the biorthogonality that drives convergence)."""
    re = torch.sum(a[0] * b[0] - a[1] * b[1])
    im = torch.sum(a[0] * b[1] + a[1] * b[0])
    return torch.stack([re, im])


def _sx(s, v):
    """A (2,) plane scalar shaped to broadcast over the vector axes of v."""
    return s.reshape((2,) + (1,) * (v.ndim - 1))


def splitc_div(a, b):
    """Elementwise complex division of plane tensors, zero-safe (b == 0
    positions divide by 1; callers mask)."""
    denom = b[0] * b[0] + b[1] * b[1]
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    re = (a[0] * b[0] + a[1] * b[1]) / safe
    im = (a[1] * b[0] - a[0] * b[1]) / safe
    return torch.stack([re, im])


def _jacobi_planes(diag, shift):
    """The Jacobi plane preconditioner of ``A - shift I`` from its diagonal
    planes (zero entries replaced by 1)."""
    d = diag - _sx(shift, diag)
    dd = d[0] * d[0] + d[1] * d[1]
    one_plane = torch.stack([torch.ones_like(d[0]), torch.zeros_like(d[1])])
    d = torch.where(dd[None] == 0, one_plane, d)
    return lambda v: splitc_div(v, d)


def _shifted(matvec, shift):
    def shifted_mv(v):
        return matvec(v) - splitc_mul(_sx(shift, v), v)
    return shifted_mv


def splitc_bicgstab(matvec, b, *, precond=None, tol=1e-10, maxiter=200, stop=None):
    """Solve ``A x = b`` in split-plane form (JAX :48), left-preconditioned.
    Returns the final iterate, converged or not. Breakdown (zero
    denominators, a non-finite residual) freezes the iterate and exits."""
    K = precond if precond is not None else (lambda v: v)
    rdt, dev = b.dtype, b.device
    b_p = K(b)
    bnorm = torch.sqrt(torch.sum(b_p * b_p))
    atol = tol * torch.where(bnorm == 0, torch.ones((), dtype=rdt, device=dev), bnorm)
    one = torch.tensor([1.0, 0.0], dtype=rdt, device=dev)

    def body(c):
        k, done, x, r, rhat, p, v, rho, alpha, omega = c
        rho_new = splitc_dotu(rhat, r)
        beta = splitc_mul(splitc_div(rho_new, rho), splitc_div(alpha, omega))
        brk = torch.all(rho == 0) | torch.all(omega == 0)
        p_new = r + splitc_mul(_sx(beta, p), p - splitc_mul(_sx(omega, v), v))
        v_new = K(matvec(p_new))
        rv = splitc_dotu(rhat, v_new)
        alpha_new = splitc_div(rho_new, rv)
        brk = brk | torch.all(rv == 0)
        s = r - splitc_mul(_sx(alpha_new, v_new), v_new)
        t = K(matvec(s))
        tt = splitc_vdot(t, t)
        omega_new = splitc_div(splitc_vdot(t, s), tt)
        brk = brk | torch.all(tt == 0)
        x_new = x + splitc_mul(_sx(alpha_new, p_new), p_new) + splitc_mul(_sx(omega_new, s), s)
        r_new = s - splitc_mul(_sx(omega_new, t), t)
        rnorm = torch.sqrt(torch.sum(r_new * r_new))
        hold = brk | ~torch.isfinite(rnorm)
        take = ~done & ~hold

        def keep(new, old):
            return torch.where(take, new, old)

        return (torch.where(done, k, k + 1), done | (rnorm <= atol) | hold, keep(x_new, x),
                keep(r_new, r), rhat, keep(p_new, p), keep(v_new, v), keep(rho_new, rho),
                keep(alpha_new, alpha), keep(omega_new, omega))

    carry = (count(dev), flag(False if stop is None else stop, dev), torch.zeros_like(b), b_p,
             b_p, torch.zeros_like(b), torch.zeros_like(b), one, one, one)
    return run_masked(body, carry, maxiter, BICGSTAB_BLOCK, span="eigsol.bicgstab.block")[2]


def solve_shifted_splitc(matvec, shift, b, *, diag=None, tol=1e-10, maxiter=200, stop=None):
    """Solve ``(A - shift*I) y = b`` in planes (JAX :110): ``shift`` a (2,)
    plane scalar, ``diag`` the diagonal planes for Jacobi preconditioning."""
    precond = _jacobi_planes(diag, shift) if diag is not None else None
    return splitc_bicgstab(_shifted(matvec, shift), b, precond=precond, tol=tol,
                           maxiter=maxiter, stop=stop)


def _qr_ls(G, rhs):
    """The least squares ``G y = rhs`` by QR (JAX's CPU route): singular
    columns of R give 0 in their coordinate."""
    Q, R = torch.linalg.qr(G, mode="reduced")
    qtr = Q.T @ rhs
    sing = R.diagonal().abs() == 0
    R_safe = R + torch.diag(sing.to(R.dtype))
    y = torch.linalg.solve_triangular(R_safe, qtr[:, None], upper=True)[:, 0]
    return torch.where(sing, 0, y)


def splitc_gmres(matvec, b, *, precond=None, tol=1e-10, m=30, max_restarts=None, stop=None):
    """Restarted GMRES(m) in split-plane form (JAX :130): the Arnoldi
    basis by CGS2 (classical Gram-Schmidt with one re-orthogonalisation
    pass), held as complex vectors between the plane products of the
    operator, and the (m+1, m) complex Hessenberg least
    squares is solved as the real 2(m+1) x 2m block system by QR. Left
    Jacobi preconditioning as ``splitc_bicgstab``. Returns the final
    iterate."""
    K = precond if precond is not None else (lambda v: v)
    rdt, dev = b.dtype, b.device
    cdt = rdt.to_complex()
    shape = b.shape
    N = b[0].numel()
    if max_restarts is None:
        max_restarts = max(-(-4 * shape[-1] // m), 8)

    def op(v):
        return K(matvec(v))

    b_p = K(b)
    bnorm = splitc_norm(b_p)
    atol = tol * torch.where(bnorm == 0, torch.ones((), dtype=rdt, device=dev), bnorm)

    def planes(z):  # a complex (N,) vector as plane tensors of b's shape
        return torch.stack([z.real, z.imag]).reshape(shape)

    def arnoldi(r, beta):
        # The basis is held as complex vectors: CGS2 on the plane pairs is
        # complex CGS2 (h = V^H w, w -= V h, twice), and over the j + 1
        # vectors built so far (JAX masks the zero rows beyond them).
        V = torch.zeros((m + 1, N), dtype=cdt, device=dev)
        safe_b = torch.where(beta == 0, torch.ones((), dtype=rdt, device=dev), beta)
        rf = r.reshape(2, N)
        V[0] = torch.complex(rf[0], rf[1]) / safe_b
        H = torch.zeros((m + 1, m), dtype=cdt, device=dev)
        for j in range(m):
            wf = op(planes(V[j])).reshape(2, N)
            w = torch.complex(wf[0], wf[1])
            Vj = V[:j + 1]
            h = Vj.conj() @ w
            w = w - h @ Vj
            c = Vj.conj() @ w
            w = w - c @ Vj
            nrm = torch.linalg.vector_norm(w)
            brk = nrm == 0
            V[j + 1] = w * torch.where(brk, 0.0, 1.0 / torch.where(brk, 1.0, nrm))
            H[:j + 1, j] = h + c
            H[j + 1, j] = nrm
        return V, H

    def body(c):
        it, done, x, rnorm = c
        r = b_p - op(x)
        beta = splitc_norm(r)
        V, H = arnoldi(r, beta)
        Hr, Hi = H.real, H.imag
        G = torch.cat([torch.cat([Hr, -Hi], 1), torch.cat([Hi, Hr], 1)], 0)  # (2(m+1), 2m)
        rhs = torch.zeros(2 * (m + 1), dtype=rdt, device=dev)
        rhs[0] = beta
        y = _qr_ls(G, rhs)
        x_new = x + planes(torch.complex(y[:m], y[m:]) @ V[:m])
        rn = splitc_norm(b_p - op(x_new))
        bad = ~torch.isfinite(rn)
        live = ~done
        return (torch.where(live, it + 1, it), done | bad | (rn <= atol),
                torch.where(live & ~bad, x_new, x), torch.where(live, rn, rnorm))

    carry = (count(dev), flag(bnorm <= atol, dev) | flag(False if stop is None else stop, dev),
             torch.zeros_like(b), bnorm)
    return run_masked(body, carry, max_restarts, 1, span="eigsol.gmres.block")[2]


def solve_shifted_splitc_gmres(matvec, shift, b, *, diag=None, tol=1e-10, m=30,
                               max_restarts=None, stop=None):
    """The GMRES form of ``solve_shifted_splitc`` (JAX :399): the same
    shifted operator and Jacobi plane preconditioner, restarted GMRES with
    the QR least squares."""
    precond = _jacobi_planes(diag, shift) if diag is not None else None
    return splitc_gmres(_shifted(matvec, shift), b, precond=precond, tol=tol, m=m,
                        max_restarts=max_restarts, stop=stop)
