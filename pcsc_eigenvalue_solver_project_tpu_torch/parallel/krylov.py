"""Krylov solvers with injected reductions: BiCGStab and restarted GMRES.

The port of the generic solvers of the JAX package's ``parallel/krylov.py``.
They take ``vdot`` and ``norm`` as arguments, so that a distributed caller
can pass reductions over row shards; on one card the single-device solves
(``ops/krylov.py``, ``solvers/solve_shifted.py``,
``solvers/inverse_power.py``) pass ``solvers.power.vdot`` / ``norm``. The
SpMV inside ``matvec`` runs the operator's kernels (B1-B6).

The loops follow the port's idiom (``utils/loops.py``): BiCGStab's
iterations run in blocks of ``BICGSTAB_BLOCK`` with masked updates and
one host read of ``(k, done)`` a block; GMRES reads its flags once a
restart, a block of ``m`` Arnoldi steps. ``stop`` (a 0-d bool tensor, default False)
starts a solve as done: it then returns its start iterate at the cost of one
host read, which lets an outer loop that masks its own finished iterations
skip their inner solves.

``solve_shifted_distributed`` (JAX :145) is the shifted solve of the
distributed layer: Jacobi-preconditioned BiCGStab on row shards, with
reductions all-reduced over them (``parallel/sharded.py``).
"""

from __future__ import annotations

import torch

from ..core.dtypes import real_dtype_of
from ..utils.loops import count, flag, run_masked
from ..utils.timing import spanned

# BiCGStab iterations between two host reads: half the power loops' block
# (``utils.loops.BLOCK_ITERATIONS``). An inner solve often converges inside
# its first block, and each masked iteration after that still costs two
# SpMVs: BiCGStab inverse power on the 1M x 33 planted band (chip_smoke.py
# phase 20, H100) launched 160 SpMVs at 16 and 320 at 32.
BICGSTAB_BLOCK = 16


def _identity(v):
    return v


def bicgstab(matvec, b, *, vdot, norm, precond=None, tol=1e-12, atol=0.0, maxiter=None,
             x0=None, stop=None):
    """Preconditioned BiCGStab for ``A x = b`` with injectable reductions
    (JAX ``parallel/krylov.py:20``).

    Returns ``(x, residual_norm, iterations)``. On breakdown (rho or omega
    denominators vanish) the current iterate is returned: inverse iteration
    only needs the direction."""
    dtype, dev = b.dtype, b.device
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    M = precond if precond is not None else _identity
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    bnorm = norm(b)
    atol_eff = torch.clamp(tol * bnorm, min=atol)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def body(c):
        k, done, x, r, rhat, rho, alpha, omega, v, p = c
        rho_new = vdot(rhat, r)
        rho_breakdown = rho_new == 0
        beta = torch.where(rho_breakdown, zero,
                           (rho_new / torch.where(rho_breakdown, one, rho))
                           * (alpha / torch.where(omega == 0, one, omega)))
        p_new = r + beta * (p - omega * v)
        phat = M(p_new)
        v_new = matvec(phat)
        denom = vdot(rhat, v_new)
        alpha_breakdown = denom == 0
        alpha_new = torch.where(alpha_breakdown, zero,
                                rho_new / torch.where(alpha_breakdown, one, denom))
        h = x + alpha_new * phat
        s = r - alpha_new * v_new
        s_small = norm(s) <= atol_eff
        shat = M(s)
        t = matvec(shat)
        tt = vdot(t, t)
        omega_breakdown = tt == 0
        omega_new = torch.where(omega_breakdown, zero,
                                vdot(t, s) / torch.where(omega_breakdown, one, tt))
        x_new = torch.where(s_small, h, h + omega_new * shat)
        r_new = torch.where(s_small, s, s - omega_new * t)
        converged = s_small | (norm(r_new) <= atol_eff)
        stop_now = converged | rho_breakdown | alpha_breakdown | omega_breakdown
        live = ~done

        def keep(new, old):
            return torch.where(live, new, old)

        return (keep(k + 1, k), done | stop_now, keep(x_new, x), keep(r_new, r), rhat,
                keep(rho_new, rho), keep(alpha_new, alpha), keep(omega_new, omega),
                keep(v_new, v), keep(p_new, p))

    carry = (count(dev), flag(False if stop is None else stop, dev), x0, r0, r0, one, one, one,
             torch.zeros_like(b), torch.zeros_like(b))
    carry = run_masked(body, carry, maxiter, BICGSTAB_BLOCK, span="eigsol.bicgstab.block")
    return carry[2], norm(carry[3]), carry[0]


def gmres(matvec, b, *, vdot, norm, m=30, tol=1e-12, atol=0.0, max_restarts=None,
          precond=None, x0=None, stop=None):
    """Restarted GMRES(m) with injectable reductions (JAX
    ``parallel/krylov.py:86``), right-preconditioned.

    Each restart builds an m-step Arnoldi basis of ``A M``
    (``solvers/arnoldi.py::arnoldi_decomposition`` with the caller's
    ``vdot``/``norm``), solves the small least squares by QR (a library
    call, as JAX leaves it to XLA) and corrects. Returns ``(x,
    residual_norm, restarts)``."""
    from ..solvers.arnoldi import arnoldi_decomposition

    dtype, dev = b.dtype, b.device
    n = b.numel()
    if max_restarts is None:
        max_restarts = max(-(-4 * n // m), 8)
    M = precond if precond is not None else _identity

    def op(v):
        return matvec(M(v))

    bnorm = norm(b)
    atol_eff = torch.clamp(tol * bnorm, min=atol)
    x0 = torch.zeros_like(b) if x0 is None else x0
    one = torch.ones((), dtype=dtype, device=dev)

    def body(c):
        it, done, u, rnorm = c
        r = b - op(u)
        beta = norm(r).to(dtype)
        breakdown = beta == 0
        safe_r = torch.where(breakdown, torch.ones_like(r), r)
        V, H, _brk = arnoldi_decomposition(op, safe_r, m, vdot=vdot, norm=norm)
        e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        e1[0] = beta
        Q, R = torch.linalg.qr(H, mode="reduced")  # (m+1, m), (m, m)
        rhs = Q.conj().T @ e1
        diag_r = R.diagonal()
        safe = torch.where(diag_r == 0, one, diag_r)
        Rsafe = R - torch.diag(diag_r) + torch.diag(safe)
        y = torch.linalg.solve_triangular(Rsafe, rhs[:, None], upper=True)[:, 0]
        u_new = u + torch.tensordot(y, V[:m], dims=([0], [0]))
        rn = norm(b - op(u_new))
        conv = rn <= atol_eff
        live = ~done
        return (torch.where(live, it + 1, it), done | conv | breakdown,
                torch.where(live & ~breakdown, u_new, u), torch.where(live, rn, rnorm))

    carry = (count(dev), flag(False if stop is None else stop, dev), x0,
             norm(b - op(x0)).to(real_dtype_of(dtype)))
    it, _done, u, rnorm = run_masked(body, carry, max_restarts, 1, span="eigsol.gmres.block")
    return M(u), rnorm, it


@spanned
def solve_shifted_distributed(matvec, shift, b, *, vdot, norm, diag=None, tol=1e-12,
                              maxiter=None, stop=None):
    """Solve ``(A - shift I) y = b`` on row shards (JAX :145): BiCGStab with
    the Jacobi preconditioner ``1 / (diag - shift)`` (zero entries of
    ``diag - shift`` taken as 1) when ``diag`` (this rank's block of the
    diagonal) is given; ``stop`` as above."""
    shift = torch.as_tensor(shift, dtype=b.dtype, device=b.device)

    def shifted_mv(v):
        return matvec(v) - shift * v

    precond = None
    if diag is not None:
        d = diag - shift
        safe = torch.where(d == 0, torch.ones((), dtype=d.dtype, device=d.device), d)

        def precond(v):
            return v / safe

    x, _, _ = bicgstab(shifted_mv, b, vdot=vdot, norm=norm, precond=precond, tol=tol,
                       maxiter=maxiter, stop=stop)
    return x
