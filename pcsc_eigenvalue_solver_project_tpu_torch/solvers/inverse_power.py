"""Shifted inverse power iteration: the eigenvalue nearest the shift (the
port of the JAX package's ``solvers/inverse_power.py``).

Reference parity (reference src/power_method/
shifted_inverse_power_solver.hpp:21-125): each iteration solves
``(A - shift*I) y = x`` (:51), normalises, and takes the Rayleigh quotient
on A (:62); stopping, breakdown and iteration-count semantics match the
power method. The shift is fixed; ``rayleigh_quotient_iteration`` updates
it each step.

As in the JAX package, the dense path factorises ``A - shift*I`` once
(``torch.linalg.lu_factor_ex``, a library call where JAX calls XLA) and
back-substitutes each iteration; sparse systems up to
``DENSE_FALLBACK_MAX_N`` are densified, larger ones run Jacobi-preconditioned
BiCGStab or restarted GMRES on the SpMV kernels (B1-B6), and the split-plane
operators run the plane solvers of ``ops/split_krylov.py`` on B3's planes
entry and B4. A zero or non-finite ``||y||`` (a singular LU, a Krylov
breakdown) keeps the previous iterate and reports ``converged=False``.

The loops follow the port's idiom (``utils/loops.py``): the outer loop runs
in blocks of ``BLOCK_ITERATIONS`` with masked updates and one host read a
block; its finished iterations hand their inner Krylov solve ``stop=done``,
which then returns at once. The inner loops read their flags once a block
of ``parallel.krylov.BICGSTAB_BLOCK`` (BiCGStab) or once a restart (GMRES).
"""

from __future__ import annotations

import torch

from ..core.dtypes import check_scalar_type, real_dtype_of
from ..core.options import ShiftedSolverOptions
from ..core.results import EigenResult
from ..core.tolerance import is_close_relative
from ..matrix.protocol import AbstractMatrix, decode_result, require_nonempty, require_square
from ..ops.krylov import solve_shifted_bicgstab
from ..ops.split_complex import splitc_is_close_relative, splitc_norm, splitc_vdot
from ..utils.loops import count, flag, run_masked
from ..utils.prng import default_generator, random_unit_vector
from ..utils.timing import spanned
from .power import norm, vdot
from .solve_shifted import DENSE_FALLBACK_MAX_N, lu_factor, lu_solve, shifted_dense


def inverse_power_loop(matvec, solve, vdot, norm, x0: torch.Tensor, max_iterations: int, tol,
                       is_close=is_close_relative, lam0=None, rqi: bool = False,
                       shift0=None) -> EigenResult:
    """The generic shifted-inverse-power loop (JAX ``inverse_power_loop``,
    :44, and the loops of :154, :224 and :342). ``solve(x, done)`` returns
    ``(A - shift I)^-1 x``; with ``rqi`` it is ``solve(x, done, shift)`` and
    the shift becomes each iteration's Rayleigh quotient. ``lam0`` is the
    eigenvalue's initial carry (default a 0-d zero of x0's dtype; a (2,)
    plane for the split loops). ``tol`` is a float, decided in float64, or a
    0-d tensor, decided in its dtype."""
    dtype, dev = x0.dtype, x0.device
    rdt = real_dtype_of(dtype)
    if not isinstance(tol, torch.Tensor):
        tol = torch.tensor(tol, dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    lam0 = torch.zeros((), dtype=dtype, device=dev) if lam0 is None else lam0

    def body(c):
        k, done, x, lam, initialized, converged, used, shift = c
        y = solve(x, done, shift) if rqi else solve(x, done)  # (A - shift I) y = x (:51)
        norm_y = norm(y).to(rdt)
        # a non-finite solve (a singular LU, a Krylov breakdown) keeps the
        # previous iterate and reports converged=False
        breakdown = (norm_y == 0) | ~torch.isfinite(norm_y)
        x_new = y / torch.where(breakdown, one, norm_y).to(dtype)
        lam_new = vdot(x_new, matvec(x_new))  # Rayleigh quotient on A (:62)
        conv_now = initialized & is_close(lam_new, lam, tol) & ~breakdown
        live = ~done
        take = live & ~breakdown
        return (torch.where(live, k + 1, k), done | breakdown | conv_now,
                torch.where(take, x_new, x), torch.where(take, lam_new, lam),
                initialized | take, converged | (live & conv_now),
                torch.where(live, k + 1, used),
                torch.where(take, lam_new, shift) if rqi else shift)

    carry = (count(dev), flag(False, dev), x0, lam0, flag(False, dev), flag(False, dev),
             count(dev), shift0)
    k, done, x, lam, initialized, converged, used, shift = run_masked(
        body, carry, max_iterations, span="eigsol.inverse_power.block")
    return EigenResult(eigenvalue=lam, eigenvector=x, iterations=used, converged=converged)


def _inverse_power_dense(a, shift, x0, max_iterations, tol) -> EigenResult:
    """The dense path: ``A - shift I`` factorised once (JAX :94)."""
    lu, piv = lu_factor(shifted_dense(a, shift))
    return inverse_power_loop(lambda v: a @ v, lambda x, done: lu_solve(lu, piv, x), vdot,
                              norm, x0, max_iterations, tol)


def _inverse_power_krylov(M, shift, x0, max_iterations, tol, inner_tol, inner_maxiter):
    """BiCGStab inner solves (JAX :109), in the operator's vector domain: x0
    arrives encoded, and the diagonal is encoded to match."""
    diag = M.encode_vec(M.diagonal())

    def solve(x, done):
        return solve_shifted_bicgstab(M.matvec, shift, x, diag=diag, tol=inner_tol,
                                      maxiter=inner_maxiter, stop=done)

    return inverse_power_loop(M.matvec, solve, vdot, norm, x0, max_iterations, tol)


def _inverse_power_gmres(M, shift, x0, max_iterations, tol, inner_tol, inner_m):
    """Restarted-GMRES inner solves (JAX :127): more robust than BiCGStab on
    non-symmetric near-singular ``A - shift*I``; four restarts suffice for
    the direction."""
    from ..parallel.krylov import gmres
    d = M.encode_vec(M.diagonal()) - shift
    safe = torch.where(d == 0, torch.ones((), dtype=d.dtype, device=d.device), d)

    def solve(x, done):
        y, _, _ = gmres(lambda v: M.matvec(v) - shift * v, x, vdot=vdot, norm=norm, m=inner_m,
                        tol=inner_tol, max_restarts=4, precond=lambda v: v / safe, stop=done)
        return y

    return inverse_power_loop(M.matvec, solve, vdot, norm, x0, max_iterations, tol)


def _split_loop(matvec, solve, x0_p, max_iterations, tol):
    return inverse_power_loop(matvec, solve, splitc_vdot, splitc_norm, x0_p, max_iterations,
                              tol, splitc_is_close_relative,
                              torch.zeros(2, dtype=x0_p.dtype, device=x0_p.device))


def _inverse_power_splitc(M, shift_p, x0_p, max_iterations, tol, inner_tol, inner_maxiter,
                          inner_method="bicgstab"):
    """Split-plane inverse power with plane BiCGStab or GMRES inner solves
    (JAX :154)."""
    from ..ops.split_krylov import solve_shifted_splitc, solve_shifted_splitc_gmres
    diag = M.encode_vec(M.diagonal_planes().to(x0_p.dtype))
    if inner_method == "gmres":
        # Interior shifts make A - sigma I indefinite, and restarted GMRES
        # with a small basis stagnates there; the basis scales with n,
        # capped at 180 (JAX :171-180)
        n = M.shape[0]
        gm = max(2, min(max(30, n // 3), 180, n))
        restarts = max(-(-inner_maxiter // gm), 2)

        def solve(x, done):
            return solve_shifted_splitc_gmres(M.matvec, shift_p, x, diag=diag, tol=inner_tol,
                                              m=gm, max_restarts=restarts, stop=done)
    else:
        def solve(x, done):
            return solve_shifted_splitc(M.matvec, shift_p, x, diag=diag, tol=inner_tol,
                                        maxiter=inner_maxiter, stop=done)

    return _split_loop(M.matvec, solve, x0_p, max_iterations, tol)


def _inverse_power_splitc_dense(pl, shift_p, x0_p, max_iterations, tol):
    """The dense split-plane path (JAX :224): ``A - shift I`` as the real
    2n x 2n block system [[R, -I_m], [I_m, R]] of its re/im parts,
    LU-factorised once."""
    n = pl.shape[1]
    eye = torch.eye(n, dtype=pl.dtype, device=pl.device)
    Rr = pl[0] - shift_p[0] * eye
    Ri = pl[1] - shift_p[1] * eye
    lu, piv = lu_factor(torch.cat([torch.cat([Rr, -Ri], 1), torch.cat([Ri, Rr], 1)], 0))

    def solve(x, done):
        y = lu_solve(lu, piv, torch.cat([x[0], x[1]]))
        return torch.stack([y[:n], y[n:]])

    def matvec(x):
        return torch.stack([pl[0] @ x[0] - pl[1] @ x[1], pl[0] @ x[1] + pl[1] @ x[0]])

    return _split_loop(matvec, solve, x0_p, max_iterations, tol)


def shifted_inverse_power_split_complex(M, opts: ShiftedSolverOptions = ShiftedSolverOptions(),
                                        *, generator: torch.Generator | None = None,
                                        x0=None) -> EigenResult:
    """Eigenpair nearest ``opts.shift`` of a split-plane complex banded
    operator (``SplitComplexDIA`` / ``InterleavedSplitComplexDIA``; JAX
    :285). ``eigenvalue`` comes back as a (2,) plane scalar and
    ``eigenvector`` as (2, n) planes (``ops.split_complex.from_planes``).
    The planes iterate in ``promote(planes dtype, float32)``, as
    ``power_method_split_complex`` does; the stopping rule is decided in
    float64, as JAX decides it under x64."""
    from ..matrix.split_complex import SplitComplexDIA
    n = M.shape[0]
    if M.shape[0] != M.shape[1]:
        raise ValueError("shifted_inverse_power_method: matrix must be square")
    if n == 0:
        raise ValueError("shifted_inverse_power_method: matrix has zero size")
    rdt = torch.promote_types(M.dtype, torch.float32)
    x0 = _start_vector(M, rdt, generator, x0, n, planes=True)
    sh = complex(opts.shift)
    shift_p = torch.tensor([sh.real, sh.imag], dtype=rdt, device=M.device)
    max_it, tol = opts.max_iterations, opts.tolerance
    method = opts.inner_method
    if method == "auto":
        method = "dense_lu" if n <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        nat = M if isinstance(M, SplitComplexDIA) else M.to_natural()
        return _inverse_power_splitc_dense(nat.to_dense_planes().to(rdt), shift_p, x0, max_it,
                                           tol)
    if method not in ("bicgstab", "gmres"):
        raise ValueError(
            f"shifted_inverse_power_method: split-complex operators support "
            f"inner_method 'auto' | 'dense_lu' | 'bicgstab' | 'gmres', got {method!r}")
    inner_maxiter = opts.inner_max_iterations or 4 * n
    r = _inverse_power_splitc(M, shift_p, M.encode_vec(x0), max_it, tol, opts.inner_tolerance,
                              inner_maxiter, inner_method=method)
    return decode_result(M, r)


def _rqi_dense(a, shift0, x0, max_iterations, tol) -> EigenResult:
    """Rayleigh-quotient iteration on a dense matrix (JAX :342): a fresh LU
    each iteration at the moving shift."""
    def solve(x, done, shift):
        return lu_solve(*lu_factor(shifted_dense(a, shift)), x)

    return inverse_power_loop(lambda v: a @ v, solve, vdot, norm, x0, max_iterations, tol,
                              rqi=True, shift0=shift0)


def _start_vector(M, dtype, generator, x0, n, planes=False):
    """The unit start vector on M's device: ``x0`` normalised (a zero ``x0``
    kept), else a random one from ``generator``; with ``planes`` (2, n)
    re/im planes, uniform [-1, 1] each when random."""
    if x0 is None:
        gen = generator if generator is not None else default_generator(M.device)
        if not planes:
            return random_unit_vector(gen, n, dtype, device=M.device)
        x0 = torch.rand((2, n), generator=gen, dtype=dtype, device=gen.device) * 2 - 1
    x0 = torch.as_tensor(x0).to(device=M.device, dtype=dtype)
    if planes and x0.shape != (2, n):
        raise ValueError("shifted_inverse_power_split_complex: x0 must be (2, n) planes")
    nrm = norm(x0)
    return torch.where(nrm == 0, x0, x0 / torch.where(nrm == 0, 1, nrm).to(dtype))


@spanned
def rayleigh_quotient_iteration(M: AbstractMatrix,
                                opts: ShiftedSolverOptions = ShiftedSolverOptions(), *,
                                dtype=None, generator: torch.Generator | None = None,
                                x0=None) -> EigenResult:
    """Rayleigh-quotient iteration: the shift updates each step (JAX :385).

    Cubic local convergence at the price of a fresh factorisation each
    iteration. Dense operators, or sparse ones densified."""
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "rayleigh_quotient_iteration")
    require_square(M, "rayleigh_quotient_iteration")
    require_nonempty(M, "rayleigh_quotient_iteration")
    n = M.shape[0]
    x0 = _start_vector(M, M.dtype, generator, x0, n)
    a = M.as_dense() if M.is_dense else M.to_dense()
    return _rqi_dense(a, torch.tensor(opts.shift, dtype=M.dtype, device=M.device), x0,
                      opts.max_iterations, opts.tolerance)


@spanned
def shifted_inverse_power_method(M: AbstractMatrix,
                                 opts: ShiftedSolverOptions = ShiftedSolverOptions(), *,
                                 dtype=None, generator: torch.Generator | None = None,
                                 x0=None) -> EigenResult:
    """Eigenpair nearest ``opts.shift`` by shifted inverse iteration (JAX
    :416), on the device where the matrix lies. Split-plane operators go to
    ``shifted_inverse_power_split_complex``; bfloat16 operators iterate in
    float32. ``generator``/``x0`` control the start vector."""
    from ..matrix.split_complex import InterleavedSplitComplexDIA, SplitComplexDIA
    if isinstance(M, (SplitComplexDIA, InterleavedSplitComplexDIA)):
        return shifted_inverse_power_split_complex(M, opts, generator=generator, x0=x0)
    if dtype is not None:
        check_scalar_type(M.dtype, dtype, "shifted_inverse_power_method")
    require_square(M, "shifted_inverse_power_method")
    require_nonempty(M, "shifted_inverse_power_method")
    n = M.shape[0]
    vec_dt = torch.promote_types(M.dtype, torch.float32)  # bf16 operators iterate in f32
    x0 = _start_vector(M, vec_dt, generator, x0, n)
    shift = torch.tensor(opts.shift, dtype=vec_dt, device=M.device)
    max_it, tol = opts.max_iterations, opts.tolerance
    method = opts.inner_method
    if M.is_dense:
        return _inverse_power_dense(M.as_dense().to(vec_dt), shift, x0, max_it, tol)
    if method == "auto":
        method = "dense_lu" if n <= DENSE_FALLBACK_MAX_N else "bicgstab"
    if method == "dense_lu":
        return _inverse_power_dense(M.to_dense().to(vec_dt), shift, x0, max_it, tol)
    if method == "bicgstab":
        inner_maxiter = opts.inner_max_iterations or 4 * n
        r = _inverse_power_krylov(M, shift, M.encode_vec(x0), max_it, tol,
                                  opts.inner_tolerance, inner_maxiter)
        return decode_result(M, r)
    if method == "gmres":
        inner_m = min(opts.inner_max_iterations or 40, n)
        r = _inverse_power_gmres(M, shift, M.encode_vec(x0), max_it, tol,
                                 opts.inner_tolerance, inner_m)
        return decode_result(M, r)
    raise ValueError(f"shifted_inverse_power_method: unknown inner method {method!r}")
