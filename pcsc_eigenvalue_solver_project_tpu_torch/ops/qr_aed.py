"""Aggressive early deflation (AED) for the blocked shifted QR sweeps.

Counterpart of the JAX package's ``ops/pallas/qr_aed.py``. The blocked
Wilkinson sweeps B13 (``ops/qr_eig_blocked.py``) deflate one eigenvalue
every ~2 sweeps from the bottom of the active window. An AED round
(Braman/Byers/Mathias) between batches of sweeps deflates in bulk:

1. the trailing ``w x w`` window ``W = H[s:hi, s:hi]`` (``s = hi - w``) is
   brought to Schur form ``W = V T V^H`` by the port's own route for an
   ``n = w`` solve: B8 with Q (``qr_eig_sweeps``) up to ``UNBLOCKED_MAX_N``,
   B13 in Schur mode (``blocked_sweeps``) beyond it, for at most ``40 w``
   sweeps;
2. the similarity ``diag(I, V)`` turns the window's Hessenberg edge
   ``beta = H[s, s-1]`` into the spike ``u = beta conj(V[0, :])``; each
   trailing window-converged row whose spike entry is negligible
   (``|u_j| <= tol max(|T_jj|, 1)``) deflates at once;
3. the ``kk`` rows left are returned to Hessenberg form: a Householder
   ``Z1`` collapses the surviving spike to ``alpha e_1``, B7 with Q
   (``hessenberg_reduce``) re-reduces the leading ``kk x kk`` block of
   ``Z1^H T Z1``, and the window block (``Z^H T Z`` under an exact
   Hessenberg mask), the spike, the column strip ``H[:, s:hi] V Z`` (and in
   Schur mode the row strip ``(V Z)^H H[s:hi, :]`` and Q's column strip) are
   written back;
4. the bottom-most undeflated Ritz values ``T[kk-1-j, kk-1-j]``, at most
   ``MAX_SHIFTS``, become the shift schedule of the next batch of sweeps
   (``qr_eig_blocked_step`` / ``qr_eig_blocked_step_q``).

The strip and window products are plain ``torch.matmul``, as the JAX
package leaves them to XLA (``jnp.dot``, :53-69); everything else runs in the
kernels it calls, or in their plain versions on a CPU tensor. The matrices
are native complex64 or complex128 ``(n, n)`` tensors; the device-resident
``lax.while_loop`` of the deep phase is a host loop that reads ``kk`` and
``hi`` once a round.

Not ported, as TPU-only: the planes, ``pad_for_blocked`` and
``pad_q_identity`` (the blocked layout), the (2, 1, 128) lane packing of the
shifts, ``_aed_sweep_round2`` (no caller), the real-embedding route for
complex input (``_complex_via_real_embedding``, ``_conj_pair_reps``,
``_COMPLEX_BLOCKED_MAX_N``: a TPU compiler fault; B12 reduces complex data
at any n) and the per-round path at ``np_ >= 16384`` (a TPU worker crash).
"""

from __future__ import annotations

from functools import partial

import torch

from ..utils.timing import annotate, host_read
from ._common import abs2, eye
from .qr_eig_blocked import blocked_sweeps, qr_eig_blocked_step, qr_eig_blocked_step_q

# The bottom-most undeflated Ritz values one round hands to the sweeps
# (JAX's 128 lanes, :171-177): the same cap keeps the sweep counts of the
# two packages comparable.
MAX_SHIFTS = 128
# The smallest window the AED drivers shrink to while the active block narrows
# (JAX :329-331).
MIN_WINDOW = 64
# The defaults of the window and of the sweeps between two rounds, by the
# rule of chip_smoke.py --aed-table at 2048 on the H100 (PERF.md): the least
# time over the non-symmetric operand and two uniform-[1, 2] operands among
# the settings that cut the non-symmetric solve's sweeps and keep those of
# the uniform-[1, 2] solves at most 0.85 n (the sweep cut of fewer than n,
# with room for another draw). w = 128 and 16 sweeps a round: 1.306 s on the
# non-symmetric operand (plain B13 1.548 s), 1655-1676 sweeps on the
# uniform-[1, 2] ones. JAX's w = 256 and 96 were tuned against a TPU's
# dispatch cost; w = 64 and 16 is faster but took 2042 sweeps on one
# uniform-[1, 2] draw. A round is then B8 and B7 with Q on the window.
WINDOW = 128
SWEEPS_PER_ROUND = 16

# What the last AED driver call did (the smoke and the tests read it): AED
# rounds run and eigenvalues deflated by them.
last_run = {}


def _window_schur(W: torch.Tensor, max_sweeps: int, tol: float):
    """``(hi_w, T, V)`` with ``W = V T V^H``: the port's route for an
    ``n = w`` solve (``qr_dispatch``'s boundary), B8 with Q up to
    ``UNBLOCKED_MAX_N`` and B13 in Schur mode beyond it; the plain versions
    on a CPU tensor."""
    from ..solvers.qr_eigenvalues import UNBLOCKED_MAX_N
    from .qr_kernels import qr_eig_sweeps
    w = W.shape[0]
    if UNBLOCKED_MAX_N is None or w <= UNBLOCKED_MAX_N:
        _eig, _sw, hi_w, T, V = qr_eig_sweeps(W, max_sweeps, tol, accumulate_q=True)
    else:
        _eig, _sw, hi_w, T, V = blocked_sweeps(W, max_sweeps, tol, accumulate_q=True)
    return hi_w, T, V


def aed_round(h: torch.Tensor, hi: int, tol: float, w: int, q: torch.Tensor | None = None):
    """One AED round on the complex Hessenberg ``h`` with active rows
    ``[0, hi)`` (counterpart of ``_aed_round_core``, JAX :72, and of
    ``_aed_round``, :185). Needs ``hi >= w + 2``, so that the window's spike
    column ``s - 1`` exists.

    Returns ``(h', d, hi_w, shifts)``, with ``q'`` after ``h'`` in Schur mode
    (``q`` given): ``d`` eigenvalues deflated, ``hi_w`` the window solve's
    active size (<= 1: the window's Schur form converged), ``shifts`` the
    schedule (1-D, the bottom-most undeflated Ritz values first; empty when
    the whole window deflated, which the sweeps read as Wilkinson shifts).
    In Schur mode ``q h q^H = q' h' q'^H``; without it the columns at and
    beyond ``hi`` are stale, as the eigenvalues-only sweeps leave them."""
    n = h.shape[0]
    if not w + 2 <= hi <= n:
        raise ValueError(f"aed_round: hi {hi} outside [w + 2, n] = [{w + 2}, {n}]")
    s = hi - w
    rdt = h.real.dtype
    idx = torch.arange(w, device=h.device)
    one = torch.ones((), dtype=rdt, device=h.device)
    tol_t = torch.tensor(tol, dtype=rdt, device=h.device)

    # 1. the window's Schur form W = V T V^H
    hi_w, T, V = _window_schur(h[s:hi, s:hi].contiguous(), 40 * w, tol)

    # 2. the spike u = beta conj(V[0, :]) and the deflations d: only
    # window-converged rows (idx >= hi_w) deflate
    u = h[s, s - 1] * V[0].conj()
    tdiag = T.diagonal()
    ok = (abs2(u).sqrt() <= tol_t * torch.maximum(abs2(tdiag).sqrt(), one)) & (idx >= hi_w)
    d_t = torch.cumprod(ok.flip(0).to(torch.int32), 0).sum()
    d = host_read(d_t)  # the round's host read: kk sizes the re-reduction
    kk = w - d

    # 3a. the Householder Z1 = I - f v v^H collapsing the kept spike to alpha e1
    um = torch.where(idx < kk, u, 0)
    nrm = abs2(um).sum().sqrt()
    m0 = abs2(um[0]).sqrt()
    has0 = m0 > 0
    sign = torch.where(has0, um[0] / torch.where(has0, m0, one), 1)
    alpha = -sign * nrm
    v = um - alpha * (idx == 0)
    vn2 = abs2(v).sum()
    degenerate = vn2 == 0
    f = torch.where(degenerate, 0.0, 2.0 / torch.where(degenerate, one, vn2))
    Z1 = eye(w, h) - f * torch.outer(v, v.conj())

    # 3b. re-reduce the kept block B1 = Z1^H T_mask Z1 (B7 with Q), Z2 = diag(Z2k, I)
    keep = (idx < kk).to(rdt)
    B1 = Z1.conj().T @ ((T * torch.outer(keep, keep)) @ Z1)
    Z2 = eye(w, h)
    if kk > 2:
        from .qr_kernels import hessenberg_reduce
        _hb, Z2k = hessenberg_reduce(B1[:kk, :kk].contiguous(), accumulate_q=True)
        Z2[:kk, :kk] = Z2k

    # 3c. Z = Z1 Z2, the window Z^H T Z under the exact Hessenberg mask
    Z = Z1 @ Z2
    Wnew = Z.conj().T @ (T @ Z)
    Wnew = torch.where(idx[:, None] <= idx[None, :] + 1, Wnew, 0)
    VZ = V @ Z

    # 4. write back: (Schur mode) the row strip by (VZ)^H over all columns,
    # the column strip by VZ over all rows, the window, the spike, Q's strip
    h = h.clone()
    if q is not None:
        h[s:hi, :] = VZ.conj().T @ h[s:hi, :]
    h[:, s:hi] = h[:, s:hi] @ VZ
    h[s:hi, s:hi] = Wnew
    h[s:hi, s - 1] = alpha * (idx == 0)
    if q is not None:
        q = q.clone()
        q[:, s:hi] = q[:, s:hi] @ VZ

    # the schedule: T[kk-1-j, kk-1-j] for j < min(kk, MAX_SHIFTS)
    shifts = tdiag[max(kk - MAX_SHIFTS, 0):kk].flip(0)
    if q is not None:
        return h, q, d, hi_w, shifts
    return h, d, hi_w, shifts


def aed_sweep_round(h, hi, budget, tol, w, q=None):
    """One AED round, then up to ``budget`` sweeps cycling its Ritz values
    (counterpart of ``_aed_sweep_round``, JAX :207, and of
    ``_aed_sweep_round_q``, :193). Returns ``(h', eig, sweeps, hi', d, hi_w)``,
    with ``q'`` after ``h'`` in Schur mode; ``sweeps`` and ``hi'`` as ints."""
    with annotate("eigsol.qr.aed_round"):
        if q is None:
            h, d, hi_w, shifts = aed_round(h, hi, tol, w)
            h, eig, sweeps, hi2 = qr_eig_blocked_step(h, budget, tol, shifts)
        else:
            h, q, d, hi_w, shifts = aed_round(h, hi, tol, w, q)
            h, q, eig, sweeps, hi2 = qr_eig_blocked_step_q(h, q, budget, tol, shifts)
        sweeps, hi2 = _ints(sweeps, hi2)
    out = (h, eig, sweeps, hi2, d, hi_w)
    return out if q is None else (out[0], q) + out[1:]


def _deep_phase(h, q, hi, budget, max_total, max_rounds, tol, w):
    """Rounds of AED and a sweep batch while ``hi >= w + 2`` (counterpart of
    ``_aed_deep_phase``, JAX :262, and ``_aed_deep_phase_q``, :471): a host
    loop that reads ``kk`` and ``hi`` once a round. Returns ``(h', q', sweeps,
    hi', rounds, deflated)``."""
    total = rounds = deflated = 0
    while hi >= w + 2 and total < max_total and rounds < max_rounds:
        b = min(budget, max_total - total)
        out = aed_sweep_round(h, hi, b, tol, w, q)
        if q is None:
            h, _eig, sweeps, hi, d, _hw = out
        else:
            h, q, _eig, sweeps, hi, d, _hw = out
        total += sweeps
        rounds += 1
        deflated += d
    return h, q, total, hi, rounds, deflated


def _driver(h, q, max_sweeps, tol, w, sweeps_per_round):
    """The control flow of ``qr_eig_blocked_aed_planes`` (JAX :298) and of
    ``qr_eig_blocked_aed_schur_planes`` (:502): a Wilkinson warm-up, deep
    phases with w halved down to ``MIN_WINDOW`` while ``hi < w + 2``, plain
    Wilkinson sweeps for the remainder, and the no-progress break."""
    def run_step(h, q, k):  # k Wilkinson sweeps
        if q is None:
            h, _eig, sweeps, hi = qr_eig_blocked_step(h, k, tol)
        else:
            h, q, _eig, sweeps, hi = qr_eig_blocked_step_q(h, q, k, tol)
        return (h, q) + _ints(sweeps, hi)

    h, q, total, hi = run_step(h, q, min(sweeps_per_round, max_sweeps))  # warm-up
    rounds = deflated = 0
    while hi > 1 and total < max_sweeps:
        w_eff = w
        while w_eff > MIN_WINDOW and hi < w_eff + 2:
            w_eff //= 2
        if hi < w_eff + 2:  # the small remainder: plain Wilkinson sweeps
            h, q, sweeps, hi = run_step(h, q, max_sweeps - total)
            total += sweeps
            break
        budget = min(sweeps_per_round, max_sweeps - total)
        remaining = max_sweeps - total
        max_rounds = remaining // max(budget, 1) + 8
        h, q, sweeps, new_hi, r, dd = _deep_phase(h, q, hi, budget, remaining, max_rounds,
                                                  tol, w_eff)
        total += sweeps
        rounds += r
        deflated += dd
        if new_hi == hi and sweeps == 0:
            break  # no progress possible
        hi = new_hi
    last_run.update(rounds=rounds, deflated=deflated)
    return h, q, total, hi


def _ints(sweeps, hi):
    """A step's ``(sweeps, hi)`` on the host, in one read."""
    return tuple(host_read(torch.stack([sweeps.to(torch.int64), hi.to(torch.int64)])))


def _check_hessenberg(name, h):
    if h.ndim != 2 or h.shape[0] != h.shape[1] or not h.is_complex():
        raise ValueError(f"{name}: expected a complex square Hessenberg matrix, "
                         f"got {tuple(h.shape)} {h.dtype}")


def qr_eig_blocked_aed(h: torch.Tensor, max_sweeps: int, tol: float, *, w: int = WINDOW,
                       sweeps_per_round: int = SWEEPS_PER_ROUND):
    """All eigenvalues of a complex Hessenberg ``h`` by the blocked sweeps
    and AED rounds (counterpart of ``qr_eig_blocked_aed_planes``). Returns
    ``(eigenvalues, sweeps, hi)``, converged when ``hi <= 1``; ``sweeps``
    counts Givens sweeps only (the rounds deflate without sweeping)."""
    _check_hessenberg("qr_eig_blocked_aed", h)
    h, _, total, hi = _driver(h, None, int(max_sweeps), tol, int(w), int(sweeps_per_round))
    return h.diagonal().clone(), total, hi


def qr_eig_blocked_aed_schur(h: torch.Tensor, max_sweeps: int, tol: float, *,
                             w: int = WINDOW, sweeps_per_round: int = SWEEPS_PER_ROUND):
    """The Schur-mode AED driver (counterpart of
    ``qr_eig_blocked_aed_schur_planes``): every round and sweep batch keeps
    ``h = Q T Q^H`` of the input. Returns ``(eigenvalues, sweeps, hi, T, Q)``."""
    _check_hessenberg("qr_eig_blocked_aed_schur", h)
    t, q, total, hi = _driver(h, eye(h.shape[0], h), int(max_sweeps), tol, int(w),
                              int(sweeps_per_round))
    return t.diagonal().clone(), total, hi, t, q


def qr_eigenvalues_blocked_aed(a: torch.Tensor, max_sweeps: int, tol: float, *,
                               w: int = WINDOW, sweeps_per_round: int = SWEEPS_PER_ROUND):
    """All eigenvalues of a square matrix by AED (counterpart of
    ``qr_eigenvalues_pallas_blocked_aed``, JAX :557): ``accelerated_eigenvalues``
    with ``qr_eig_blocked_aed`` as its sweeps, so ``hessenberg_reduce`` (B11
    from ``HESSENBERG_BLOCKED_MIN_N`` on, B7 below) and the widening of real
    input to the complex dtype of its precision come first. Returns
    ``(eigenvalues, sweeps, converged)``."""
    from .qr_kernels import accelerated_eigenvalues
    return accelerated_eigenvalues(a, max_sweeps, tol, partial(
        qr_eig_blocked_aed, w=w, sweeps_per_round=sweeps_per_round))
