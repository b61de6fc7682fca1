"""Blocked shifted Givens QR sweeps: the CUDA kernel B13 and its plain
version, the resumable steps and the blocked eigenvalue solve.

Counterpart of the JAX package's ``ops/pallas/qr_eig_blocked.py``. Each
sweep on the active window ``[lo, hi)`` of a complex Hessenberg ``H`` (B8's
iteration, ``ops/qr_kernels.py``):

- the shift ``mu``: Wilkinson's from the trailing active 2x2, or, given a
  schedule ``shifts``, ``shifts[s % len(shifts)]`` in sweep ``s`` of the call
  (the Ritz values of the AED rounds, JAX :218-225); ``H - mu I`` on the window;
- the left rotations k = lo .. hi-2 in blocks of ``block``: block i owns the
  rotations ``b = lo + i block .. e - 1`` with ``e = min(b + block, hi - 1)``;
  they are formed and applied on the window rows ``b .. e`` times columns
  ``max(b - 1, 0) .. e`` and accumulated into ``U_b`` ((e - b + 1) square,
  from I); then the slab, rows ``b .. e`` times columns ``e + 1 .. col_end``,
  becomes ``U_b @ slab`` (``col_end = hi`` for eigenvalues, ``n`` in Schur
  mode);
- the right pass block by block in order: rows ``0 .. min(e + 2, n)`` times
  columns ``b .. e`` become ``. @ U_b^H``, and in Schur mode ``Q``'s columns
  ``b .. e`` over all rows, so that ``H0 = Q T Q^H`` holds;
- ``+ mu I`` on the window, and the new ``hi`` and ``lo`` from the
  subdiagonal scan ``|H[c+1, c]| <= tol * max(|H[c,c]| + |H[c+1,c+1]|, 1)``.

Blocking changes the order of the arithmetic, not the algebra: at any block
size the sweeps are B8's to rounding. Eigenvalues-only mode updates no
column at or beyond ``hi``. Each call re-derives ``[lo, hi)`` from the
subdiagonal scan at entry, so calls can resume one another
(``qr_eig_blocked_step``, ``qr_eig_blocked_step_q``).

``qr_eig_blocked_kernel`` runs ``csrc/qr_eig_blocked.cu`` on a complex64 or
complex128 CUDA tensor and counts its launches in ``.launches``; the plain
version ``qr_eig_blocked_plain`` repeats its algebra in PyTorch with the block
size as a parameter. The dispatchers run the plain version for a CPU tensor
and the kernel otherwise (it launches or raises).

Not ported, as TPU layout or VMEM budgets: the window and chunk shapes
``_BS/_WR/_WC/_SC/_RC`` (JAX :46-50) and ``_rc_rows`` (:496), the scratch
(``_make_scratch``, :504), the 128-lane padding (``pad_for_blocked`` :629,
``pad_q_identity`` :593), the diagonal/sub/superdiagonal lane-vector caches
(:111-176) and the 8/128-aligned window anchoring.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (COMPLEX_CODES, check_square, deflate_and_lo, eye, givens, ptr,
                      raise_on_error, real_dtype, rotate_rows, stream, wilkinson_shift)

# Rotations per block. Shared memory bounds it: the window step keeps a
# (bs + 1) x (bs + 2) window and the (bs + 1)^2 U_b, 136 KB at 64 in complex128.
BLOCK = 32
MAX_BLOCK = 64  # kMaxBlock of csrc/qr_eig_blocked.cu
# The host reads B13's device-side state before each chunk of sweeps of about
# this many launches (3 per block and one per sweep). At 8192 the launches
# enqueued past convergence took most of a whole solve on the bench operand
# (54 ms against 2.6 ms for B8 at n = 128 on an H100; PERF.md).
BLOCKED_LAUNCHES_PER_READ = 1024


def _checked(name: str, max_sweeps: int, accumulate_q: bool, q, block: int):
    """``(max_sweeps, block)`` as ints, checked, and ``q`` only in Schur mode."""
    if not 1 <= int(block) <= MAX_BLOCK:
        raise ValueError(f"{name}: block {block} outside [1, {MAX_BLOCK}]")
    if not 0 <= max_sweeps < 2 ** 31:
        raise ValueError(f"{name}: max_sweeps {max_sweeps} out of int32 range")
    if q is not None and not accumulate_q:
        raise ValueError(f"{name}: a starting q needs accumulate_q=True")
    return int(max_sweeps), int(block)


def _schedule(shifts):
    """``shifts`` as a schedule, or None for Wilkinson shifts: an empty
    schedule (JAX ``n_shifts = 0``, sent by an AED round that deflated its
    whole window) means Wilkinson shifts, as in the Pallas kernel (:218-225)."""
    return None if shifts is None or shifts.shape[0] == 0 else shifts


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _sweeps_plain(h, max_sweeps, tol, shifts, accumulate_q, q, block):
    """The blocked sweeps in PyTorch: ``(eig, sweeps, hi, T, Q or None)``."""
    n = h.shape[0]
    shifts = _schedule(shifts)
    H = h.clone()
    Q = (q.clone() if q is not None else eye(n, h)) if accumulate_q else None
    tol_t = torch.tensor(tol, dtype=real_dtype(h.dtype), device=h.device)
    hi, lo = deflate_and_lo(H, n, tol_t)
    sweeps = 0
    while hi > 1 and sweeps < max_sweeps:
        if shifts is not None:
            mu = shifts[sweeps % shifts.shape[0]].to(h.dtype)
        else:
            mu = wilkinson_shift(H[hi - 2, hi - 2], H[hi - 2, hi - 1],
                                 H[hi - 1, hi - 2], H[hi - 1, hi - 1])
        win = torch.arange(lo, hi, device=h.device)
        H[win, win] -= mu
        col_end = n if accumulate_q else hi
        factors = []
        for b in range(lo, hi - 1, block):  # (a) window and (b) slab, block by block
            e = min(b + block, hi - 1)
            c0 = max(b - 1, 0)
            W = H[b:e + 1, c0:e + 1].clone()
            U = eye(e - b + 1, h)
            for r in range(e - b):  # rotation k = b + r on local rows r, r + 1
                g00, g01 = givens(W[r, b + r - c0], W[r + 1, b + r - c0])
                W[r], W[r + 1] = rotate_rows(g00, g01, W[r], W[r + 1])
                U[r], U[r + 1] = rotate_rows(g00, g01, U[r], U[r + 1])
            H[b:e + 1, c0:e + 1] = W
            H[b:e + 1, e + 1:col_end] = U @ H[b:e + 1, e + 1:col_end]
            factors.append((b, e, U.conj().T))
        for b, e, Uh in factors:  # (c) the right pass, in order
            rows = min(e + 2, n)
            H[:rows, b:e + 1] = H[:rows, b:e + 1] @ Uh
            if accumulate_q:
                Q[:, b:e + 1] = Q[:, b:e + 1] @ Uh
        H[win, win] += mu
        hi, lo = deflate_and_lo(H, hi, tol_t)  # (d)
        sweeps += 1
    return (H.diagonal().clone(), torch.tensor(sweeps, dtype=torch.int32),
            torch.tensor(hi, dtype=torch.int32), H, Q)


def qr_eig_blocked_plain(h: torch.Tensor, max_sweeps: int, tol: float, shifts=None,
                         accumulate_q: bool = False, q=None, block: int = BLOCK):
    """B13's plain version on a complex Hessenberg ``h``: ``(eigenvalues,
    sweeps, hi)`` (converged when ``hi <= 1``), plus ``(T, Q)`` with
    ``h = Q T Q^H`` (``Q0 h Q0^H = Q T Q^H`` when starting from ``q = Q0``)
    when ``accumulate_q``."""
    max_sweeps, block = _checked("qr_eig_blocked_plain", max_sweeps, accumulate_q, q, block)
    out = _sweeps_plain(h, max_sweeps, tol, shifts, accumulate_q, q, block)
    return out if accumulate_q else out[:3]


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

def _sweeps_kernel(h, max_sweeps, tol, shifts, accumulate_q, q, block):
    """B13 on the card: ``(eig, sweeps, hi, T, Q or None)`` as device tensors."""
    code = check_square("qr_eig_blocked_kernel", h, COMPLEX_CODES)
    n = h.shape[0]
    if q is not None and (q.shape != h.shape or q.dtype != h.dtype or q.device != h.device):
        raise ValueError("qr_eig_blocked_kernel: q must match h in shape, dtype and device")
    if shifts is not None and shifts.ndim != 1:
        raise ValueError("qr_eig_blocked_kernel: shifts must be a 1-D tensor")
    shifts = _schedule(shifts)
    if shifts is not None:
        shifts = shifts.to(device=h.device, dtype=h.dtype).contiguous()
    lib = _build.load()
    t = h.clone()
    qq = (q.contiguous().clone() if q is not None else eye(n, h)) if accumulate_q else None
    ubuf = torch.empty(max(-(-(n - 1) // block), 1) * (block + 1) ** 2, dtype=h.dtype,
                       device=h.device)
    eig = torch.empty(n, dtype=h.dtype, device=h.device)
    state = torch.zeros(4, dtype=torch.int32, device=h.device)  # hi, lo, sweeps, done
    mu = torch.empty(1, dtype=h.dtype, device=h.device)
    rc = lib.qr_eig_blocked_sweeps(code, h.device.index, t.data_ptr(), ptr(qq), ubuf.data_ptr(),
                                   eig.data_ptr(), state.data_ptr(), mu.data_ptr(), ptr(shifts),
                                   0 if shifts is None else shifts.shape[0], n, max_sweeps,
                                   float(tol), block, BLOCKED_LAUNCHES_PER_READ, stream(h))
    raise_on_error("qr_eig_blocked_kernel", lib, rc)
    qr_eig_blocked_kernel.launches += 1
    return eig, state[2], state[0], t, qq


def qr_eig_blocked_kernel(h: torch.Tensor, max_sweeps: int, tol: float, shifts=None,
                          accumulate_q: bool = False, q=None, block: int = BLOCK):
    """B13 on the card: the blocked shifted Givens sweeps on a complex64 or
    complex128 Hessenberg matrix. Returns ``(eigenvalues, sweeps, hi)`` as
    device tensors, plus ``(T, Q)`` when ``accumulate_q`` (Q starts from
    ``q`` when given, else from I)."""
    max_sweeps, block = _checked("qr_eig_blocked_kernel", max_sweeps, accumulate_q, q, block)
    out = _sweeps_kernel(h, max_sweeps, tol, shifts, accumulate_q, q, block)
    return out if accumulate_q else out[:3]


qr_eig_blocked_kernel.launches = 0


# --------------------------------------------------------------------------
# Dispatchers
# --------------------------------------------------------------------------

def blocked_sweeps(h, max_sweeps, tol, shifts=None, accumulate_q=False, q=None, block=BLOCK):
    """The plain version for a CPU tensor, the kernel otherwise:
    ``(eigenvalues, sweeps, hi, T, Q or None)``."""
    max_sweeps, block = _checked("qr_eig_blocked_step", max_sweeps, accumulate_q, q, block)
    run = _sweeps_plain if h.device.type == "cpu" else _sweeps_kernel
    return run(h, max_sweeps, tol, shifts, accumulate_q, q, block)


def qr_eig_blocked_step(h: torch.Tensor, max_sweeps: int, tol: float, shifts=None,
                        block: int = BLOCK):
    """Up to ``max_sweeps`` sweeps from ``h`` (counterpart of JAX
    ``qr_eig_blocked_step``, :521): ``(h', eigenvalues, sweeps, hi)``. The
    window ``[lo, hi)`` is re-derived from ``h`` at entry, and ``shifts``
    (a 1-D complex tensor) replaces the Wilkinson shift: sweep ``s`` of this
    call uses ``shifts[s % len(shifts)]``; an empty ``shifts`` means Wilkinson
    shifts."""
    eig, sweeps, hi, t, _ = blocked_sweeps(h, max_sweeps, tol, shifts, block=block)
    return t, eig, sweeps, hi


def qr_eig_blocked_step_q(h: torch.Tensor, q: torch.Tensor, max_sweeps: int, tol: float,
                          shifts=None, block: int = BLOCK):
    """The Schur-mode step (counterpart of JAX ``qr_eig_blocked_step_q``,
    :580): as ``qr_eig_blocked_step``, with ``q`` multiplied by the right
    rotations and the slabs through all n columns. Returns
    ``(h', q', eigenvalues, sweeps, hi)`` with ``q h q^H = q' h' q'^H``."""
    eig, sweeps, hi, t, qq = blocked_sweeps(h, max_sweeps, tol, shifts, True, q, block)
    return t, qq, eig, sweeps, hi


def blocked_eigenvalues(a: torch.Tensor, max_sweeps: int, tol: float,
                        compute_vectors: bool = False):
    """Counterpart of JAX ``qr_eigenvalues_pallas_blocked`` (:726-788) with
    its monolithic Schur solve: the Hessenberg reduction
    (``hessenberg_reduce``: B11 from ``HESSENBERG_BLOCKED_MIN_N`` on, B7
    below), then B13. A real matrix reduces in its real dtype and is widened
    to the complex dtype of its precision. Returns ``(eigenvalues, sweeps,
    converged)``, plus ``V`` with ``compute_vectors``: B13 in Schur mode,
    ``Qh Qs`` (a plain product, as the JAX package leaves it to XLA) and the
    eigenvectors from B14 (``finish_eigenvectors_device``); column k of ``V``
    pairs with ``eigenvalues[k]``. The JAX option of Schur-mode AED rounds
    comes with the port of ``qr_aed.py``."""
    from .qr_kernels import accelerated_eigenpairs, accelerated_eigenvalues
    solve = accelerated_eigenpairs if compute_vectors else accelerated_eigenvalues
    return solve(a, max_sweeps, tol, blocked=True)
