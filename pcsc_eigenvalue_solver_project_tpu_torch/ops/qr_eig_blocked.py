"""Blocked Givens QR sweeps: the CUDA kernel B13 and its plain version, the
resumable steps and the blocked eigenvalue solve; and B10, the reference's
unshifted parity iteration, as the same kernel's sweeps in parity mode.

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

Parity mode (B10, ``_parity_plain`` and ``_parity_kernel``; the public
wrappers are ``ops/qr_kernels.py``'s ``qr_parity_blocked_plain`` and
``qr_parity_kernel``): no shift and the window ``[0, n)`` every sweep, on real
or complex ``H``, until ``max|H[i+1, i]| <= tol * (1 + ||H||_F)`` (the norm over
the upper-Hessenberg part) or the budget. On a Hessenberg matrix the
Householder QR of the reference is this Givens QR up to a diagonal unitary
``D``, so its iterate is ``D^H H D`` of this one: the diagonal, ``|H|``, the
subdiagonal's moduli and the norm agree.

``qr_eig_blocked_kernel`` runs ``csrc/qr_eig_blocked.cu`` on a complex64 or
complex128 CUDA tensor: one cooperative launch for a chunk of sweeps, in
which one block runs the rotation chain and the others apply the blocks'
slabs and right passes as their inputs are ready (the dependencies of
``_sweep_tasks``), with the deflation scan and the next shift between sweeps
on the device; it counts its calls in ``.launches`` and the last call's
cooperative launches in ``.device_launches``. The plain version
``qr_eig_blocked_plain`` repeats its algebra in PyTorch with the block size
as a parameter; ``_sweeps_plain(order=...)`` also runs a sweep as the
kernel's tasks, in sequence or in a random order their dependencies allow.
The dispatchers run the plain version for a CPU tensor and the kernel
otherwise (it launches or raises).

Not ported, as TPU layout or VMEM budgets: the window and chunk shapes
``_BS/_WR/_WC/_SC/_RC`` (JAX :46-50) and ``_rc_rows`` (:496), the scratch
(``_make_scratch``, :504), the 128-lane padding (``pad_for_blocked`` :629,
``pad_q_identity`` :593), the diagonal/sub/superdiagonal lane-vector caches
(:111-176) and the 8/128-aligned window anchoring.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.timing import annotate, count
from . import _build
from ._common import (COMPLEX_CODES, DTYPE_CODES, abs2, check_square, deflate_and_lo, eye,
                      givens, ptr, raise_on_error, real_dtype, rotate_rows, stream,
                      wilkinson_shift)

# Rotations per block, from the sweep of block sizes on the H100 (PERF.md):
# the chain's warp carries the bs + 2 window columns in slots of 32, and 62
# fills two, so the cost of a block's wait and publication is spread over
# the most rotations that cost two slots. Shared memory bounds bs at 64: the
# chain keeps two (bs + 1) x (bs + 2) windows and a (bs + 1) x bs look-ahead
# block, 205 KB at 64 in complex128.
BLOCK = 62
MAX_BLOCK = 64  # kMaxBlock of csrc/qr_eig_blocked.cu
# Columns of a slab task and rows of a right-pass task (kSlabCols and
# kRightRows of csrc/qr_eig_blocked.cu).
SLAB_COLS = 32
RIGHT_ROWS = 32
# Sweeps one cooperative launch of B13 runs at most (kSweepsPerLaunch of
# csrc/qr_eig_blocked.cu); the host reads the device-side state after each
# launch. On the H100 the budget moved the non-symmetric 2048 solve's 4474
# sweeps by 1.3% from 8 to 8192 (PERF.md), so it only bounds the sweeps past
# convergence a host waits for.
SWEEPS_PER_LAUNCH = 256


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

def _sweeps_plain(h, max_sweeps, tol, shifts, accumulate_q, q, block, order=None,
                  tiles=None):
    """The blocked sweeps in PyTorch: ``(eig, sweeps, hi, T, Q or None)``.

    ``order=None`` runs each sweep block by block (window and slab, then the
    right passes in order). Otherwise each sweep runs as the kernel's tasks
    (``_sweep_tasks``): ``"sequential"`` in that order, an int in a random
    topological order of their dependencies drawn from that seed. ``tiles``
    = (slab columns, right-pass rows) a task, default ``(SLAB_COLS,
    RIGHT_ROWS)``."""
    n = h.shape[0]
    shifts = _schedule(shifts)
    H = h.clone()
    Q = (q.clone() if q is not None else eye(n, h)) if accumulate_q else None
    tol_t = torch.tensor(tol, dtype=real_dtype(h.dtype), device=h.device)
    rng = None if order in (None, "sequential") else np.random.default_rng(order)
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
        if order is None:
            _sweep_by_blocks(H, Q, lo, hi, block, col_end)
        else:
            tasks, deps = _sweep_tasks(H, Q, lo, hi, block, col_end,
                                       tiles or (SLAB_COLS, RIGHT_ROWS))
            for name in _topological(tasks, deps, rng):
                tasks[name]()
        H[win, win] += mu
        hi, lo = deflate_and_lo(H, hi, tol_t)  # (d)
        sweeps += 1
    return (H.diagonal().clone(), torch.tensor(sweeps, dtype=torch.int32),
            torch.tensor(hi, dtype=torch.int32), H, Q)


def _parity_stop(H, tol_t):
    """The parity stop test after a sweep: ``(maxsub, converged)`` with
    ``maxsub = max|H[i+1, i]|`` (0 when n < 2) and ``converged = maxsub <= tol
    (1 + ||H||_F)`` in the working precision, the norm over the
    upper-Hessenberg part."""
    mag2 = abs2(H)
    n = H.shape[0]
    maxsub = mag2.diagonal(-1).max().sqrt() if n > 1 else torch.zeros_like(tol_t)
    return maxsub, bool(maxsub <= tol_t * (1.0 + torch.triu(mag2, -1).sum().sqrt()))


def _parity_plain(h, max_iterations, tol, block, order=None, tiles=None):
    """B10 in the kernel's order: ``(H, it, converged, maxsub)``. Each sweep
    is the blocked Givens sweep with no shift on the window ``[0, n)``
    (``order`` and ``tiles`` as for ``_sweeps_plain``), then the stop test."""
    n = h.shape[0]
    H = h.clone()
    tol_t = torch.tensor(tol, dtype=real_dtype(h.dtype), device=h.device)
    rng = None if order in (None, "sequential") else np.random.default_rng(order)
    maxsub, converged, it = torch.zeros_like(tol_t), False, 0
    while it < max_iterations and not converged:
        if n > 1 and order is None:
            _sweep_by_blocks(H, None, 0, n, block, n)
        elif n > 1:
            tasks, deps = _sweep_tasks(H, None, 0, n, block, n, tiles or (SLAB_COLS, RIGHT_ROWS))
            for name in _topological(tasks, deps, rng):
                tasks[name]()
        maxsub, converged = _parity_stop(H, tol_t)
        it += 1
    return H, torch.tensor(it, dtype=torch.int32), torch.tensor(converged), maxsub


def _blocks(lo, hi, block):
    """The sweep's blocks ``(b, e)``: rotations b .. e - 1 on rows b .. e."""
    return [(b, min(b + block, hi - 1)) for b in range(lo, hi - 1, block)]


def _window(H, b, e):
    """A block's left rotations on its window, rows b .. e times columns
    max(b - 1, 0) .. e, accumulated into U (from I); H is updated."""
    c0 = max(b - 1, 0)
    W = H[b:e + 1, c0:e + 1].clone()
    U = eye(e - b + 1, H)
    for r in range(e - b):  # rotation k = b + r on local rows r, r + 1
        g00, g01 = givens(W[r, b + r - c0], W[r + 1, b + r - c0])
        W[r], W[r + 1] = rotate_rows(g00, g01, W[r], W[r + 1])
        U[r], U[r + 1] = rotate_rows(g00, g01, U[r], U[r + 1])
    H[b:e + 1, c0:e + 1] = W
    return U


def _sweep_by_blocks(H, Q, lo, hi, block, col_end):
    """(a) window and (b) slab block by block, then (c) the right passes in
    order."""
    n = H.shape[0]
    factors = []
    for b, e in _blocks(lo, hi, block):
        U = _window(H, b, e)
        H[b:e + 1, e + 1:col_end] = U @ H[b:e + 1, e + 1:col_end]
        factors.append((b, e, U.conj().T))
    for b, e, Uh in factors:
        rows = min(e + 2, n)
        H[:rows, b:e + 1] = H[:rows, b:e + 1] @ Uh
        if Q is not None:
            Q[:, b:e + 1] = Q[:, b:e + 1] @ Uh


def _sweep_tasks(H, Q, lo, hi, block, col_end, tiles):
    """One sweep as the kernel's tasks: ``({name: run}, {name: [names it
    waits for]})``, each task a closure over H (and Q).

    Block i owns rows b_i .. e_i, and b_{i+1} = e_i. The tasks:

    - ``("C", i)``, the chain: window i's rotations (row b_i already holds
      its look-ahead entries), then the look-ahead of window i + 1: row
      e_i = b_{i+1} over columns e_i + 1 .. e_{i+1} after U_i, the last row
      of U_i times rows b_i .. e_i there. It keeps those columns' original
      row e_i in ``side[i + 1]`` for the slab and writes the look-ahead into
      H. Waits for C_{i-1} and, for the look-ahead, for slab i - 1 on those
      columns (row b_i there is slab i - 1's output).
    - ``("S", j, t)``, slab j on column tile t: rows b_j .. e_j times the
      tile's columns beyond e_j (below ``col_end``) := U_j times them; the
      look-ahead entries (row e_j over e_j + 1 .. e_{j+1}) are C_j's, so
      there the slab reads row e_j from ``side[j + 1]`` and does not write
      it. Waits for C_j and S_{j-1} on the tile.
    - ``("R", j, r)``, right pass j on row tile r: rows 0 .. min(e_j + 2, n)
      - 1 of the tile times columns b_j .. e_j := . U_j^H. Waits for every
      chain step whose window reaches row e_j + 1 (C_{j+1}, and C_{j+2} when
      b_{j+2} = e_j + 1), for slab j - 1 on the tiles of columns b_j .. e_j
      and for R_{j-1} on the tile (column b_j is shared).
    - ``("Q", j, r)``, in Schur mode: Q's rows of tile r times columns
      b_j .. e_j := . U_j^H. Waits for C_j and Q_{j-1} on the tile.

    Every task exists whether or not its region is empty (then it does
    nothing), so that each waits for its predecessor on the same tile."""
    n = H.shape[0]
    cols_a, rows_a = tiles
    blocks = _blocks(lo, hi, block)
    nb = len(blocks)
    U, side = [None] * nb, [None] * (nb + 1)
    col_tiles = range((blocks[0][0] + 1) // cols_a, -(-col_end // cols_a))
    row_tiles = range(0, -(-min(blocks[-1][1] + 2, n) // rows_a))
    q_tiles = range(0, -(-n // rows_a)) if Q is not None else range(0)

    def tiles_over(c_from, c_to):  # column tiles meeting [c_from, c_to]
        return [t for t in col_tiles if t * cols_a <= c_to and (t + 1) * cols_a > c_from]

    def chain(i):
        b, e = blocks[i]
        U[i] = _window(H, b, e)
        if i + 1 < nb:
            e2 = blocks[i + 1][1]
            side[i + 1] = H[e, e + 1:e2 + 1].clone()
            H[e, e + 1:e2 + 1] = (U[i] @ H[b:e + 1, e + 1:e2 + 1])[-1]

    def slab(j, t):
        b, e = blocks[j]
        c1, c2 = max(t * cols_a, e + 1), min((t + 1) * cols_a, col_end)
        if c1 >= c2:
            return
        X = H[b:e + 1, c1:c2].clone()
        la_end = blocks[j + 1][1] + 1 if j + 1 < nb else e + 1  # look-ahead columns
        la = min(la_end, c2) - c1
        if la > 0:
            X[-1, :la] = side[j + 1][c1 - e - 1:c1 - e - 1 + la]
        out = U[j] @ X
        H[b:e + 1, c1 + max(la, 0):c2] = out[:, max(la, 0):]
        if la > 0:
            H[b:e, c1:c1 + la] = out[:-1, :la]

    def right(M, j, r, row_end):
        b, e = blocks[j]
        r1, r2 = r * rows_a, min((r + 1) * rows_a, row_end)
        if r1 < r2:
            M[r1:r2, b:e + 1] = M[r1:r2, b:e + 1] @ U[j].conj().T

    tasks, deps = {}, {}  # inserted in the order of _sweep_by_blocks
    for i, (b, e) in enumerate(blocks):
        tasks["C", i] = functools.partial(chain, i)
        deps["C", i] = ([("C", i - 1)] if i else []) + (
            [("S", i - 1, t) for t in tiles_over(e + 1, blocks[i + 1][1])]
            if 0 < i < nb - 1 else [])
        for t in col_tiles:
            tasks["S", i, t] = functools.partial(slab, i, t)
            deps["S", i, t] = [("C", i)] + ([("S", i - 1, t)] if i else [])
    for j, (b, e) in enumerate(blocks):
        reach = max(i for i in range(nb) if blocks[i][0] <= e + 1)
        for r in row_tiles:
            tasks["R", j, r] = functools.partial(right, H, j, r, min(e + 2, n))
            deps["R", j, r] = [("C", reach)] + ([("R", j - 1, r)] + [
                ("S", j - 1, t) for t in tiles_over(b, e)] if j else [])
        for r in q_tiles:
            tasks["Q", j, r] = functools.partial(right, Q, j, r, n)
            deps["Q", j, r] = [("C", j)] + ([("Q", j - 1, r)] if j else [])
    return tasks, deps


def _topological(tasks, deps, rng):
    """The task names in their order of insertion (``rng`` None), else in a
    random order drawn from ``rng``; in either, every task follows what it
    waits for (raises if not)."""
    if rng is None:
        done = set()
        for name in tasks:
            if any(d not in done for d in deps[name]):
                raise RuntimeError(f"task {name} comes before what it waits for")
            done.add(name)
        return list(tasks)
    waiting = {name: len(deps[name]) for name in tasks}
    users = {name: [] for name in tasks}
    for name in tasks:
        for d in deps[name]:
            users[d].append(name)
    ready = [name for name, k in waiting.items() if k == 0]
    out = []
    while ready:
        k = int(rng.integers(len(ready)))
        ready[k], ready[-1] = ready[-1], ready[k]
        name = ready.pop()
        out.append(name)
        for u in users[name]:
            waiting[u] -= 1
            if waiting[u] == 0:
                ready.append(u)
    if len(out) != len(tasks):
        raise RuntimeError("the sweep's task dependencies have a cycle")
    return out


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

def _launch(name, code, h, max_sweeps, tol, shifts, qq, block, grid, parity):
    """One call of ``csrc/qr_eig_blocked.cu`` on a copy of ``h`` (and on
    ``qq`` in place): ``(T, eig, state, part, cooperative launches)``, state =
    (hi, lo, sweeps, done, converged), part's last entry the parity mode's
    maxsub."""
    n = h.shape[0]
    if int(grid) < 0 or int(grid) in (1, 2):
        raise ValueError(f"{name}: grid {grid} is neither 0 nor at least 3")
    lib = _build.load()
    t = h.clone()
    dev = dict(dtype=h.dtype, device=h.device)
    ubuf = torch.empty(max(-(-(n - 1) // block), 1) * (block + 1) ** 2, **dev)
    side = torch.empty(max(n, 1), **dev)
    flags = torch.empty(n + -(-n // SLAB_COLS), dtype=torch.int32, device=h.device)
    eig = torch.empty(n, **dev)
    state = torch.zeros(5, dtype=torch.int32, device=h.device)
    mu = torch.empty(1, **dev)
    part = torch.zeros(2 * -(-n // RIGHT_ROWS) + 1, dtype=real_dtype(h.dtype),
                       device=h.device) if parity else None
    launches = ctypes.c_longlong(0)
    # the launcher blocks on the card after each launch to read the state
    with annotate("eigsol.qr.sweeps", wait=True):
        rc = lib.qr_eig_blocked_sweeps(code, h.device.index, t.data_ptr(), ptr(qq),
                                       ubuf.data_ptr(), side.data_ptr(), flags.data_ptr(),
                                       eig.data_ptr(), state.data_ptr(), mu.data_ptr(),
                                       ptr(shifts), 0 if shifts is None else shifts.shape[0], n,
                                       max_sweeps, float(tol), block, int(grid), int(parity),
                                       ptr(part), ctypes.byref(launches), stream(h))
    raise_on_error(name, lib, rc)
    count("host_reads", launches.value)
    return t, eig, state, part, launches.value


def _sweeps_kernel(h, max_sweeps, tol, shifts, accumulate_q, q, block, grid=0):
    """B13 on the card: ``(eig, sweeps, hi, T, Q or None)`` as device tensors.
    ``grid`` > 0 sets the cooperative launch's size in place of one block an
    SM, for tests: it must be at least 3 and at most what the card holds at
    once (``blocked_capacity``)."""
    code = check_square("qr_eig_blocked_kernel", h, COMPLEX_CODES)
    n = h.shape[0]
    if q is not None and (q.shape != h.shape or q.dtype != h.dtype or q.device != h.device):
        raise ValueError("qr_eig_blocked_kernel: q must match h in shape, dtype and device")
    if shifts is not None and shifts.ndim != 1:
        raise ValueError("qr_eig_blocked_kernel: shifts must be a 1-D tensor")
    shifts = _schedule(shifts)
    if shifts is not None:
        shifts = shifts.to(device=h.device, dtype=h.dtype).contiguous()
    qq = (q.contiguous().clone() if q is not None else eye(n, h)) if accumulate_q else None
    t, eig, state, _, launches = _launch("qr_eig_blocked_kernel", code, h, max_sweeps, tol,
                                         shifts, qq, block, grid, False)
    qr_eig_blocked_kernel.launches += 1
    qr_eig_blocked_kernel.device_launches = launches
    return eig, state[2], state[0], t, qq


def _parity_kernel(h, max_iterations, tol):
    """B10 on the card, the kernel's sweeps in parity mode (blocks of
    ``BLOCK`` rotations) on a float32, float64, complex64 or complex128
    Hessenberg matrix: ``(H, it, converged, maxsub, cooperative launches)``,
    the first four as device tensors."""
    code = check_square("qr_parity_kernel", h, DTYPE_CODES)
    if not 0 <= max_iterations < 2 ** 31:
        raise ValueError(f"qr_parity_kernel: max_iterations {max_iterations} "
                         f"out of int32 range")
    t, _, state, part, launches = _launch("qr_parity_kernel", code, h, int(max_iterations), tol,
                                          None, None, BLOCK, 0, True)
    return t, state[2], state[4] != 0, part[-1], launches


def qr_eig_blocked_kernel(h: torch.Tensor, max_sweeps: int, tol: float, shifts=None,
                          accumulate_q: bool = False, q=None, block: int = BLOCK):
    """B13 on the card: the blocked shifted Givens sweeps on a complex64 or
    complex128 Hessenberg matrix. Returns ``(eigenvalues, sweeps, hi)`` as
    device tensors, plus ``(T, Q)`` when ``accumulate_q`` (Q starts from
    ``q`` when given, else from I).

    Each cooperative launch of one block an SM (fewer when the matrix has
    fewer tiles) runs up to ``SWEEPS_PER_LAUNCH`` sweeps; ``.device_launches``
    counts the launches of the last call."""
    max_sweeps, block = _checked("qr_eig_blocked_kernel", max_sweeps, accumulate_q, q, block)
    out = _sweeps_kernel(h, max_sweeps, tol, shifts, accumulate_q, q, block)
    return out if accumulate_q else out[:3]


qr_eig_blocked_kernel.launches = 0
qr_eig_blocked_kernel.device_launches = 0


def blocked_capacity(dtype: torch.dtype, device, block: int = BLOCK):
    """``(blocks, SMs)``: the blocks one cooperative launch of B13 (of B10 on
    real data) can hold at once on the card, and its SMs."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"blocked_capacity: unsupported dtype {dtype}")
    device = torch.device(device)
    out = (ctypes.c_int * 2)()
    lib = _build.load()
    rc = lib.qr_eig_blocked_capacity(DTYPE_CODES[dtype], device.index or 0, int(block), out)
    raise_on_error("blocked_capacity", lib, rc)
    return out[0], out[1]


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


# The n from which the eigenvalues-only solve runs AED rounds
# (``ops/qr_aed.py``) rather than plain B13 sweeps, and the n from which
# eigenpairs run the Schur-mode AED driver rather than the monolithic one
# (``schur_driver="auto"``); None: never by "auto". Set by the rule of
# chip_smoke.py --aed-table on the H100 (PERF.md), not from the JAX
# package's 768 (a VMEM cap) and 8192 (a TPU worker crash): the smallest n
# of 1024, 2048 and 4096 (2048 and 4096 with eigenpairs) from which plain
# B13 misses phase 14's eigenvalue limit on any of the table's operands, or
# AED is no slower than plain B13 on every one of them (the bench, c64
# normal, non-symmetric and uniform-[1, 2] operands; the bench and
# non-symmetric ones with eigenpairs). Accuracy decides 4096: there plain
# B13 takes 4952 sweeps on the uniform-[1, 2] operand and misses the 1e-4
# limit (1.01e-4), while AED's 3530 sweeps reach 2.7e-5 (NVIDIA H100 80GB
# HBM3, 700 W). Plain B13's backward error grows as f32 rounding summed over
# its sweeps, ~1e-7 sqrt(sweeps) (4.3e-6, 5.2e-6, 7.2e-6 at 1024, 2048,
# 4096), and the same solve in complex128 reaches 1.1e-5: rounding over a
# long iteration, not a kernel fault. Speed alone picks no size: AED is
# 23-88% slower on the uniform-[1, 2] operand and 1-17% slower on the
# spectra 0.9^i, which converge before a round pays for itself, though
# 15-49% faster on the non-symmetric matrix at 2048 and 4096. With
# eigenpairs no row misses its limit and AED is slower on the bench
# operand, so ``SCHUR_AED_MIN_N`` stays None.
AED_MIN_N: int | None = 4096
SCHUR_AED_MIN_N: int | None = None
SCHUR_DRIVERS = ("auto", "monolithic", "aed")


def blocked_eigenvalues(a: torch.Tensor, max_sweeps: int, tol: float,
                        compute_vectors: bool = False, schur_driver: str = "auto"):
    """Counterpart of JAX ``qr_eigenvalues_pallas_blocked`` (:726-788): the
    Hessenberg reduction (``hessenberg_reduce``: B11 from
    ``HESSENBERG_BLOCKED_MIN_N`` on, B7 below), then the sweeps. A real
    matrix reduces in its real dtype and is widened to the complex dtype of
    its precision. Returns ``(eigenvalues, sweeps, converged)``, plus ``V``
    with ``compute_vectors`` (column k pairs with ``eigenvalues[k]``).

    ``schur_driver`` picks the sweeps that ``accelerated_eigenvalues`` /
    ``accelerated_eigenpairs`` run after the reduction: ``"monolithic"``
    B13 alone (``blocked_sweeps``), ``"aed"`` B13 between AED rounds
    (``ops/qr_aed.py``), ``"auto"`` AED from ``AED_MIN_N`` on
    (``SCHUR_AED_MIN_N`` with ``compute_vectors``); anything else raises
    ``ValueError``. Eigenpairs run the sweeps in Schur mode, then ``Qh Qs``
    (a plain product, as the JAX package leaves it to XLA) and the
    eigenvectors from B14. Unlike the JAX function, ``schur_driver`` also
    applies to eigenvalues only, where JAX picks by its own constant."""
    from . import qr_aed
    from .qr_kernels import accelerated_eigenpairs, accelerated_eigenvalues
    if schur_driver not in SCHUR_DRIVERS:
        raise ValueError(f"unknown schur_driver {schur_driver!r}")
    if schur_driver == "auto":
        edge = SCHUR_AED_MIN_N if compute_vectors else AED_MIN_N
        schur_driver = "aed" if edge is not None and a.shape[0] >= edge else "monolithic"
    if compute_vectors:
        sweeps = (qr_aed.qr_eig_blocked_aed_schur if schur_driver == "aed"
                  else functools.partial(blocked_sweeps, accumulate_q=True))
        return accelerated_eigenpairs(a, max_sweeps, tol, sweeps)
    sweeps = qr_aed.qr_eig_blocked_aed if schur_driver == "aed" else blocked_sweeps
    return accelerated_eigenvalues(a, max_sweeps, tol, sweeps)
