"""Dense QR stack: CUDA kernels for the H100 and their plain versions.

Counterpart of the JAX package's ``ops/pallas/qr_kernels.py``. Four kernels,
in ``csrc/qr_kernels.cu``, for B7 ``csrc/hessenberg_cluster.cu`` and for B10
``csrc/qr_eig_blocked.cu`` (see their headers for the design):

- ``hessenberg_kernel`` (B7): Householder Hessenberg reduction, optionally
  accumulating ``Q`` with ``A = Q H Q^H``, as one launch of one thread-block
  cluster (``csrc/hessenberg_cluster.cu``; ``hessenberg_route`` picks the
  cluster size and where H and Q live);
- ``qr_eig_kernel`` (B8): the whole Wilkinson-shifted complex Givens QR
  iteration with deflation on a Hessenberg matrix, in one launch of one
  block: B13's blocked sweep with the chain in one warp (``qr_eig_route``
  picks the block size and whether H lives in shared memory);
- ``qr_decompose_kernel`` (B9): square Householder QR with the full ``Q``,
  blocked: panels of ``nb`` columns factored in one block each, compact-WY
  trailing updates and a backward accumulation of ``Q`` as tiled GEMMs
  with deterministic split-K (``qr_decompose_blocked_plain`` is its plain
  version);
- ``qr_parity_kernel`` (B10): the reference's unshifted iteration until
  ``max|H[i,i-1]| <= tol * (1 + ||H||_F)``, as the blocked Givens sweeps of
  ``ops/qr_eig_blocked.py`` in parity mode: on a Hessenberg matrix the
  iterate is the reference's (a Householder QR of ``H`` each sweep, then
  ``H := R Q``) up to a diagonal unitary ``D``, ``D^H H D``
  (``qr_parity_blocked_plain`` is its plain version).

The blocked Hessenberg reduction B11 (``ops/hessenberg_blocked.py``), the
triangular eigenvectors B14 (``ops/trisolve_vec.py``) and the blocked sweeps
B13 (``ops/qr_eig_blocked.py``) have modules of their own; ``KERNELS`` lists
all seven.

The functions take native ``(n, n)`` tensors of float32, float64, complex64
or complex128 (B8: complex only). The TPU's split re/im planes, its
128-lane padding and its in-kernel transposes are TPU layout and have no
counterpart here.

Each kernel wrapper checks its input, allocates outputs and scratch, launches
on the current stream, raises if the launch failed and counts its launches in
``.launches``. The dispatchers (``hessenberg_reduce``, ``qr_eig_sweeps``,
``householder_qr``, ``parity_sweeps``) run the plain PyTorch version when the
tensor lies on the CPU and the kernel otherwise: a tensor on a CUDA device
launches the kernel or raises. The plain versions port what the Pallas
kernels compute (mask arithmetic, a 0 factor for skipped columns, ``rsqrt``
normalisation, B8's ``[lo, hi)`` window), not the XLA solver loops of
``solvers/``; B9's and B10's CPU routes keep the Pallas kernels' order
(``qr_decompose_plain``, ``qr_parity_plain``), and ``qr_decompose_blocked_plain``
and ``qr_parity_blocked_plain`` follow the card's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from functools import partial

import numpy as np
import torch

from ..utils.timing import annotate, host_read
from . import _build
from ._common import (COMPLEX_CODES, DTYPE_CODES, abs2, check_square, deflate_and_lo, eye,
                      givens, ptr, raise_on_error, real_dtype, reflector, rotate_rows, stream,
                      wilkinson_shift)
from .hessenberg_blocked import hessenberg_blocked, hessenberg_blocked_kernel
from .qr_eig_blocked import BLOCK, _parity_kernel, _parity_plain, blocked_sweeps, \
    qr_eig_blocked_kernel
from .trisolve_vec import triangular_eigenvectors_device, triangular_eigenvectors_kernel

# B9's panel width (at most 64; csrc/qr_kernels.cu::kMaxQRPanel): 32 where
# the first panel, n x 32 elements, fits in the panel kernel's shared memory
# (QR_PANEL_SMEM, csrc/qr_kernels.cu::kPanelSmem), else 16, which keeps it
# there up to n = 3520 in float32. Set from chip_smoke.py's sweep of 16, 32
# and 64 at n = 512 and 2048 in four dtypes (PERF.md).
QR_PANEL_SMEM = 220 * 1024


def qr_panel_width(n: int, dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 32 if n * 32 * itemsize <= QR_PANEL_SMEM else 16


# B8 (csrc/qr_kernels.cu): one block of EIG_WARPS warps, U_i in a ring of
# EIG_RING slots, tasks of EIG_TILE columns or rows, and the dynamic shared
# memory a block may take (227 KB on the H100, less the static part). Its
# block size is eig_block's, 8 or 16; the kernel holds no larger.
EIG_WARPS = 16
EIG_RING = 4
EIG_TILE = 32
EIG_SMEM_BUDGET = 227 * 1024 - 1024


@dataclass(frozen=True)
class EigLayout:
    """Where B8's parts lie in its dynamic shared memory, as the kernel takes
    it (``csrc/qr_kernels.cu::EigLayout``, in this order): H's row stride,
    U_i's and a staged row tile's, the worker warps on slabs, on H's right
    passes and on Q's, the first staged worker warp, then the byte offsets
    of the ring of U_i and side rows, U_i's last row, the chain's window,
    the staged row tiles and the counters, and the total."""
    ld: int
    us: int
    sst: int
    nslab: int
    nright: int
    nq: int
    staged0: int
    off_ring: int
    off_lrow: int
    off_win: int
    off_stage: int
    off_ints: int
    bytes: int


def eig_layout(n: int, block: int, h_smem: bool, accumulate_q: bool, itemsize: int) -> EigLayout:
    """B8's layout: H (row stride n | 1, so that a warp reading 32 rows of a
    column hits 32 banks) when on chip, the ring of U_i and their side rows,
    U_i's last row, the chain's two windows and look-ahead when H is in
    global memory, a row tile for each worker whose right passes are staged
    (Q's, and H's when H is in global memory), and the counters (the chain,
    one a warp, one a column tile)."""
    us, sst = block + 1, (block + 1) | 1
    nslab, nright, nq = (4, 4, 7) if accumulate_q else (7, 8, 0)
    staged0 = 1 + nslab + (nright if h_smem else 0)
    ld = n | 1 if h_smem else n
    off_ring = (n * ld if h_smem else 0) * itemsize
    off_lrow = off_ring + EIG_RING * (us * us + block) * itemsize
    off_win = off_lrow + us * itemsize
    off_stage = off_win + (0 if h_smem else us * (2 * (block + 2) + block)) * itemsize
    off_ints = off_stage + (EIG_WARPS - staged0) * EIG_TILE * sst * itemsize
    total = off_ints + 4 * (1 + EIG_WARPS + -(-n // EIG_TILE))
    return EigLayout(ld, us, sst, nslab, nright, nq, staged0, off_ring, off_lrow, off_win,
                     off_stage, off_ints, total)


@dataclass(frozen=True)
class EigPlan:
    """How B8 runs: rotations in blocks of ``block``; ``h_smem`` says whether
    H lives in the block's shared memory (else in the output, in global
    memory); ``layout`` is its dynamic shared memory, ``smem`` bytes."""
    h_smem: bool
    block: int
    layout: EigLayout

    @property
    def smem(self) -> int:
        return self.layout.bytes


def eig_block(n: int, dtype: torch.dtype) -> int:
    """B8's block size: 8, and 16 in complex64 beyond n = 128. A worker's
    product costs bs + 1 multiply-adds an entry, and the chain waits for the
    slab right of its window; chip_smoke.py's sweep of bs (phase 6) on the
    H100 had 8 ahead at 64 and 128 in complex64 and at 64-256 in
    complex128, and 16 ahead at 256 in complex64 (PERF.md)."""
    return 16 if dtype == torch.complex64 and n > 128 else 8


def _eig_plan(n: int, dtype: torch.dtype, accumulate_q: bool, block: int) -> EigPlan:
    if not 1 <= block <= 16:
        raise ValueError(f"qr_eig_kernel: block {block} outside [1, 16]")
    itemsize = torch.empty((), dtype=dtype).element_size()
    for h_smem in (True, False):
        layout = eig_layout(n, block, h_smem, accumulate_q, itemsize)
        if layout.bytes <= EIG_SMEM_BUDGET:
            return EigPlan(h_smem, block, layout)
    raise ValueError(f"qr_eig_kernel: n = {n} does not fit one block's shared memory")


def qr_eig_route(n: int, dtype: torch.dtype, accumulate_q: bool) -> EigPlan:
    """B8's plan: blocks of ``eig_block``, H in shared memory where it fits
    in ``EIG_SMEM_BUDGET``, else in global memory. Raises where neither
    fits."""
    return _eig_plan(n, dtype, accumulate_q, eig_block(n, dtype))


# B7's cluster sizes, in the order tried: 16 blocks (non-portable, where the
# card schedules them), else the portable 8.
HESSENBERG_CLUSTERS = (16, 8)
# The dynamic shared memory a block of B7 may take (227 KB a block on the
# H100, less the static part; csrc/hessenberg_cluster.cu::kHessSmemBudget).
HESSENBERG_SMEM_BUDGET = 227 * 1024 - 1024


@dataclass(frozen=True)
class HessenbergPlan:
    """How B7 runs: one cluster of ``cluster`` blocks; block r owns the
    columns r, r + cluster, ... of H and the ``width`` rows from r * width of
    Q; ``h_smem`` / ``q_smem`` say whether those live in the block's shared
    memory (else in L2-resident global memory); ``smem`` is its dynamic
    shared memory in bytes."""
    cluster: int
    width: int
    h_smem: bool
    q_smem: bool
    smem: int


def hessenberg_cluster_plan(n: int, dtype: torch.dtype, accumulate_q: bool, cluster: int,
                            smem_budget: int = HESSENBERG_SMEM_BUDGET):
    """B7's layout for a cluster size, as ``csrc/hessenberg_cluster.cu``
    reckons it: six vectors of n + 1 scalars (two partials of u, two
    published columns, the reflector, the block's copy of the next column),
    then the H slab (``width`` columns of n)
    and Q's ``width`` rows, each in shared memory where it still fits, H
    first. None when not even the vectors fit."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    width = -(-n // cluster)
    used = 6 * (n + 1) * itemsize
    if used > smem_budget:
        return None
    slab = width * n * itemsize
    h_smem = used + slab <= smem_budget
    used += slab if h_smem else 0
    q_smem = accumulate_q and used + slab <= smem_budget
    used += slab if q_smem else 0
    return HessenbergPlan(cluster, width, h_smem, q_smem, used)


def choose_hessenberg_plan(n: int, dtype: torch.dtype, accumulate_q: bool, capacity):
    """The first of ``HESSENBERG_CLUSTERS`` whose plan the card can run:
    ``capacity(cluster, smem)`` is the number of such clusters it holds at
    once. Raises where none fits."""
    for cluster in HESSENBERG_CLUSTERS:
        plan = hessenberg_cluster_plan(n, dtype, accumulate_q, cluster)
        if plan is not None and capacity(cluster, plan.smem) >= 1:
            return plan
    raise ValueError(f"hessenberg_kernel: no cluster of {HESSENBERG_CLUSTERS} blocks fits "
                     f"n = {n} in {dtype} on this device")


_CLUSTER_CAPACITY = {}


def hessenberg_route(n: int, dtype: torch.dtype, accumulate_q: bool,
                     device: torch.device) -> HessenbergPlan:
    """B7's plan on a CUDA device, decided before the launch
    (``cudaOccupancyMaxActiveClusters``, cached per device, dtype, cluster
    size and shared memory)."""
    code, index = DTYPE_CODES[dtype], device.index if device.index is not None else 0

    def capacity(cluster, smem):
        key = (index, code, cluster, smem)
        if key not in _CLUSTER_CAPACITY:
            lib = _build.load()
            count = ctypes.c_int(0)
            rc = lib.hessenberg_cluster_capacity(code, index, cluster, smem, ctypes.byref(count))
            raise_on_error("hessenberg_kernel", lib, rc)
            _CLUSTER_CAPACITY[key] = count.value
        return _CLUSTER_CAPACITY[key]

    return choose_hessenberg_plan(n, dtype, accumulate_q, capacity)


def cluster_barrier_probe(device: torch.device, cluster: int, iterations: int) -> None:
    """Enqueue one cluster of ``cluster`` blocks that runs ``iterations``
    cluster barriers and nothing else (what a barrier of B7's steps costs)."""
    lib = _build.load()
    index = device.index if device.index is not None else 0
    rc = lib.cluster_barrier_probe(index, cluster, iterations,
                                   torch.cuda.current_stream(device).cuda_stream)
    raise_on_error("cluster_barrier_probe", lib, rc)


# --------------------------------------------------------------------------
# Plain PyTorch versions (what the Pallas kernels compute)
# --------------------------------------------------------------------------

def hessenberg_plain(a: torch.Tensor, accumulate_q: bool = False):
    """B7's plain version: ``H`` (and ``Q`` with ``A = Q H Q^H`` when
    ``accumulate_q``). The left update is restricted to columns >= k."""
    n = a.shape[0]
    H = a.clone()
    Q = eye(n, a) if accumulate_q else None
    cols = torch.arange(n, device=a.device)
    for k in range(n - 2):
        v, f = reflector(H[:, k], k + 1)
        w = torch.where(cols >= k, v.conj() @ H, 0)
        H = H - f * torch.outer(v, w)
        H = H - f * torch.outer(H @ v, v.conj())
        if accumulate_q:
            Q = Q - f * torch.outer(Q @ v, v.conj())
    return (H, Q) if accumulate_q else H


def _qr_step(R: torch.Tensor, Q: torch.Tensor, k: int):
    """One Householder column step of ``A = Q R`` (qr_kernels.py:653-753)."""
    v, f = reflector(R[:, k], k)
    cols = torch.arange(R.shape[1], device=R.device)
    w = torch.where(cols >= k, v.conj() @ R, 0)
    return R - f * torch.outer(v, w), Q - f * torch.outer(Q @ v, v.conj())


def qr_decompose_plain(a: torch.Tensor, kmax: int | None = None):
    """B9's plain version: ``(R, Q)`` with ``A = Q R`` after ``kmax``
    column steps (default n)."""
    n = a.shape[0]
    R, Q = a.clone(), eye(n, a)
    for k in range(n if kmax is None else kmax):
        R, Q = _qr_step(R, Q, k)
    return R, Q


def _panel_reflector(x: torch.Tensor, j: int):
    """B9's panel rule for column ``x`` of a panel with pivot row ``j``
    (csrc/qr_kernels.cu::qr_panel_kernel): ``(v, f, r_jj)``. The rule is the
    one of ``reflector``: the phase sign, factor 2, or 0 when the column is
    zero below the pivot or the reflector degenerates; ``||x||^2`` is taken
    as the tail's sum plus ``|x0|^2``, as the kernel takes it. ``r_jj`` is
    ``-sign ||x||`` (``x0`` when skipped)."""
    tail2 = abs2(x[j + 1:]).sum()
    x0 = x[j]
    a0 = abs2(x0)
    m0, nrm = a0.sqrt(), (tail2 + a0).sqrt()
    sign = torch.where(m0 > 0, x0 / torch.where(m0 > 0, m0, 1), 1).to(x.dtype)
    v = torch.where(torch.arange(x.shape[0], device=x.device) >= j, x, 0)
    v[j] = x0 + sign * nrm
    vn2 = tail2 + abs2(v[j])
    degenerate = vn2 == 0
    skip = (tail2 == 0) | degenerate
    v = v * torch.rsqrt(torch.where(degenerate, 1, vn2))
    f = torch.where(skip, 0.0, 2.0).to(real_dtype(x.dtype))
    return v, f, torch.where(skip, x0, -sign * nrm)


def qr_decompose_blocked_plain(a: torch.Tensor, kmax: int | None = None, nb: int = 32):
    """The plain version of the blocked B9 kernel: ``(R, Q)`` with ``A = Q R``
    after ``kmax`` reflectors (default n), in the kernel's order. Per panel
    of ``nb`` columns: each column's reflector (``_panel_reflector``)
    applied to the panel's later columns, ``T[j, j] = f_j``,
    ``T[:j, j] = -f_j T[:j, :j] (V[:, :j]^H v_j)``, exact zeros below the
    diagonal, then with ``Y = V T``, ``R[k0:, k0+jn:] -= V (Y^H R[k0:, k0+jn:])``
    (``= V T^H V^H R``); after the last panel ``Q = I`` and, from the last
    panel to the first, with ``Z = V T^H``, ``Q[k0:, k0:] -= V (Z^H Q[k0:, k0:])``
    (LAPACK ``orgqr`` order)."""
    n = a.shape[0]
    kmax = n if kmax is None else kmax
    R, Q = a.clone(), eye(n, a)
    panels = []
    for k0 in range(0, kmax, nb):
        jn = min(nb, kmax - k0)
        P = R[k0:, k0:k0 + jn].clone()
        V = torch.zeros_like(P)
        T = torch.zeros((jn, jn), dtype=a.dtype, device=a.device)
        for j in range(jn):
            v, f, d = _panel_reflector(P[:, j], j)
            V[:, j] = v
            P[j, j], P[j + 1:, j] = d, 0
            P[:, j + 1:] -= f * torch.outer(v, v.conj() @ P[:, j + 1:])
            T[:j, j] = -f * (T[:j, :j] @ (V[:, :j].conj().T @ v))
            T[j, j] = f
        R[k0:, k0:k0 + jn] = P
        C = R[k0:, k0 + jn:]
        C -= V @ ((V @ T).conj().T @ C)
        panels.append((k0, V, V @ T.conj().T))
    for k0, V, Z in reversed(panels):
        Qs = Q[k0:, k0:]
        Qs -= V @ (Z.conj().T @ Qs)
    return R, Q


def qr_eig_plain(h: torch.Tensor, max_sweeps: int, tol: float,
                 accumulate_q: bool = False):
    """B8's plain version on a complex Hessenberg ``h``. Returns
    ``(eigenvalues, sweeps, hi)`` (converged when ``hi <= 1``), plus the
    final ``T`` and ``Q`` with ``h = Q T Q^H`` when ``accumulate_q``.

    Each sweep: the shift from the trailing active 2x2, ``H - mu I`` on the
    window ``[lo, hi)``, left rotations of rows k, k+1 for k in
    ``[lo, hi-1)`` over all columns, right rotations of columns k, k+1 over
    all rows, ``+ mu I``, and the new ``hi`` and ``lo``."""
    n = h.shape[0]
    H = h.clone()
    Q = eye(n, h) if accumulate_q else None
    tol_t = torch.tensor(tol, dtype=real_dtype(h.dtype), device=h.device)
    hi, lo = deflate_and_lo(H, n, tol_t)
    sweeps = 0
    while hi > 1 and sweeps < max_sweeps:
        mu = wilkinson_shift(H[hi - 2, hi - 2], H[hi - 2, hi - 1],
                              H[hi - 1, hi - 2], H[hi - 1, hi - 1])
        win = torch.arange(lo, hi, device=h.device)
        H[win, win] -= mu
        rotations = []
        for k in range(lo, hi - 1):
            g00, g01 = givens(H[k, k], H[k + 1, k])
            H[k], H[k + 1] = rotate_rows(g00, g01, H[k], H[k + 1])
            rotations.append((k, g00, g01))
        for M in (H, Q) if accumulate_q else (H,):
            for k, g00, g01 in rotations:
                ck, ck1 = M[:, k].clone(), M[:, k + 1].clone()
                M[:, k] = g00.conj() * ck + g01.conj() * ck1
                M[:, k + 1] = -g01 * ck + g00 * ck1
        H[win, win] += mu
        hi, lo = deflate_and_lo(H, hi, tol_t)
        sweeps += 1
    out = (H.diagonal().clone(), torch.tensor(sweeps, dtype=torch.int32),
           torch.tensor(hi, dtype=torch.int32))
    return out + (H, Q) if accumulate_q else out


def qr_parity_plain(h: torch.Tensor, max_iterations: int, tol: float):
    """The Pallas B10's order: unshifted sweeps ``H := R Q`` with ``H = Q R``
    from n Householder steps, until ``max|H[i,i-1]| <= tol * (1 + ||H||_F)``
    or ``max_iterations`` sweeps. Returns ``(H, it, converged, maxsub)``;
    the caller applies the reference's iteration-count quirk."""
    n = h.shape[0]
    tol_t = torch.tensor(tol, dtype=real_dtype(h.dtype), device=h.device)
    H = h.clone()
    maxsub = torch.zeros((), dtype=tol_t.dtype, device=h.device)
    it, converged = 0, False
    while it < max_iterations and not converged:
        R, Q = qr_decompose_plain(H)
        H = R @ Q
        mag2 = abs2(H)
        maxsub = mag2.diagonal(-1).max().sqrt() if n > 1 else torch.zeros_like(maxsub)
        converged = bool(maxsub <= tol_t * (1.0 + mag2.sum().sqrt()))
        it += 1
    return (H, torch.tensor(it, dtype=torch.int32), torch.tensor(converged),
            maxsub)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def hessenberg_kernel(a: torch.Tensor, accumulate_q: bool = False):
    """B7 on the card: ``H`` (and ``Q``) of a square CUDA matrix, in one
    cluster launch. The plan it ran is in ``hessenberg_kernel.last_plan``."""
    code = check_square("hessenberg_kernel", a, DTYPE_CODES)
    n = a.shape[0]
    plan = hessenberg_route(n, a.dtype, accumulate_q, a.device)
    lib = _build.load()
    h = torch.empty_like(a)
    q = torch.empty_like(a) if accumulate_q else None
    slabs = None if plan.h_smem else torch.empty(plan.cluster * plan.width * n,
                                                 dtype=a.dtype, device=a.device)
    rc = lib.qr_hessenberg(code, a.device.index, a.data_ptr(), h.data_ptr(), ptr(q),
                           ptr(slabs), n, plan.cluster, int(plan.h_smem), int(plan.q_smem),
                           plan.smem, stream(a))
    raise_on_error("hessenberg_kernel", lib, rc)
    hessenberg_kernel.launches += 1
    hessenberg_kernel.last_plan = plan
    return (h, q) if accumulate_q else h


hessenberg_kernel.launches = 0
hessenberg_kernel.last_plan = None


def qr_parity_blocked_plain(h: torch.Tensor, max_iterations: int, tol: float):
    """B10's plain version in the card's order: blocked Givens sweeps with no
    shift on the whole window (``ops/qr_eig_blocked.py``'s sweep), each
    followed by the stop test ``max|H[i,i-1]| <= tol * (1 + ||H||_F)`` (the
    norm over the upper-Hessenberg part), real data in real arithmetic.
    Returns ``(H, it, converged, maxsub)``; ``H`` is ``qr_parity_plain``'s
    iterate up to a diagonal unitary D (``D^H H D``). Blocks of ``BLOCK``
    rotations, as the kernel's."""
    return _parity_plain(h, max_iterations, tol, BLOCK)


def qr_eig_kernel(h: torch.Tensor, max_sweeps: int, tol: float, accumulate_q: bool = False):
    """B8 on the card: the shifted Givens iteration on a complex64 or
    complex128 Hessenberg matrix, in one launch. Returns ``(eigenvalues,
    sweeps, hi)`` as device tensors, plus ``(T, Q)`` when ``accumulate_q``.
    The plan it ran (``qr_eig_route``) is in ``qr_eig_kernel.last_plan``."""
    return _qr_eig_launch(h, max_sweeps, tol, accumulate_q, None)


def _qr_eig_launch(h: torch.Tensor, max_sweeps: int, tol: float, accumulate_q: bool,
                   block: int | None):
    """``qr_eig_kernel`` with rotations in blocks of ``block`` (1-16; None:
    ``eig_block``): the card tests' and chip_smoke.py's hook for the block
    sizes ``eig_block`` was chosen from."""
    code = check_square("qr_eig_kernel", h, COMPLEX_CODES)
    n = h.shape[0]
    if not 0 <= max_sweeps < 2 ** 31:
        raise ValueError(f"qr_eig_kernel: max_sweeps {max_sweeps} out of int32 range")
    plan = _eig_plan(n, h.dtype, accumulate_q,
                     eig_block(n, h.dtype) if block is None else int(block))
    layout = (ctypes.c_longlong * 13)(*(getattr(plan.layout, f.name)
                                        for f in fields(EigLayout)))
    lib = _build.load()
    t = torch.empty_like(h)
    q = torch.empty_like(h) if accumulate_q else None
    eig = torch.empty(n, dtype=h.dtype, device=h.device)
    state = torch.zeros(2, dtype=torch.int32, device=h.device)
    rc = lib.qr_eig_givens(code, h.device.index, h.data_ptr(), t.data_ptr(), ptr(q),
                           eig.data_ptr(), state.data_ptr(), n, int(max_sweeps), float(tol),
                           plan.block, int(plan.h_smem), ctypes.byref(layout), stream(h))
    raise_on_error("qr_eig_kernel", lib, rc)
    qr_eig_kernel.launches += 1
    qr_eig_kernel.last_plan = plan
    out = (eig, state[0], state[1])
    return out + (t, q) if accumulate_q else out


qr_eig_kernel.launches = 0
qr_eig_kernel.last_plan = None


def qr_decompose_kernel(a: torch.Tensor, kmax: int | None = None, nb: int | None = None):
    """B9 on the card: ``(R, Q)`` with ``A = Q R`` of a square CUDA matrix
    after ``kmax`` reflectors (default n), by panels of ``nb`` columns
    (default ``qr_panel_width``, at most 64). The kernels the call
    enqueued are in ``qr_decompose_kernel.device_launches``."""
    code = check_square("qr_decompose_kernel", a, DTYPE_CODES)
    n = a.shape[0]
    kmax = n if kmax is None else int(kmax)
    nb = qr_panel_width(n, a.dtype) if nb is None else int(nb)
    if not 0 <= kmax <= n:
        raise ValueError(f"qr_decompose_kernel: kmax {kmax} outside [0, {n}]")
    if not 1 <= nb <= 64:
        raise ValueError(f"qr_decompose_kernel: panel width {nb} outside [1, 64]")
    lib = _build.load()
    r, q = torch.empty_like(a), torch.empty_like(a)
    panels = -(-kmax // nb)
    # V, Y, Z; W, Wq, the panel; G, tau; the split-K partials (csrc/qr_kernels.cu)
    scratch = torch.empty(3 * n * n + (panels + 2) * nb * n + nb * nb + nb + 32 * nb * n,
                          dtype=a.dtype, device=a.device)
    count = ctypes.c_longlong(0)
    rc = lib.qr_householder(code, a.device.index, a.data_ptr(), r.data_ptr(), q.data_ptr(),
                            scratch.data_ptr(), n, kmax, nb, ctypes.byref(count), stream(a))
    raise_on_error("qr_decompose_kernel", lib, rc)
    qr_decompose_kernel.launches += 1
    qr_decompose_kernel.device_launches = count.value
    return r, q


qr_decompose_kernel.launches = 0
qr_decompose_kernel.device_launches = 0


def qr_parity_kernel(h: torch.Tensor, max_iterations: int, tol: float):
    """B10 on the card: the unshifted parity iteration on a Hessenberg
    matrix, as cooperative launches of the blocked Givens sweeps
    (``csrc/qr_eig_blocked.cu``) in parity mode, each of up to
    ``SWEEPS_PER_LAUNCH`` sweeps with the stop test on the device; the host
    reads the state once a launch, and ``.device_launches`` counts the last
    call's launches. Returns ``(H, it, converged, maxsub)`` as device
    tensors; ``H`` is the Pallas kernel's iterate up to a diagonal unitary
    D."""
    out, it, conv, maxsub, launches = _parity_kernel(h, max_iterations, tol)
    qr_parity_kernel.launches += 1
    qr_parity_kernel.device_launches = launches
    return out, it, conv, maxsub


qr_parity_kernel.launches = 0
qr_parity_kernel.device_launches = 0

KERNELS = (hessenberg_kernel, qr_eig_kernel, qr_decompose_kernel, qr_parity_kernel,
           hessenberg_blocked_kernel, triangular_eigenvectors_kernel, qr_eig_blocked_kernel)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


# --------------------------------------------------------------------------
# Dispatchers
# --------------------------------------------------------------------------

def hessenberg_reduce(a: torch.Tensor, accumulate_q: bool = False):
    """Householder Hessenberg reduction: the blocked B11 at
    ``n >= HESSENBERG_BLOCKED_MIN_N`` (``solvers/hessenberg.py``), the
    unblocked B7 below it."""
    from ..solvers import hessenberg
    with annotate("eigsol.qr.hessenberg"):
        if a.shape[0] >= hessenberg.HESSENBERG_BLOCKED_MIN_N:
            return hessenberg_blocked(a, accumulate_q)
        if a.device.type == "cpu":
            return hessenberg_plain(a, accumulate_q)
        return hessenberg_kernel(a, accumulate_q)


def qr_eig_sweeps(h: torch.Tensor, max_sweeps: int, tol: float,
                  accumulate_q: bool = False):
    """Shifted Givens QR iteration on a complex Hessenberg matrix (B8)."""
    if h.device.type == "cpu":
        return qr_eig_plain(h, max_sweeps, tol, accumulate_q)
    return qr_eig_kernel(h, max_sweeps, tol, accumulate_q)


def householder_qr(a: torch.Tensor, kmax: int | None = None):
    """Square Householder QR (B9): ``(R, Q)``. The CPU route is the
    unblocked plain version; ``qr_decompose_blocked_plain`` follows the
    card's blocked order."""
    if a.device.type == "cpu":
        return qr_decompose_plain(a, kmax)
    return qr_decompose_kernel(a, kmax)


def parity_sweeps(h: torch.Tensor, max_iterations: int, tol: float):
    """The reference's unshifted QR iteration (B10): on a CPU tensor in the
    Pallas kernel's order (``qr_parity_plain``), on the card B10, whose
    iterate is that one's up to a diagonal unitary D."""
    if h.device.type == "cpu":
        return qr_parity_plain(h, max_iterations, tol)
    return qr_parity_kernel(h, max_iterations, tol)


def accelerated_eigenvalues(a: torch.Tensor, max_sweeps: int, tol: float, sweeps=None):
    """Counterpart of ``qr_eigenvalues_pallas`` (eigenvalues only): B7 (or
    B11), then ``sweeps(h, max_sweeps, tol)`` on the complex Hessenberg
    matrix, which returns ``(eigenvalues, sweeps, hi, ...)``: B8's
    ``qr_eig_sweeps`` by default; ``blocked_eigenvalues`` passes B13's
    ``blocked_sweeps`` or the AED driver. A real matrix reduces in its real
    dtype and is widened to the complex dtype of its precision for the
    sweeps. Returns ``(eigenvalues, sweeps, converged)`` with
    ``converged = hi <= 1``."""
    h = hessenberg_reduce(a)
    if not h.is_complex():
        h = h.to(h.dtype.to_complex())
    eig, count, hi = (sweeps or qr_eig_sweeps)(h, max_sweeps, tol)[:3]
    return eig, host_read(count), host_read(hi) <= 1


def parity_eigenvalues(a: torch.Tensor, max_iterations: int, tol: float):
    """Counterpart of ``qr_parity_pallas``: B7 then B10. Returns
    ``(eigenvalues, iterations, converged, maxsub)`` with the reference's
    count: ``iterations`` is the converging sweep's ``it``, else
    ``max_iterations + 1`` (qr_eigenvalues.hpp:69,104). Real input keeps
    its real dtype (no planes here to widen)."""
    h, it, conv, maxsub = parity_sweeps(hessenberg_reduce(a), max_iterations, tol)
    conv = bool(conv)
    iterations = int(it) if conv else max_iterations + 1
    return h.diagonal().clone(), iterations, conv, float(maxsub)


def triangular_eigenvectors(T: np.ndarray, source_real_dtype=np.float32) -> np.ndarray:
    """Eigenvectors of an upper-triangular matrix by back-substitution, in
    numpy: the host oracle of B14 (JAX ``qr_kernels.py:621-646``).

    Column k solves ``(T - T[k,k] I) y = 0`` with ``y[k] = 1`` and zeros
    below; pivots below ``eps`` of ``source_real_dtype`` (the precision the
    Schur form was computed in) times ``max(max|T|, 1)`` are set to that eps.
    T is taken as complex128."""
    n = T.shape[0]
    V = np.zeros((n, n), np.complex128)
    diag = np.diagonal(T)
    scale = max(np.abs(T).max(), 1.0) if n else 1.0
    eps = np.finfo(np.dtype(source_real_dtype)).eps * scale
    for k in range(n):
        lam = diag[k]
        y = np.zeros(n, np.complex128)
        y[k] = 1.0
        for i in range(k - 1, -1, -1):
            denom = diag[i] - lam
            if abs(denom) < eps:
                denom = eps
            y[i] = -(T[i, i + 1:k + 1] @ y[i + 1:k + 1]) / denom
        V[:, k] = y
    return V


def finish_eigenvectors_device(T: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Eigenvectors from the Schur form ``A = Q T Q^H`` (JAX
    ``qr_kernels.py:537-554``): ``Y`` from B14 with
    ``eps = finfo(real dtype).eps * max(max|T|, 1)``, ``V = Q Y`` (a plain
    product, as the JAX package leaves it to XLA), columns normalised with
    a floor of 1e-30. Column k pairs with ``T[k, k]``."""
    rdt = real_dtype(T.dtype)
    scale = max(float(abs2(T).max().sqrt()), 1.0) if T.numel() else 1.0
    eps = torch.finfo(rdt).eps * scale
    V = Q @ triangular_eigenvectors_device(T, eps)
    return V / abs2(V).sum(dim=0).sqrt().clamp_min(1e-30)


def accelerated_eigenpairs(a: torch.Tensor, max_sweeps: int, tol: float, sweeps=None):
    """Counterpart of ``qr_eigenvalues_pallas(compute_vectors=True)``
    (JAX ``qr_kernels.py:604-618``): the Hessenberg reduction with Q (B7 or
    B11), ``sweeps(h, max_sweeps, tol)`` in Schur mode, which returns
    ``(eigenvalues, sweeps, hi, T, Qs)`` (B8 by default; B13 or the
    Schur-mode AED driver from ``blocked_eigenvalues``), ``Qh Qs`` and the
    eigenvectors (B14). A real matrix reduces in its real dtype and is
    widened to the complex dtype of its precision for the sweeps. Returns
    ``(eigenvalues, sweeps, converged, V)``; column k of ``V`` pairs with
    ``eigenvalues[k]``."""
    h, qh = hessenberg_reduce(a, accumulate_q=True)
    if not h.is_complex():
        h, qh = h.to(h.dtype.to_complex()), qh.to(qh.dtype.to_complex())
    sweeps = sweeps or partial(qr_eig_sweeps, accumulate_q=True)
    eig, count, hi, t, qs = sweeps(h, max_sweeps, tol)
    return eig, host_read(count), host_read(hi) <= 1, finish_eigenvectors_device(t, qh @ qs)
