#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. the card: a CUDA device, its name and power limit, TF32 off;
2. the build: the banded-SpMV CUDA kernels compiled from csrc/ with nvcc;
3. each kernel against its plain PyTorch version on the card, on the bench
   operator (1M rows, 33 diagonals), with its time per call beside the
   plain version's;
4. the main path: ``power_method`` through the public API on interleaved
   and row-major banded operators at 1M rows x 33 diagonals, with a fixed
   budget (held against the loop driven by the plain matvec) and on a
   converging operator (held against scipy's ``eigs`` in float64);
5. the reference data files ``data/A.txt`` (dense) and ``data/B.txt``
   (CSR), complex128 on the card, against ``numpy.linalg.eigvals``;
6. the dense QR kernels B7-B10 against their plain versions on the card:
   Hessenberg (B7, one cluster kernel: its route, a second call with Q
   bitwise equal, one device kernel a call, at 512 in four dtypes and 1023
   in float32, and the cost of one cluster barrier) and Householder QR (B9)
   at n = 512 in float32, complex64 and float64, the blocked B9 also at 512 in complex128 and at 2048 in all
   four dtypes (against ``qr_decompose_blocked_plain`` there, with its
   device kernels per call), the shifted Givens sweeps (B8, with its route)
   and the parity sweeps (B10: against ``qr_parity_blocked_plain`` entry by
   entry and against the Householder order ``qr_parity_plain`` with the
   diagonal unitary D divided out) with a budget of 10 sweeps at n = 128 in
   four dtypes and of a few sweeps at n = 512 in the path's dtypes, each with
   its time beside the plain version's; B10 per sweep at 512 in float32 and
   complex64 with its device kernels a call; B8 at 64, 128 and 256 in
   complex64 without and with Q, per full-window sweep and to convergence on
   the bench operand, and its block sizes 4-16 at those sizes in complex64
   and complex128 (from which ``eig_block`` was set);
7. the QR path through the public API on CUDA tensors at n = 512: the
   bench operand (symmetric, spectrum 0.9^i) in float32 and a complex64
   operand with spectrum 0.9^i e^(i theta) in both modes, a real
   non-symmetric matrix in accelerated mode against numpy in float64, the
   bench operand's construction at 128 in accelerated mode (B8: at most
   ``UNBLOCKED_MAX_N``; B13 beyond it), and the reference demo's QR section
   on ``data/A.txt``, with each parity solve's time, its device kernels
   (torch.profiler) and B10's cooperative launches;
8. the blocked Hessenberg kernel B11 (B12 on complex data) and the
   triangular-eigenvector kernel B14 against their plain versions: B11 with
   Q at n = 4096 float32, 2048 complex64 and 1024 float64 on a
   well-conditioned operand (H and Q entry by entry with the pivot phases
   divided out, ``||A - Q H Q^H||``, ``||Q^H Q - I||``), a second call with Q
   bitwise equal to the first, and against B7 at 512, with B11's device
   kernels per call; B14 at n = 512 and 2048 in complex64 and complex128 on the Schur
   factor of the eigenpair path and on a triangle with one repeated
   eigenvalue; each with its time beside the plain version's;
9. the sweep of B7 against B11 (float32 and complex64, n = 256 ... 4096,
   without and with Q to 2048; three calls a point below 2048) from which
   ``HESSENBERG_BLOCKED_MIN_N`` was set, B11's panel widths at 4096 with its device kernels per call,
   torch.profiler breakdowns of B11 at 4096 (float32, without and with Q)
   and of B12 at 2048 (complex64 with Q), B9 beside
   ``torch.linalg.qr(mode="complete")`` over the same sizes (five calls a
   point, in turns, with B9's device kernels per call), B9's panel widths
   16/32/64 at 512 and 2048 in four dtypes, a profile of one B9 call, and B8
   beside ``torch.linalg.eigvals``;
10. the eigenpair path through the public API on CUDA tensors:
    ``qr_eigenvalues(A, QROptions(mode="accelerated", compute_vectors=True))``
    on (a) the bench operand at 512 in float32, (b) the complex64 operand of
    phase 7, (c) the non-symmetric float32 matrix of phase 7 (B13 at 512),
    (d) the bench operand's construction at 128 (B8) and (e) at 2048 (B11
    and B13), each held to
    its spectrum and to the residual ``max_k ||A v_k - lambda_k v_k|| / ||A||``;
11. ``to_hessenberg`` through the public API at n = 4096 float32 and at
    n = 2048 complex64 (the blocked kernel on real and on complex data);
12. the blocked sweeps B13 against their plain version on the card, complex64
    and complex128, with a budget of a few sweeps and deflation off: Schur
    mode at sizes that straddle block edges (bs - 1, bs + 1, 2 bs + 1), at
    n = 512 and, in complex64, at 2048, a size the path beyond
    ``UNBLOCKED_MAX_N`` gives B13 (T and Q entry by entry,
    ``||H - Q T Q^H||``, ``||Q^H Q - I||``), eigenvalues-only mode and a
    3-shift schedule, with B13's time per sweep beside the plain version's;
13. the sweep that set ``UNBLOCKED_MAX_N``: B8 against B13 in complex64 at
    n = 128 ... 4096, per sweep with the window full and per whole solve on
    the bench operand; B13's block sizes at 4096 and its device kernels per
    call there;
14. the path beyond ``UNBLOCKED_MAX_N`` through ``qr_eigenvalues`` on CUDA
    tensors: eigenvalues of the bench operand at 4096 float32, of the
    complex64 normal operand at 2048 and of a non-symmetric float32 matrix at
    2048 (against numpy in float64), eigenpairs of the bench operand at 2048
    and 4096;
15. the split-plane SpMV (B4, B3's planes entry) and the block SpMM B5
    against their plain versions at 1M x 33, with ``torch.sparse.mm``; B5's
    (nvec, n), (n, 8) and interleaved entries timed by both routes, staged
    and direct, from which ``block_route`` was set;
16. ``power_method`` on the split-plane operators and the block solvers
    ``subspace_iteration`` / ``chebyshev_subspace_iteration`` at 1M x 33;
17. the general sparse SpMV B6 against its plain version on bench.py's
    general operators at 1M rows x 33 entries a row (uniform and local): f32,
    bf16 values, f64, complex64 native and on planes, complex128, by the
    route the dispatch picks, by the CSR route and by the windowed route at
    cluster sizes 1, 2 and 4, and small cases, with every route's time, the
    plain version's and ``torch.sparse.mm``'s side by side; then the uniform
    operator with nine hub rows (``hub_coo``: one of 2^20 entries more, eight
    of 2^17), and 1M rows over 3 x 2^24 + 5 columns with 4,000 rows of
    1,025 to 12,000 entries more (``hub_rect_coo``: chunks run window by
    window), by the CSR route, whose long rows are split over whole blocks,
    in f32 and bf16 values, against the plain version, repeated bit for bit,
    and timed with and without the split (``gell_hub_checks``);
18. the general-sparse path: ``from_coo(layout="auto")`` on bench.py's three
    auto patterns at 100,000, ``power_method`` on each pick and on the
    hand-picked layout, on ``SparseGELL`` at 1M x 33 (budget and a planted
    variant against scipy), on a planted shuffled band through the
    ``PermutedOperator`` (residual in the caller's indexing), on
    ``data/B.txt`` as complex128 ``to_gell()``, and on the complex operator
    through the planes entry;
19. aggressive early deflation (``ops/qr_aed.py``) on the card: eigenvalues
    at 2048 and 4096 of the bench, c64 normal and non-symmetric operands and
    of the uniform-[1, 2] full-rank operand at 2048, eigenpairs of the bench
    operand (float32) and the c64 operand at 2048 and of the bench operand at
    4096, by AED and at 2048 by plain B13 too, each with its sweeps, AED
    rounds, seconds, B7/B8/B11/B13 launches and error or residual against
    phase 14's limits (the JAX package's TPU records printed beside, for
    comparison only); the sweep cut (fewer sweeps under AED than plain B13
    on the non-symmetric matrix at 2048, fewer than n on the full-rank
    operand); ``qr_eigenvalues``' route at 2048 and 4096 against
    ``AED_MIN_N``; and ``qr_eigenvalues`` (accelerated) on ``--aed-table``'s
    4096 uniform-[1, 2] draw, held to 1e-4 (C4);
20. the shifted solves on the card: the demo's sigma = 3.1 and 2.3 on
    ``data/A.txt`` and ``data/B.txt``, dense-LU inverse power at 2048
    float32, BiCGStab inverse power on the planted 1M x 33 band (row-major
    and interleaved) with the shift 1% above its dominant eigenvalue, and
    bench.py's n = 4096 ``SplitComplexDIA`` interior-shift GMRES case
    against scipy's shift-invert ``eigs``, each with iterations, seconds,
    error (and residual) and its SpMV kernel's launches;
21. the Krylov and block eigensolvers at 1M x 33: ``arnoldi_eigenvalues``
    (k = 3, m = 30) on the planted band as ``SparseDIA`` (B2) and
    ``InterleavedDIA`` (B1) with the projection on B8,
    ``krylov_schur_eigenvalues`` (k = 3) on it and as ``SparseGELL`` (B6),
    against scipy's ``eigs``; ``lanczos_eigenvalues`` (LM, LA),
    ``lanczos_eigenpairs`` (residuals within their Ritz bounds plus 1e-5
    ||A||_1) and ``lanczos_thick_restart`` (k = 4) on phase 16's symmetric
    band, and ``lobpcg_eigenvalues`` (k = 4, LA, float64, B5 row-major and
    interleaved) on it, against scipy's ``eigsh``; ``power_method_ds64`` on
    bench.py's ds64 operator at 100,000 and 1M rows against a host float64
    loop to 1e-12 with equal counts; ``write_matrix_to_file`` of a
    100,000-row sparse complex128 and a 512 dense matrix read back exactly;
    the demo's reference flow on the card and its five Krylov/block solvers
    on a 2000-row file the writer produced, within 1e-4 of numpy. Each solve
    prints its seconds, launches and error beside its limit.
22. the distributed layer (``parallel/``, ``io/distributed.py``,
    ``utils/checkpoint.py``) on an NCCL process group of world size 1 (a
    ``file://`` store in a temporary directory; one H100 hosts one NCCL
    rank, so more ranks are proven on gloo CPU ranks by the tests) at 1M
    rows: the interleaved (B1), row-major, ELL and split-plane banded power
    methods on the bench band, ``distributed_gell_power_method`` and
    ``distributed_gell_power_pruned`` (B6) on phase 17's uniform operator,
    each at a budget of 200 iterations against the port's single-device
    solver on the same operator and ``x0``; ``distributed_lanczos_eigenvalues``
    (k = 3, m = 40, LA) on phase 16's symmetric band and
    ``distributed_subspace_iteration`` (k = 2, B5) on the planted band,
    against scipy; ``distributed_arnoldi_eigenvalues`` (k = 3, m = 30) on the
    pruned partition (B6, the projection on B8) and
    ``distributed_krylov_schur_eigenvalues`` on the ELL partition of phase
    18's planted general operator, against scipy's ``eigs``;
    ``distributed_shifted_inverse_power`` (BiCGStab inner solves, phase 20's
    options) on the planted band against scipy and ``solve_shifted_distributed``
    to a residual; and ``distributed_dia_il_power_checkpointed`` and
    ``power_method_checkpointed`` (B2), each run once uninterrupted and once
    stopped after its first chunk and resumed, bit for bit equal; then
    ``load_partitioned`` of ``data/B.txt`` and its dominant eigenvalue. Each
    leg prints its seconds; the group is destroyed at the end of the phase.

The banded kernels' launch counts are zeroed just before phases 4-5 and
read just after, the QR kernels' just before and after phases 7, 10, 14 and
each run of phase 11, each solve of phase 19 and its public solves, the
banded ones again around phase 16 and each solve of phase 20, B6's and
the banded ones around phase 18, and all of them around each solve of phase
21, and all of them around phase 22's solves; each kernel must have run
on its path (phase 22's launches are added to B1's, B2's, B5's, B6's and
B8's rows of the kernels line). The script then
prints one JSON line with each kernel's numbers (time, plain time, the
least time the card could take for the same work, the library call's time
where one PyTorch call computes the same function), the card's name and
power limit, and last the line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.

    python3 chip_smoke.py --b6-host ROOT

runs only the host side of B6 with the port found under ROOT (another
checkout, so that two commits can be compared in one call, in turns):
the time to enqueue one ``gell_kernel`` call on the 1M x 33 uniform
operator in float32 and complex64, and ``power_method``'s time per
iteration on each at a budget of 200 iterations, three times each.

    python3 chip_smoke.py --b6 ROOT

times B6 with the port found under ROOT on the 1M x 33 uniform operator in
float32, by the route the pack picks and by the CSR route, and on the same
operator with hub rows (``hub_coo``) by the CSR route (CUDA-graph replay,
the best of two), three times each.

    python3 chip_smoke.py --b7 ROOT

times B7 with the port found under ROOT, without Q and with Q, over five
calls after a warm-up between two CUDA events, at 512 float32, complex64 and
float64, 256 and 1023 float32, with its device kernels per call
(torch.profiler).

    python3 chip_smoke.py --b5 ROOT

times B5 with the port found under ROOT at 1M x 33 with 8 vectors in
float32, bf16, float64 and complex64 (the bench band's values): row-major,
interleaved from a window, and the block solvers' product on an (n, 8)
block (``solvers/subspace.py::_apply_block``), by CUDA-graph replay; then
the block solvers of phase 16 at a fixed budget, and the device's busy
share of a 10-sweep subspace chunk.

    python3 chip_smoke.py --b11 ROOT

times B11 (B12 on complex data) with the port found under ROOT, with Q and
without, over three calls after a warm-up between two CUDA events, at
4096 float32, 2048 complex64, 1024, 2048 and 512 float32, with its device
kernels per call where the port counts them.

    python3 chip_smoke.py --b13 ROOT

times B13 with the port found under ROOT: a full-window sweep (4 sweeps a
call, deflation off) at 512, 2048 and 4096 complex64 in eigenvalues-only and
Schur mode, with its device kernels per call (torch.profiler), and phase
14's non-symmetric float32 solve at 2048 through ``qr_eigenvalues`` (twice);
for a port whose B13 is one cooperative launch, also B13's block sizes at
2048 and 4096.

    python3 chip_smoke.py --b14 ROOT

times B14 with the port found under ROOT at 512 and 2048 in complex64 and
complex128 on a random triangle (CUDA-graph replay), with its device kernels
per call.

    python3 chip_smoke.py --b10 ROOT

times B10 with the port found under ROOT: per sweep at 128 and 512 in
float32 and complex64 (device kernels a call at 128), phase 7's parity
solves at 512 through ``qr_eigenvalues`` (twice each) with B10's cooperative
launches where the port counts them, and B9 at 512, 2048 and 4096 float32
with its device kernels a call and whether a second call repeats bit for bit.

    python3 chip_smoke.py --aed-table

prints the table that set ``AED_MIN_N``, ``SCHUR_AED_MIN_N`` and the AED
window and sweeps a round (``ops/qr_eig_blocked.py``, ``ops/qr_aed.py``):
AED against plain B13 at 1024, 2048 and 4096 on the bench, c64 normal,
non-symmetric and uniform-[1, 2] operands, AED-Schur against the
monolithic Schur driver at 2048 and 4096 on the bench and non-symmetric
operands (each pair timed in turns, AED, plain, plain, AED, the lower of
each kept), and at 2048 the windows 64, 128 and 256 against the sweeps a
round 16, 32, 96 and 256 on the non-symmetric operand and two uniform-[1, 2]
operands; C4's backward-error rows (as ``--c4`` prints them: plain B13 at
each size on the uniform-[1, 2] operand, AED at 4096); then the constants
the rule gives (the smallest size from which plain B13 misses phase 14's
limit on any operand, or AED is no slower on every one), and the default
window and sweeps a round: the pair of least time summed over the three
operands among those whose AED solve takes fewer sweeps than plain B13 on
the non-symmetric operand and at most ``SWEEP_CUT_MARGIN`` n on both
uniform-[1, 2] operands, so that the sweep cut (fewer than n), which phase 19
checks at the defaults on an operand of its own, holds on other draws.

    python3 chip_smoke.py --c4

prints C4's rows on the uniform-[1, 2] operands of ``--aed-table`` (the
same draws): at 4096 the eigenvalues-only error by plain B13 and by AED,
the backward error ``||A - Q T Q^H||_F / ||A||_F`` of the Schur form by
plain B13, by AED and by plain B13 on the same matrix in complex128, and
its growth over the sweeps of one solve; at 1024 and 2048 the backward
error by plain B13 (``--aed-table`` prints the same rows at its end).

    python3 chip_smoke.py --krylov

runs phase 21 alone, with its own scipy references.

    python3 chip_smoke.py --distributed

runs phase 22 alone, with its own scipy references.

    python3 chip_smoke.py --b8 ROOT

times B8 with the port found under ROOT at 64, 128 and 256 in complex64,
without and with Q: per full-window sweep (10 sweeps a call, deflation off)
and to convergence on the bench operand's construction, with its device
kernels per call.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 1_000_000
BANDWIDTH = 16  # 33 diagonals: the operator of bench.py --n 1000000
KERNEL_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/dia_spmv.cu"
TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/dia_spmv.py"
TPU_POWER = "pcsc_eigenvalue_solver_project_tpu/solvers/power.py"
QR_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/qr_kernels.cu"
B7_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/hessenberg_cluster.cu"
QR_TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_kernels.py"
QR_N = 512        # BASELINE.json configs[2]: 512 x 512 dense, all eigenvalues
QR_SWEEP_N = 128  # B8/B10 against their plain versions (thousands of launches a sweep)
QR_TOL = 3e-6     # bench.py's QR tolerance
HB_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/hessenberg_blocked.cu"
HB_TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/hessenberg_blocked.py"
TRI_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/trisolve_vec.cu"
TRI_TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/trisolve_vec.py"
SWEEP_SIZES = (256, 512, 768, 1024, 1536, 2048, 4096)  # B7 against B11
FULL_N = 4096   # B11's row, its panel widths, to_hessenberg in float32
LARGE_N = 2048  # B12's row, B14's second size, eigenpair run (e), B9's second size
B9_REPS = 5     # B9 and torch.linalg.qr: calls per timed point
B11_REPS = 3    # B11 in the B7-against-B11 sweep: calls per timed point
QRB_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/qr_eig_blocked.cu"
QRB_TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_eig_blocked.py"
BOUNDARY_SIZES = (128, 256, 512, 1024, 2048, 4096)  # B8 against B13
B13_SWEEPS = 3  # B13 against its plain version at n >= 512 (the plain version is slow)
NONSYM_MAX_N = 1024  # whole non-symmetric solves in the boundary sweep (B8 is slow beyond)
GELL_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/gell_spmv.cu"
GELL_WINDOW_SOURCE = "pcsc_eigenvalue_solver_project_tpu_torch/csrc/gell_window_spmv.cu"
GELL_TPU_KERNELS = "pcsc_eigenvalue_solver_project_tpu/ops/pallas/gell_spmv.py"
GELL_PER_ROW = 33  # bench.py --general: 1M rows x 33 entries a row
GELL_HUBS = (1 << 20,) + (1 << 17,) * 8  # hub rows added to the uniform operator
# the rectangle with long rows: 3 windows of the split and a bit, and this
# many rows of 1025 to 12,000 entries more
HUB_RECT_COLS = 3 * (1 << 24) + 5
HUB_RECT_ROWS = 4000
AUTO_N = 100_000   # bench.py's auto leg (BENCH_R05_SET.jsonl:8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}  # H100 SXM data sheet, outside the tensor cores
AED_SIZES = (1024, 2048, 4096)  # --aed-table: AED against plain B13
AED_WINDOWS = (64, 128, 256)    # --aed-table: the window at 2048
AED_ROUND_SWEEPS = (16, 32, 96, 256)  # --aed-table: the sweeps between two rounds at 2048
# --aed-table: the defaults' sweeps on the uniform-[1, 2] operands at most
# this share of n. One setting's sweeps differ by up to 14% between two draws
# of the operand (1862 in the table, 2132 in phase 19, at w = 128 and 32
# sweeps a round on the H100), so a pair that only just meets the cut in
# the table can miss it in phase 19.
SWEEP_CUT_MARGIN = 0.85
# The JAX package's errors on its TPU (BENCH_R05_SET.jsonl:11,13,16,18-20),
# printed beside the port's for comparison only: f32 uniform-[1, 2] at 2048,
# c64 at 2048 and 4096, eigenpair residuals.
TPU_RECORDS = {"f32 2048": 1.1e-5, "c64 2048": 4.8e-5, "c64 4096": 7.1e-5,
               "eigenpairs": (1.3e-6, 4.3e-6)}



def check(cond, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def rel_err(y, y_ref) -> float:
    return float((y - y_ref).abs().max() / y_ref.abs().max())


def time_ms(fn, reps: int = 50) -> float:
    """Mean device time per call over ``reps`` calls, after a warm-up.

    The calls are captured once into a CUDA graph and timed as one replay,
    so the host's speed at launching them does not enter the number."""
    import torch
    for _ in range(3):  # builds, caches, allocator
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_events_ms(fn, reps: int = 3) -> float:
    """Mean time per call over ``reps`` calls between two CUDA events, after
    a warm-up: for work that reads the device from the host and so cannot
    be captured in a graph."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn):
    """The device kernels one call of ``fn`` runs, by torch.profiler; None
    when the profiler records no device activity (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kineto's own list: prof.events() can miss a cooperative launch
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return names or None


def timed_pair(kernel_fn, plain_fn, timer=time_ms, plain_timer=None):
    """Kernel and plain time per call, taken in turns (plain, kernel,
    kernel, plain); the lower of each pair. ``plain_timer`` (default
    ``timer``) times the plain version."""
    plain_timer = plain_timer or timer
    p1 = plain_timer(plain_fn)
    k1 = timer(kernel_fn)
    k2 = timer(kernel_fn)
    p2 = plain_timer(plain_fn)
    return min(k1, k2), min(p1, p2)


def bound(nbytes: float, flops: float, peak: float = PEAK_FLOPS["f32"]):
    """The least time the card could take (ms) and what bounds it: the bytes
    moved (each input read once, each output written once) over the memory
    rate, or the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_operand(rng, n, dt, dev, kind):
    """numpy-seeded operands built on the card: ``"gaussian"``;
    ``"well_conditioned"``, U diag(uniform[1, 2]) V^H with random unitary U
    and V (cond <= 2); ``"geometric"``, bench.py's (Q * 0.9^i) Q^T (complex:
    Q diag(0.9^i e^(i theta)) Q^H). Returns (matrix, planted spectrum)."""
    import torch

    def gaussian():
        g = rng.standard_normal((n, n))
        if dt.is_complex:
            g = g + 1j * rng.standard_normal((n, n))
        return torch.from_numpy(g).to(dev)

    if kind == "gaussian":
        return gaussian().to(dt), None
    u, _ = torch.linalg.qr(gaussian())
    if kind == "well_conditioned":
        v, _ = torch.linalg.qr(gaussian())
        s = torch.from_numpy(rng.uniform(1, 2, n)).to(dev)
        return ((u * s) @ v.conj().T).to(dt), None
    d = 0.9 ** np.arange(n)
    if dt.is_complex:
        d = d * np.exp(1j * rng.uniform(0, 2 * np.pi, n))
    return ((u * torch.from_numpy(d).to(dev)) @ u.conj().T).to(dt), d


def band_csr(vals, offsets):
    """The CSR form of the row-indexed DIA band (y[i] = sum_d vals[d, i]
    x[i + off_d]), for the library SpMV."""
    import torch
    k, n = vals.shape
    rows = torch.arange(n, device=vals.device)
    cols = rows[:, None] + torch.tensor(offsets, device=vals.device)[None, :]  # (n, k)
    keep = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals.T[keep], (n, n))


def planted_band(n, dtype, seed):
    """A 33-diagonal band with a planted dominant diagonal (14, 10, 8 on the
    first three rows, as __graft_entry__.py plants them), as numpy data
    (k, n) in the row-indexed DIA convention."""
    rng = np.random.default_rng(seed)
    k = 2 * BANDWIDTH + 1
    data = rng.uniform(-1, 1, (k, n))
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.uniform(-1, 1, (k, n))
    data = data.astype(dtype)
    data[BANDWIDTH, :3] = (14.0, 10.0, 8.0)
    for d, off in enumerate(range(-BANDWIDTH, BANDWIDTH + 1)):
        if off > 0:
            data[d, n - off:] = 0
        elif off < 0:
            data[d, :-off] = 0
    return data


def scipy_dominant(data: np.ndarray, offsets) -> complex:
    """Dominant eigenvalue of the DIA operator by ARPACK in float64."""
    return complex(scipy_top(data, offsets, 1)[0])


def scipy_top(data: np.ndarray, offsets, k: int, which: str = "LM",
              symmetric: bool = False) -> np.ndarray:
    """k eigenvalues of the DIA operator by ARPACK in float64 (``eigsh`` for
    a symmetric operator)."""
    from scipy.sparse.linalg import LinearOperator, eigs, eigsh
    n = data.shape[1]
    dt = np.complex128 if data.dtype.kind == "c" else np.float64
    vals = data.astype(dt)

    def matvec(x):
        x = np.asarray(x, dt).reshape(-1)
        y = np.zeros(n, dtype=np.result_type(dt, x.dtype))
        for d, off in enumerate(offsets):
            if off >= 0:
                y[:n - off] += vals[d, :n - off] * x[off:]
            else:
                y[-off:] += vals[d, -off:] * x[:off]
        return y

    op = LinearOperator((n, n), matvec=matvec, dtype=dt)
    if symmetric:
        return eigsh(op, k=k, which=which, v0=np.ones(n, dt), ncv=max(2 * k + 1, 20),
                     return_eigenvectors=False)
    return eigs(op, k=k, which=which, v0=np.ones(n, dt), ncv=max(2 * k + 1, 20),
                return_eigenvectors=False)


def nearest_err(got, want) -> float:
    """Max distance under greedy nearest-neighbour matching of two spectra."""
    got, worst = list(np.asarray(got)), 0.0
    for w in np.asarray(want):
        j = int(np.argmin(np.abs(np.asarray(got) - w)))
        worst = max(worst, abs(got[j] - w))
        got.pop(j)
    return float(worst)


def unit_phase(z: np.ndarray) -> np.ndarray:
    """z/|z| elementwise, 1 where z = 0 (signs for real z)."""
    m = np.abs(z)
    return np.where(m > 0, z / np.where(m > 0, m, 1), 1)


def hessenberg_phases(h, hp) -> np.ndarray:
    """The diagonal unitary D, with D[0] = 1, for which h = D^H hp D, read
    off the subdiagonals. A Hessenberg form with Q e_1 = e_1 is unique up to
    such a D (and then Q = Qp D), and so is the QR iterate of B10."""
    r = unit_phase(hp.diagonal(-1).cpu().numpy()) / unit_phase(h.diagonal(-1).cpu().numpy())
    return np.concatenate([[1], np.cumprod(r)])


def q_phases(q, qp) -> np.ndarray:
    """D with q = qp D for unitary q, qp, from their columns (q_j^H qp_j
    over its modulus): where D is defined, without the subdiagonals' phase
    ratios multiplying their rounding along the pivots."""
    d = (qp.conj() * q).sum(dim=0)
    return (d / d.abs()).cpu().numpy()


def triangular_phases(r, rp) -> np.ndarray:
    """The diagonal unitary D for which R = D Rp (and then Q = Qp D^H): a QR
    decomposition of a matrix of full rank is unique up to such a D."""
    return unit_phase(r.diagonal().cpu().numpy()) / unit_phase(rp.diagonal().cpu().numpy())


def qr_kernel_phase(dev, card_name, card_limit):
    """Phase 6: B7-B10 against their plain versions on the card. Returns
    {tag: max abs error} and {tag: (kernel ms, plain ms, unit)}."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    rng = np.random.default_rng(10)
    errors, timings = {}, {}

    def gaussian(n, dt):
        a = rng.standard_normal((n, n))
        if dt.is_complex:
            a = a + 1j * rng.standard_normal((n, n))
        return a

    def operand(n, dt):
        return torch.from_numpy(gaussian(n, dt)).to(dev, dt)

    def well_conditioned(n, dt):
        """U diag(uniform[1, 2]) V^H with random unitary U and V: cond <= 2."""
        u, _ = np.linalg.qr(gaussian(n, dt))
        v, _ = np.linalg.qr(gaussian(n, dt))
        return torch.from_numpy((u * rng.uniform(1, 2, n)) @ v.conj().T).to(dev, dt)

    def rel(x, y, scale):
        return float((x - y).abs().max()) / scale

    # B7 and B9 at n = 512 on a well-conditioned operand. Limits relative to
    # max|A| (Q: to 1), all one unit of 1e-6 * n in single precision (1e-14 * n
    # in double). H, R and Q are unique only up to a diagonal unitary D (signs
    # for real data); each entry of D is the phase of a pivot, which moves by
    # about eps / |pivot| and so by up to ~1e-2 at one small pivot in complex64.
    # The entries are held to one unit after D is divided out, and D to 1 within
    # 0.2 (1e-6 in double), which still fails a wrong phase convention or sign.
    # B7's D is read from Q's columns (q = qp D), B9's from R's diagonal.
    for dt in (torch.float32, torch.complex64, torch.float64):
        a = well_conditioned(QR_N, dt)
        scale = float(a.abs().max())
        double = dt == torch.float64
        unit = (1e-14 if double else 1e-6) * QR_N
        eye = torch.eye(QR_N, dtype=dt, device=dev)
        h, q = qk.hessenberg_kernel(a, accumulate_q=True)
        hp, qp = qk.hessenberg_plain(a, accumulate_q=True)
        r, qq = qk.qr_decompose_kernel(a)
        rp, qqp = qk.qr_decompose_plain(a)
        torch.cuda.synchronize()
        dh, dr = q_phases(q, qp), triangular_phases(r, rp)
        dh_t, dr_t = (torch.from_numpy(d).to(dev, dt) for d in (dh, dr))
        checks = {
            "B7 H vs plain": (rel(h, dh_t.conj()[:, None] * hp * dh_t, scale), unit),
            "B7 Q vs plain": (rel(q, qp * dh_t, 1.0), unit),
            "B7 phases |D - 1|": (float(np.abs(dh - 1).max()), 1e-6 if double else 0.2),
            "B7 |A - Q H Q^H|": (rel(q @ h @ q.conj().T, a, scale), unit),
            "B7 |Q^H Q - I|": (rel(q.conj().T @ q, eye, 1.0), unit),
            "B7 below subdiagonal": (float(torch.tril(h, -2).abs().max()) / scale, unit),
            "B9 R vs plain": (rel(r, dr_t[:, None] * rp, scale), unit),
            "B9 Q vs plain": (rel(qq, qqp * dr_t.conj(), 1.0), unit),
            "B9 phases |D - 1|": (float(np.abs(dr - 1).max()), 1e-6 if double else 0.2),
            "B9 |A - Q R|": (rel(qq @ r, a, scale), unit),
            "B9 |Q^H Q - I|": (rel(qq.conj().T @ qq, eye, 1.0), unit),
            "B9 below diagonal": (float(torch.tril(r, -1).abs().max()) / scale, unit)}
        for label, (err, limit) in checks.items():
            print(f"check {label} {dt} n={QR_N}: {err:.3e} (limit {limit:.1e})")
            check(err <= limit, f"{label} {dt}: {err:.3e} above {limit:.1e}")
        check(bool(torch.isfinite(h).all()) and bool(torch.isfinite(r).all()),
              f"B7/B9 {dt}: non-finite output")
        if dt == torch.float32:
            errors["B7"] = float((h - dh_t.conj()[:, None] * hp * dh_t).abs().max())
            errors["B9"] = float((r - dr_t[:, None] * rp).abs().max())
        if dt != torch.float64:
            timings[("B7", dt)] = timed_pair(lambda: qk.hessenberg_kernel(a),
                                             lambda: qk.hessenberg_plain(a),
                                             lambda fn: time_ms(fn, reps=3)) + ("call",)
            timings[("B9", dt)] = timed_pair(lambda: qk.qr_decompose_kernel(a),
                                             lambda: qk.qr_decompose_plain(a),
                                             lambda fn: time_ms(fn, reps=3)) + ("call",)
    # B7 as one cluster kernel: its plan (cluster size; H and Q in shared
    # memory or through L2), a second call with Q bitwise equal to the first,
    # the device kernels a call (one: the copy of A and Q's identity are in
    # it), and its time with Q; at 512 in four dtypes and at 1023 in float32
    # (H through L2)
    for n, dt in ((QR_N, torch.float32), (QR_N, torch.complex64), (QR_N, torch.float64),
                  (QR_N, torch.complex128), (1023, torch.float32)):
        a = operand(n, dt)
        h1, q1 = qk.hessenberg_kernel(a, accumulate_q=True)
        plan = qk.hessenberg_kernel.last_plan
        h2, q2 = qk.hessenberg_kernel(a, accumulate_q=True)
        torch.cuda.synchronize()
        same = torch.equal(h1, h2) and torch.equal(q1, q2)
        kernels = device_kernels(lambda: qk.hessenberg_kernel(a, accumulate_q=True))
        count = "not measured" if kernels is None else len(kernels)
        print(f"B7 {dt} n={n}: route {plan}; H and Q of a second call bitwise equal: {same}; "
              f"device kernels a call with Q: {count} {sorted(set(kernels or []))}")
        check(same, f"B7 {dt} n={n}: a second call differs")
        check(kernels is None or len(kernels) == 1,
              f"B7 {dt} n={n}: {count} device kernels a call, expected 1")
        if n == QR_N and dt in (torch.float32, torch.complex64):
            timings[("B7+Q", dt)] = timed_pair(
                lambda: qk.hessenberg_kernel(a, accumulate_q=True),
                lambda: qk.hessenberg_plain(a, accumulate_q=True),
                lambda fn: time_ms(fn, reps=3)) + ("call",)
        del a, h1, q1, h2, q2
    for cluster in qk.HESSENBERG_CLUSTERS:
        one = time_events_ms(lambda: qk.cluster_barrier_probe(dev, cluster, 1), 5)
        many = time_events_ms(lambda: qk.cluster_barrier_probe(dev, cluster, 10_001), 5)
        print(f"cluster barrier, {cluster} blocks of 512 threads: "
              f"{(many - one) / 10_000 * 1e6:.1f} ns a barrier [{card_name}, {card_limit}]")
    # the blocked B9 in the dtype phase 6 had not held yet (complex128 at 512,
    # against the unblocked plain version) and at 2048 in all four dtypes
    # against the plain version of the blocked algorithm, with the same limits
    # but for D: at 2048 a pivot whose entry before its reflection is small
    # has a phase that rounding sets (its split-K sums also run in another
    # order each call; 0.186 and 0.365 on one complex64 operand in two runs),
    # so D is held as phase 8 holds B11's at 2048, by the median over the
    # pivots (1e-2, 1e-9 in double), which a wrong convention fails; R and Q
    # are held entry by entry once D is divided out
    for n, dt in ((QR_N, torch.complex128),) + tuple(
            (LARGE_N, d) for d in (torch.float32, torch.float64, torch.complex64,
                                   torch.complex128)):
        a = well_conditioned(n, dt)
        scale = float(a.abs().max())
        double = dt in (torch.float64, torch.complex128)
        unit = (1e-14 if double else 1e-6) * n
        eye = torch.eye(n, dtype=dt, device=dev)
        r, qq = qk.qr_decompose_kernel(a)
        launches = qk.qr_decompose_kernel.device_launches
        plain = qk.qr_decompose_plain if n == QR_N else qk.qr_decompose_blocked_plain
        rp, qqp = plain(a)
        torch.cuda.synchronize()
        dr = triangular_phases(r, rp)
        dr_t = torch.from_numpy(dr).to(dev, dt)
        phase = (("B9 phases |D - 1|", float(np.abs(dr - 1).max()), 1e-6 if double else 0.2)
                 if n == QR_N else ("B9 median pivot phase |D_k - 1|",
                                    float(np.median(np.abs(dr - 1))), 1e-9 if double else 1e-2))
        print(f"B9 {dt} n={n}: max |D - 1| {np.abs(dr - 1).max():.3e}")
        checks = {
            "B9 R vs plain": (rel(r, dr_t[:, None] * rp, scale), unit),
            "B9 Q vs plain": (rel(qq, qqp * dr_t.conj(), 1.0), unit),
            phase[0]: phase[1:],
            "B9 |A - Q R|": (rel(qq @ r, a, scale), unit),
            "B9 |Q^H Q - I|": (rel(qq.conj().T @ qq, eye, 1.0), unit),
            "B9 below diagonal": (float(torch.tril(r, -1).abs().max()) / scale, unit)}
        for label, (err, limit) in checks.items():
            print(f"check {label} {dt} n={n} (against {plain.__name__}, {launches} device "
                  f"kernels): {err:.3e} (limit {limit:.1e})")
            check(err <= limit, f"{label} {dt} n={n}: {err:.3e} above {limit:.1e}")
        check(bool(torch.isfinite(r).all()) and bool(torch.isfinite(qq).all()),
              f"B9 {dt} n={n}: non-finite output")
        del a, r, qq, rp, qqp
    # B8 and B10 with deflation off (tol 0), so that both versions run the same
    # iterates: 10 sweeps at n = 128 in every dtype (timed there), and at the
    # path's n = 512 in its dtypes, B8 for 3 sweeps and B10 for 7. B10's
    # Givens iterate is held entry by entry to its plain version in its order
    # (qr_parity_blocked_plain) and to the Pallas order (qr_parity_plain,
    # Householder sweeps) with the diagonal unitary D divided out, both to ten
    # units, with the same count.
    sweeps = 10
    cases = [(QR_SWEEP_N, dt, sweeps, sweeps) for dt in
             (torch.complex64, torch.float32, torch.complex128, torch.float64)]
    cases += [(QR_N, torch.complex64, 3, 7), (QR_N, torch.float32, None, 7)]
    for n, dt, b8_sweeps, b10_sweeps in cases:
        h = qk.hessenberg_plain(operand(n, dt))
        scale = float(h.abs().max())
        unit = (1e-14 if dt in (torch.float64, torch.complex128) else 1e-6) * n
        timed = n == QR_SWEEP_N and dt in (torch.float32, torch.complex64)
        if dt.is_complex:
            e, s, hi, t, q = qk.qr_eig_kernel(h, b8_sweeps, 0.0, accumulate_q=True)
            plan = qk.qr_eig_kernel.last_plan
            ep, sp, hip, tp, _ = qk.qr_eig_plain(h, b8_sweeps, 0.0, accumulate_q=True)
            torch.cuda.synchronize()
            err, res = rel(t, tp, scale), rel(q @ t @ q.conj().T, h, scale)
            print(f"check B8 {dt} n={n} ({plan}), {b8_sweeps} sweeps: T vs plain {err:.3e} "
                  f"(limit {10 * unit:.1e}), |H - Q T Q^H| {res:.3e} (limit {unit:.1e}), "
                  f"sweeps {int(s)}/{int(sp)}, hi {int(hi)}/{int(hip)}")
            check(int(s) == int(sp) == b8_sweeps and int(hi) == int(hip),
                  f"B8 {dt} n={n}: counts differ")
            check(err <= 10 * unit and res <= unit, f"B8 {dt} n={n}: off its plain version")
            if timed:
                errors["B8"] = float((e - ep).abs().max())
                k_ms, p_ms = timed_pair(lambda: qk.qr_eig_kernel(h, sweeps, 0.0),
                                        lambda: qk.qr_eig_plain(h, sweeps, 0.0),
                                        lambda fn: time_events_ms(fn, reps=2))
                timings[("B8", dt)] = (k_ms / sweeps, p_ms / sweeps, "sweep")
        H, it, c, m = qk.qr_parity_kernel(h, b10_sweeps, 0.0)
        G, itg, cg, mg = qk.qr_parity_blocked_plain(h, b10_sweeps, 0.0)
        Hp, itp, cp, mp = qk.qr_parity_plain(h, b10_sweeps, 0.0)
        torch.cuda.synchronize()
        d = torch.from_numpy(hessenberg_phases(H, Hp)).to(dev, dt)
        err, err_d = rel(H, G, scale), rel(H, d.conj()[:, None] * Hp * d, scale)
        print(f"check B10 {dt} n={n}, {b10_sweeps} sweeps: H vs plain {err:.3e}, vs the "
              f"Householder order with D divided out {err_d:.3e} (limit {10 * unit:.1e}), "
              f"it {int(it)}/{int(itg)}/{int(itp)}, maxsub {float(m):.6e}/{float(mg):.6e}/"
              f"{float(mp):.6e}, cooperative launches {qk.qr_parity_kernel.device_launches}")
        check(int(it) == int(itg) == int(itp) == b10_sweeps and not bool(c) and not bool(cp),
              f"B10 {dt} n={n}: counts differ")
        check(H.dtype == dt and err <= 10 * unit and err_d <= 10 * unit,
              f"B10 {dt} n={n}: off its plain versions")
        if timed:
            if dt == torch.float32:
                errors["B10"] = float((H - G).abs().max())
            k_ms, p_ms = timed_pair(lambda: qk.qr_parity_kernel(h, sweeps, 0.0),
                                    lambda: qk.qr_parity_blocked_plain(h, sweeps, 0.0),
                                    lambda fn: time_events_ms(fn, reps=2))
            timings[("B10", dt)] = (k_ms / sweeps, p_ms / sweeps, "sweep")
    # B10 per sweep at the path's size (the plain versions, held against the
    # kernels above, are timed at n = 128 only)
    for dt in (torch.float32, torch.complex64):
        h512 = qk.hessenberg_kernel(operand(QR_N, dt))
        k_ms = time_events_ms(lambda: qk.qr_parity_kernel(h512, 4 * sweeps, 0.0), 2)
        kernels = device_kernels(lambda: qk.qr_parity_kernel(h512, 4 * sweeps, 0.0))
        print(f"time B10 {dt} n={QR_N}: kernel {k_ms / (4 * sweeps):.4f} ms/sweep ({4 * sweeps} "
              f"sweeps a call, device kernels a call "
              f"{'not measured' if kernels is None else len(kernels)}) [{card_name}, {card_limit}]")
    # B8 at AED's window sizes, per full-window sweep and to convergence on
    # the bench operand's construction, without and with Q, by its route
    rng8 = np.random.default_rng(8)
    for n in (64, QR_SWEEP_N, 256):
        h = qk.hessenberg_plain(operand(n, torch.complex64))
        hg, _ = device_operand(rng8, n, torch.float32, dev, "geometric")
        hg = qk.hessenberg_reduce(hg).to(torch.complex64)
        line = f"time B8 complex64 n={n}:"
        for q in (False, True):
            k_ms = time_events_ms(lambda: qk.qr_eig_kernel(h, sweeps, 0.0, accumulate_q=q), 2)
            plan = qk.qr_eig_kernel.last_plan
            solve = time_events_ms(lambda: qk.qr_eig_kernel(hg, 20 * n, QR_TOL, accumulate_q=q), 2)
            _, s8, hi8 = qk.qr_eig_kernel(hg, 20 * n, QR_TOL, accumulate_q=q)[:3]
            check(int(hi8) <= 1, f"B8 n={n}: the bench operand did not converge")
            line += (f" {'with' if q else 'without'} Q {k_ms / sweeps:.4f} ms/sweep, bench "
                     f"operand {solve:.3f} ms ({int(s8)} sweeps; H in "
                     f"{'shared' if plan.h_smem else 'global'} memory, bs {plan.block});")
        kernels = device_kernels(lambda: qk.qr_eig_kernel(h, sweeps, 0.0, accumulate_q=True))
        print(f"{line} device kernels a call {'not measured' if kernels is None else len(kernels)}"
              f" [{card_name}, {card_limit}]")
    # the block sizes from which eig_block was set: ms per full-window sweep
    for dt in (torch.complex64, torch.complex128):
        for n in (64, QR_SWEEP_N, 256):
            h = qk.hessenberg_plain(operand(n, dt))
            line = f"block sizes B8 {dt} n={n}, ms a sweep without (with) Q:"
            for bs in (4, 8, 12, 16):
                a0 = time_events_ms(lambda: qk._qr_eig_launch(h, sweeps, 0.0, False, bs), 1)
                a1 = time_events_ms(lambda: qk._qr_eig_launch(h, sweeps, 0.0, True, bs), 1)
                line += f" {bs}: {a0 / sweeps:.4f} ({a1 / sweeps:.4f});"
            print(f"{line} eig_block {qk.eig_block(n, dt)} [{card_name}, {card_limit}]")
    for (tag, dt), (k_ms, p_ms, unit) in timings.items():
        n = QR_N if tag in ("B7", "B7+Q", "B9") else QR_SWEEP_N
        print(f"time {tag} {dt} n={n}: kernel {k_ms:.3f} ms/{unit}, plain {p_ms:.3f} ms/{unit} "
              f"[{card_name}, {card_limit}]")
    return errors, timings


def blocked_kernel_phase(dev, card_name, card_limit):
    """Phase 8: B11 (B12 on complex data) and B14 against their plain
    versions on the card. Returns {tag: max abs error} and
    {tag: (kernel ms, plain ms, n, dtype)} for the kernel rows."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import trisolve_vec as tv

    rng = np.random.default_rng(20)
    errors, timings = {}, {}

    def report(label, err, limit):
        print(f"check {label}: {err:.3e} (limit {limit:.1e})")
        check(err <= limit, f"{label}: {err:.3e} above {limit:.1e}")

    def hold_reduction(tag, a, h, q, hp, qp, units=1.0):
        """h, q against hp, qp with the pivot phases D divided out; limits
        in units of 1e-6 n (1e-14 n in double) relative to max|A| (Q: 1).
        The phase convention is held by the median over the pivots of the
        phase ratio r_k (D = cumprod r): |r_k - 1| <= 1e-2 (1e-9 in double).
        Each r_k is 1 to rounding but for a few late pivots, whose phases
        single-precision complex leaves O(0.1) apart (B7 in complex64 against
        complex128 on the CPU: up to 0.17 at n = 1024), so D itself drifts
        from 1 at large n; a wrong convention moves most r_k by O(1)."""
        n, dt = a.shape[0], a.dtype
        double = dt in (torch.float64, torch.complex128)
        unit = (1e-14 if double else 1e-6) * n
        scale = float(a.abs().max())
        eye = torch.eye(n, dtype=dt, device=dev)
        d = hessenberg_phases(h, hp)
        d_t = torch.from_numpy(d).to(dev, dt)
        h_err = float((h - d_t.conj()[:, None] * hp * d_t).abs().max())
        ratio = np.abs(d[1:] / np.concatenate([[1], d[1:-1]]) - 1) if n > 2 else np.zeros(1)
        print(f"{tag} {dt} n={n}: max |D - 1| {np.abs(d - 1).max():.3e}, "
              f"max |r_k - 1| {ratio.max():.3e}")
        checks = {"H vs reference": (h_err / scale, units * unit),
                  "Q vs reference": (float((q - qp * d_t).abs().max()), units * unit),
                  "median pivot phase |r_k - 1|": (float(np.median(ratio)),
                                                   1e-9 if double else 1e-2),
                  "|A - Q H Q^H|": (float((q @ h @ q.conj().T - a).abs().max()) / scale, unit),
                  "|Q^H Q - I|": (float((q.conj().T @ q - eye).abs().max()), unit),
                  "below subdiagonal": (float(torch.tril(h, -2).abs().max()), 0.0)}
        for label, (err, limit) in checks.items():
            report(f"{tag} {label} {dt} n={n}", err, limit)
        check(bool(torch.isfinite(h).all()) and bool(torch.isfinite(q).all()),
              f"{tag} {dt} n={n}: non-finite output")
        return h_err

    # B11 with Q against its plain version (run once: it is a long chain of
    # small PyTorch operations); float32 at 4096 is the B11 row, complex64 at
    # 2048 (beyond the TPU's 1024-row two-plane limit) the B12 row
    for tag, n, dt in (("B11", FULL_N, torch.float32), ("B12", LARGE_N, torch.complex64),
                       ("B11", FULL_N // 4, torch.float64)):
        a, _ = device_operand(rng, n, dt, dev, "well_conditioned")
        torch.cuda.synchronize()
        k_ms = time_ms(lambda: hb.hessenberg_blocked_kernel(a, accumulate_q=True), reps=2)
        h, q = hb.hessenberg_blocked_kernel(a, accumulate_q=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        hp, qp = hb.hessenberg_blocked_plain(a, accumulate_q=True)
        end.record()
        end.synchronize()
        p_ms = start.elapsed_time(end)
        err = hold_reduction(tag, a, h, q, hp, qp)
        # no atomics: a second call gives the same bits
        h2, q2 = hb.hessenberg_blocked_kernel(a, accumulate_q=True)
        with_q = hb.hessenberg_blocked_kernel.device_launches
        check(torch.equal(h, h2) and torch.equal(q, q2),
              f"{tag} {dt} n={n}: two calls with Q differ")
        print(f"check {tag} {dt} n={n}: two calls with Q bitwise equal")
        del h2, q2
        h_only_ms = time_ms(lambda: hb.hessenberg_blocked_kernel(a), reps=2)
        print(f"time {tag} {dt} n={n} with Q: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(one call); without Q: kernel {h_only_ms:.3f} ms; device kernels a call "
              f"{with_q} with Q, {hb.hessenberg_blocked_kernel.device_launches} without "
              f"[{card_name}, {card_limit}]")
        if dt != torch.float64:
            errors[tag] = err
            timings[tag] = (k_ms, p_ms, n, dt)
        del h, q, hp, qp
    # B11 against the unblocked B7 at 512: the same reflectors, summed in
    # another order (three units)
    for dt in (torch.float32, torch.complex64):
        a, _ = device_operand(rng, QR_N, dt, dev, "well_conditioned")
        h, q = hb.hessenberg_blocked_kernel(a, accumulate_q=True)
        h7, q7 = qk.hessenberg_kernel(a, accumulate_q=True)
        torch.cuda.synchronize()
        hold_reduction("B11 vs B7", a, h, q, h7, q7, units=3.0)

    # B14 on the Schur factor of the eigenpair path (B7/B11 and B8 with Q on
    # the bench operand's construction) and on a triangle with one repeated
    # eigenvalue (every pivot clamped, the 1e18 rescale on every column).
    # Normalised columns against the plain version: 1e-5 in complex64 (the
    # recurrence amplifies the summation order where eigenvalues cluster;
    # 6e-7 measured at 2048), 1e-12 in complex128; the residual
    # |T y - lambda y| of the normalised columns to 1e-4 (1e-10 in complex128)
    # of max(max|T|, 1).
    for n in (QR_N, LARGE_N):
        for real_dt in (torch.float32, torch.float64):
            cdt = real_dt.to_complex()
            double = real_dt == torch.float64
            a, _ = device_operand(rng, n, real_dt, dev, "geometric")
            h, _ = qk.hessenberg_reduce(a, accumulate_q=True)
            tol = 1e-12 if double else QR_TOL
            _, sweeps, hi, t_schur, _ = qk.qr_eig_sweeps(h.to(cdt), 20 * n, tol, accumulate_q=True)
            check(int(hi) <= 1, f"B14 input {cdt} n={n}: the sweeps did not converge")
            tri = np.triu(0.3 * rng.standard_normal((n, n)), 1) + 2.0 * np.eye(n)
            eps_schur = torch.finfo(real_dt).eps * max(float(t_schur.abs().max()), 1.0)
            for kind, T in (("Schur factor", t_schur),
                            ("repeated eigenvalue", torch.from_numpy(tri).to(dev, cdt))):
                scale = max(float(T.abs().max()), 1.0)
                eps = torch.finfo(real_dt).eps * scale
                y = tv.triangular_eigenvectors_kernel(T, eps)
                yp = tv.triangular_eigenvectors_plain(T, eps)
                torch.cuda.synchronize()
                yn = y / y.abs().square().sum(0).sqrt().clamp_min(1e-30)
                ypn = yp / yp.abs().square().sum(0).sqrt().clamp_min(1e-30)
                err = float((yn - ypn).abs().max())
                check(bool(torch.isfinite(y).all()), f"B14 {cdt} n={n} {kind}: non-finite Y")
                report(f"B14 {kind} {cdt} n={n} Y vs plain (normalised)", err,
                       1e-12 if double else 1e-5)
                if kind == "Schur factor":
                    res = float((T @ yn - yn * T.diagonal()[None, :]).abs().max()) / scale
                    report(f"B14 {kind} {cdt} n={n} |T y - lambda y|", res,
                           1e-10 if double else 1e-4)
                    if cdt == torch.complex64 and n == QR_N:  # Y's scale is arbitrary
                        errors["B14"] = err
            if not double:
                def kernel():
                    return tv.triangular_eigenvectors_kernel(t_schur, eps_schur)

                def plain():
                    return tv.triangular_eigenvectors_plain(t_schur, eps_schur)

                if n == QR_N:  # the plain version reads the host: CUDA events, no graph
                    k_ms, p_ms = timed_pair(kernel, plain, lambda fn: time_ms(fn, reps=3),
                                            lambda fn: time_events_ms(fn, 2))
                    timings["B14"] = (k_ms, p_ms, n, cdt)
                else:
                    k_ms, p_ms = time_ms(kernel, reps=3), time_events_ms(plain, 1)
                print(f"time B14 {cdt} n={n}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                      f"[{card_name}, {card_limit}]")
    return errors, timings


def profile_breakdown(label, fn, top=8):
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall-clock. A breakdown only:
    a profiler that records nothing is reported, not failed on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: an aten:: operator's row repeats the time of its kernels
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    if not rows:
        print(f"profile {label}: no device time recorded (not measured)")
    total = sum(ms for _, ms, _ in rows)
    # busy: the union of the device spans (kernels that overlap, as B11's
    # column steps do under programmatic dependent launch, count once)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA):
        if b > end:
            busy_us, end = busy_us + b - max(a, end), b
    print(f"profile {label}: {total:.3f} ms of device time (overlapping kernels each count) "
          f"in {wall_ms:.3f} ms of wall-clock under the profiler, device busy "
          f"{busy_us / 1e3 / wall_ms:.1%}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"profile {label}: {ms:.3f} ms of {total:.3f} ms device time in {count} "
              f"launches of {key[:90]}")


def boundary_sweep_phase(dev, card_name, card_limit):
    """Phase 9: B7 against B11 (the ``HESSENBERG_BLOCKED_MIN_N`` sweep),
    B11's panel widths, B9 beside ``torch.linalg.qr``, and the library calls
    of the kernel rows. Returns {tag: library ms}."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers import hessenberg as hs

    rng = np.random.default_rng(30)
    library = {}
    print(f"sweep (ms per call after a warm-up: B7 and B11 {B11_REPS} calls, one from 2048 on; "
          f"B9 and torch.linalg.qr over {B9_REPS} calls, in turns) [{card_name}, {card_limit}]")
    print("dtype n B7 B11 B7-with-Q B11-with-Q B9 torch.linalg.qr(complete) B9-device-kernels "
          "B11-device-kernels B7-route")
    for dt in (torch.float32, torch.complex64):
        faster_from = None
        for n in SWEEP_SIZES:
            a, _ = device_operand(rng, n, dt, dev, "gaussian")
            reps = B11_REPS if n < 2048 else 1
            b7 = time_events_ms(lambda: qk.hessenberg_kernel(a), reps)
            b11 = time_events_ms(lambda: hb.hessenberg_blocked_kernel(a), reps)
            plan = qk.hessenberg_kernel.last_plan
            b7q = b11q = float("nan")  # with Q up to 2048: the eigenpair path's sizes
            if n <= 2048:
                b7q = time_events_ms(lambda: qk.hessenberg_kernel(a, accumulate_q=True), reps)
                b11q = time_events_ms(
                    lambda: hb.hessenberg_blocked_kernel(a, accumulate_q=True), reps)
            b9, lib = timed_pair(lambda: qk.qr_decompose_kernel(a),
                                 lambda: torch.linalg.qr(a, mode="complete"),
                                 lambda fn: time_events_ms(fn, B9_REPS))
            print(f"sweep {dt} {n} {b7:.3f} {b11:.3f} {b7q:.3f} {b11q:.3f} {b9:.3f} {lib:.3f} "
                  f"{qk.qr_decompose_kernel.device_launches} "
                  f"{hb.hessenberg_blocked_kernel.device_launches} "
                  f"cluster {plan.cluster} H {'smem' if plan.h_smem else 'L2'} "
                  f"Q {'smem' if plan.q_smem else 'L2'}")
            faster_from = (faster_from or n) if b11 < b7 else None
            if n == QR_N and dt == torch.float32:
                library["B9"] = lib
        print(f"sweep {dt}: B11 faster than B7 from n = {faster_from} on; "
              f"HESSENBERG_BLOCKED_MIN_N = {hs.HESSENBERG_BLOCKED_MIN_N}")
    # B9's panel width (qr_panel_width was set from this table)
    for dt in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        for n in (QR_N, LARGE_N):
            a, _ = device_operand(rng, n, dt, dev, "gaussian")
            times = {nb: time_events_ms(lambda: qk.qr_decompose_kernel(a, nb=nb), B9_REPS)
                     for nb in (16, 32, 64)}
            print(f"panel width B9 {dt} n={n}: " + ", ".join(
                f"nb {nb} {ms:.3f} ms" for nb, ms in times.items())
                + f"; qr_panel_width {qk.qr_panel_width(n, dt)} [{card_name}, {card_limit}]")
        del a
    a, _ = device_operand(rng, QR_N, torch.float32, dev, "gaussian")
    profile_breakdown(f"B9 float32 n={QR_N}", lambda: qk.qr_decompose_kernel(a))
    a, _ = device_operand(rng, FULL_N, torch.float32, dev, "gaussian")
    for nb in (16, 32, 64):
        ms = time_events_ms(lambda: hb.hessenberg_blocked_kernel(a, nb=nb), 1)
        print(f"panel width {nb}: B11 float32 n={FULL_N} {ms:.3f} ms, "
              f"{hb.hessenberg_blocked_kernel.device_launches} device kernels a call "
              f"[{card_name}, {card_limit}]")
    # where B11's time goes: phase A (col_*), the trailing GEMMs, Q's GEMMs
    profile_breakdown("B11 float32 n=%d" % FULL_N, lambda: hb.hessenberg_blocked_kernel(a),
                      top=10)
    profile_breakdown("B11 float32 n=%d with Q" % FULL_N,
                      lambda: hb.hessenberg_blocked_kernel(a, accumulate_q=True), top=10)
    a, _ = device_operand(rng, LARGE_N, torch.complex64, dev, "gaussian")
    profile_breakdown("B12 complex64 n=%d with Q" % LARGE_N,
                      lambda: hb.hessenberg_blocked_kernel(a, accumulate_q=True), top=10)
    h = qk.hessenberg_plain(device_operand(rng, QR_SWEEP_N, torch.complex64, dev, "gaussian")[0])
    library["B8"] = time_events_ms(lambda: torch.linalg.eigvals(h), 3)
    full = time_events_ms(lambda: qk.qr_eig_kernel(h, 60 * QR_SWEEP_N, 1e-6), 3)
    print(f"time B8 complex64 n={QR_SWEEP_N} to convergence: kernel {full:.3f} ms, "
          f"torch.linalg.eigvals {library['B8']:.3f} ms [{card_name}, {card_limit}]")
    return library


def eigenpair_path_phase(eigsol, dev):
    """Phase 10: ``qr_eigenvalues(compute_vectors=True)`` through the public
    API on CUDA tensors. Every check raises on failure."""
    import torch

    rng = np.random.default_rng(40)
    a32, d = device_operand(np.random.default_rng(0), QR_N, torch.float32, dev, "geometric")
    a64c, dc = device_operand(np.random.default_rng(1), QR_N, torch.complex64, dev, "geometric")
    g = np.random.default_rng(2).uniform(-1, 1, (QR_N, QR_N))
    g32 = torch.from_numpy(g).to(dev, torch.float32)
    g_eigs = np.linalg.eigvals(g32.double().cpu().numpy())
    a_large, d_large = device_operand(rng, LARGE_N, torch.float32, dev, "geometric")
    a_small, d_small = device_operand(np.random.default_rng(3), QR_SWEEP_N, torch.float32, dev,
                                      "geometric")
    # eigenvalue limits as in phase 7; the residual is backward stable: one
    # unit, 1e-6 n, of ||A||_2; unit columns to 1e-5
    runs = {"(a) f32 symmetric 512": (a32, d, 1e-4),
            "(b) c64 normal 512": (a64c, dc, 1e-4),
            "(c) f32 non-symmetric 512": (g32, g_eigs, 5e-3),
            f"(d) f32 symmetric {QR_SWEEP_N} (B8, at most UNBLOCKED_MAX_N)": (a_small, d_small,
                                                                          1e-4),
            f"(e) f32 symmetric {LARGE_N}": (a_large, d_large, 1e-4)}
    torch.cuda.synchronize()
    results, seconds = {}, {}
    for name, (a, _, _) in runs.items():
        opts = eigsol.QROptions(mode="accelerated", compute_vectors=True,
                                max_iterations=20 * a.shape[0], tolerance=QR_TOL)
        t0 = time.perf_counter()
        results[name] = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), opts)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    for name, (a, want, limit) in runs.items():
        r = results[name]
        n = a.shape[0]
        lam, V = r.eigenvalues, r.eigenvectors
        check(V is not None and V.shape == (n, n) and V.device == a.device,
              f"{name}: no eigenvectors beside the matrix")
        check(bool(torch.isfinite(V).all()) and bool(torch.isfinite(lam).all()),
              f"{name}: non-finite eigenpairs")
        err = nearest_err(lam.cpu().numpy(), want)
        ac = a.to(lam.dtype)
        res = float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max()) / \
            float(torch.linalg.matrix_norm(ac, 2))
        norm_err = float((V.abs().square().sum(0).sqrt() - 1).abs().max())
        print(f"eigenpairs {name}: max eigenvalue error {err:.3e} (limit {limit:.0e}), "
              f"max_k |A v_k - lambda_k v_k| / |A| {res:.3e} (limit {1e-6 * n:.1e}), "
              f"| |v_k| - 1 | {norm_err:.1e}, {int(r.iterations)} sweeps, "
              f"converged={bool(r.converged)}, {seconds[name]:.3f} s")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= limit, f"{name}: eigenvalue error {err:.3e} above {limit:.0e}")
        check(res <= 1e-6 * n, f"{name}: residual {res:.3e} above {1e-6 * n:.1e}")
        check(norm_err <= 1e-5, f"{name}: columns not of unit norm ({norm_err:.1e})")


def to_hessenberg_phase(eigsol, dev, qk, hb):
    """Phase 11: ``to_hessenberg`` through the public API at n = 4096 float32
    and 2048 complex64. The launch counts are zeroed before and read after
    each run; returns {tag: B11 launches}. The reduction is a unitary
    similarity: exact zeros below the subdiagonal and ||H||_F = ||A||_F to
    one unit (1e-6 n)."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.hessenberg import (
        HESSENBERG_BLOCKED_MIN_N)

    rng = np.random.default_rng(50)
    launches = {}
    n_complex = max(LARGE_N, HESSENBERG_BLOCKED_MIN_N)
    for tag, n, dt in (("B11", FULL_N, torch.float32), ("B12", n_complex, torch.complex64)):
        a, _ = device_operand(rng, n, dt, dev, "gaussian")
        torch.cuda.synchronize()
        qk.reset_launch_counts()
        t0 = time.perf_counter()
        h = eigsol.to_hessenberg(eigsol.DenseMatrix(a))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[tag] = hb.hessenberg_blocked_kernel.launches
        fro = abs(float(torch.linalg.matrix_norm(h.to(torch.complex128))) /
                  float(torch.linalg.matrix_norm(a.to(torch.complex128))) - 1)
        below = float(torch.tril(h, -2).abs().max())
        print(f"to_hessenberg {dt} n={n}: {seconds:.3f} s, |H|_F / |A|_F - 1 = {fro:.2e} "
              f"(limit {1e-6 * n:.1e}), max below subdiagonal {below}, launches "
              f"{ {k.__name__: k.launches for k in qk.KERNELS} }")
        check(launches[tag] == 1 and qk.hessenberg_kernel.launches == 0,
              f"to_hessenberg {dt} n={n} did not run the blocked kernel")
        check(below == 0.0 and fro <= 1e-6 * n, f"to_hessenberg {dt} n={n}: not a reduction")
    return launches


def qr_path_phase(eigsol, dev):
    """Phase 7: the QR path through the public API on CUDA tensors. Every
    check raises on failure."""
    import math

    import torch

    n = QR_N
    rng = np.random.default_rng(0)
    d = 0.9 ** np.arange(n)
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a32 = torch.from_numpy((Qo * d) @ Qo.T).to(dev, torch.float32)
    rng = np.random.default_rng(1)
    dc = d * np.exp(1j * rng.uniform(0, 2 * np.pi, n))
    Qc, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    a64c = torch.from_numpy((Qc * dc) @ Qc.conj().T).to(dev, torch.complex64)
    g = np.random.default_rng(2).uniform(-1, 1, (n, n))
    g32 = torch.from_numpy(g).to(dev, torch.float32)
    g_eigs = np.linalg.eigvals(g32.double().cpu().numpy())
    accel = eigsol.QROptions(mode="accelerated", max_iterations=20 * n, tolerance=QR_TOL)
    parity = eigsol.QROptions(mode="parity", tolerance=QR_TOL,
                              max_iterations=max(40 * int(math.log(n) * 10), 2000))
    # limits: f32 with tol 3e-6 on a spectrum in (0, 1]: 1e-4 absolute. The
    # non-symmetric matrix deflates at ~3e-6 * (|h_ii| + |h_jj|) ~ 1e-4 and its
    # eigenvalues have condition numbers of order sqrt(n): 5e-3 absolute
    # against a spectral radius of ~13.
    # (e): the bench operand's construction at QR_SWEEP_N, where the
    # accelerated sweeps are B8's (UNBLOCKED_MAX_N)
    m = QR_SWEEP_N
    dm = 0.9 ** np.arange(m)
    Qm, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((m, m)))
    a_small = torch.from_numpy((Qm * dm) @ Qm.T).to(dev, torch.float32)
    accel_small = eigsol.QROptions(mode="accelerated", max_iterations=20 * m, tolerance=QR_TOL)
    runs = {"(a) f32 symmetric accelerated": (a32, accel, d, 1e-4),
            "(a) f32 symmetric parity": (a32, parity, d, 1e-4),
            "(b) c64 normal accelerated": (a64c, accel, dc, 1e-4),
            "(b) c64 normal parity": (a64c, parity, dc, 1e-4),
            "(c) f32 non-symmetric accelerated": (g32, accel, g_eigs, 5e-3),
            f"(e) f32 symmetric accelerated {m}": (a_small, accel_small, dm, 1e-4)}
    A = eigsol.read_matrix_from_file("data/A.txt", torch.complex128, device=dev)
    B = eigsol.read_matrix_from_file("data/B.txt", torch.complex128, device=dev)
    torch.cuda.synchronize()
    results, seconds = {}, {}
    for name, (a, opts, _, _) in runs.items():
        t0 = time.perf_counter()
        results[name] = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), opts)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hA = eigsol.to_hessenberg(A)
    qA, rA = eigsol.qr_decompose(A)
    rA_eig = eigsol.qr_eigenvalues(A)
    torch.cuda.synchronize()
    seconds["(d)"] = time.perf_counter() - t0
    try:
        eigsol.qr_eigenvalues(B)
        raise AssertionError("qr_eigenvalues(data/B.txt) did not raise")
    except ValueError as err:
        print(f"(d) qr_eigenvalues(data/B.txt) raised ValueError: {err}")
    for name, (a, opts, want, limit) in runs.items():
        r = results[name]
        got = r.eigenvalues.cpu().numpy()
        check(got.shape == (a.shape[0],) and np.isfinite(got).all(), f"{name}: bad eigenvalues")
        err = nearest_err(got, want)
        print(f"QR {name}: max eigenvalue error {err:.3e} (limit {limit:.0e}), "
              f"{int(r.iterations)} {'sweeps' if opts.mode == 'accelerated' else 'iterations'}, "
              f"converged={bool(r.converged)}, {seconds[name]:.3f} s")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= limit, f"{name}: eigenvalue error {err:.3e} above {limit:.0e}")
    # the parity solves' device kernels (torch.profiler, one more solve each)
    # and B10's cooperative launches a solve
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    for name in ("(a) f32 symmetric parity", "(b) c64 normal parity"):
        a, opts = runs[name][:2]
        names = device_kernels(lambda: eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), opts))
        count = "not measured" if names is None else \
            f"{len(names)} ({sum('sweeps_kernel' in x for x in names)} of B10's)"
        print(f"QR {name}: {seconds[name]:.3f} s a solve, device kernels a solve {count}, "
              f"B10 cooperative launches {qk.qr_parity_kernel.device_launches}")
    a_np = A.to_dense().cpu().numpy()
    h_np, q_np, r_np = hA.cpu().numpy(), qA.cpu().numpy(), rA.cpu().numpy()
    ev_err = nearest_err(rA_eig.eigenvalues.cpu().numpy(), np.linalg.eigvals(a_np))
    qr_err = float(np.abs(q_np @ r_np - a_np).max())
    h_err = nearest_err(np.linalg.eigvals(h_np), np.linalg.eigvals(a_np))
    print(f"(d) data/A.txt complex128: max|A - QR| {qr_err:.2e} (limit 1e-12), Hessenberg "
          f"spectrum {h_err:.2e}, qr_eigenvalues {ev_err:.2e} from numpy (limit 1e-8), "
          f"{int(rA_eig.iterations)} iterations, converged={bool(rA_eig.converged)}, "
          f"{seconds['(d)']:.3f} s")
    check(qr_err <= 1e-12 and h_err <= 1e-10, "data/A.txt: QR or Hessenberg off")
    check(bool(rA_eig.converged) and ev_err <= 1e-8, "data/A.txt: eigenvalues off numpy")


def blocked_sweeps_phase(dev, card_name, card_limit):
    """Phase 12: B13 against its plain version on the card in complex64 and
    complex128, with deflation off (tol 0) so that both run the same iterates:
    Schur mode at sizes that straddle block edges (bs - 1, bs + 1, 2 bs + 1),
    at n = 512 and, in complex64, at ``LARGE_N`` (beyond ``UNBLOCKED_MAX_N``,
    where the path runs B13), eigenvalues-only mode, and a 3-shift schedule.
    Returns the max abs error of T at ``LARGE_N`` and (kernel, plain) ms per
    sweep there (eigenvalues only; the plain version timed once)."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    rng = np.random.default_rng(60)
    bs = qb.BLOCK
    err_main, timing = None, None

    def rel(x, y, scale):
        return float((x - y).abs().max()) / scale

    for dt in (torch.complex64, torch.complex128):
        shifts = torch.tensor([0.3 + 0.1j, -0.2, 0.5 - 0.4j], dtype=dt, device=dev)
        sizes = ((bs - 1, None), (bs + 1, None), (2 * bs + 1, None), (QR_N, None),
                 (QR_N, shifts))
        if dt == torch.complex64:
            sizes += ((LARGE_N, None),)
        for n, sched in sizes:
            h = qk.hessenberg_reduce(device_operand(rng, n, dt, dev, "gaussian")[0])
            scale = float(h.abs().max())
            # T, Q and the diagonal to ten units of 1e-6 n (1e-14 n in complex128)
            # relative to max|H| (Q: 1), the residuals to one unit, as B8's
            unit = (1e-14 if dt == torch.complex128 else 1e-6) * n
            sweeps = B13_SWEEPS if n >= QR_N else 6
            e, s, hi, t, q = qb.qr_eig_blocked_kernel(h, sweeps, 0.0, sched, accumulate_q=True)
            e1, s1, hi1 = qb.qr_eig_blocked_kernel(h, sweeps, 0.0, sched)
            ep, sp, hip, tp, qp = qb.qr_eig_blocked_plain(h, sweeps, 0.0, sched,
                                                          accumulate_q=True)
            torch.cuda.synchronize()
            plain_start = time.perf_counter()
            e1p, _, _ = qb.qr_eig_blocked_plain(h, sweeps, 0.0, sched)
            torch.cuda.synchronize()
            plain_once_ms = (time.perf_counter() - plain_start) * 1e3
            eye = torch.eye(n, dtype=dt, device=dev)
            label = f"B13 {dt} n={n} bs={bs}{' 3-shift schedule' if sched is not None else ''}"
            checks = {"T vs plain": (rel(t, tp, scale), 10 * unit),
                      "Q vs plain": (rel(q, qp, 1.0), 10 * unit),
                      "eigenvalues-only diagonal vs plain": (rel(e1, e1p, scale), 10 * unit),
                      "|H - Q T Q^H|": (rel(q @ t @ q.conj().T, h, scale), unit),
                      "|Q^H Q - I|": (rel(q.conj().T @ q, eye, 1.0), unit)}
            for name, (err, limit) in checks.items():
                print(f"check {label} {name}: {err:.3e} (limit {limit:.1e})")
                check(err <= limit, f"{label} {name}: {err:.3e} above {limit:.1e}")
            counts = {(int(s), int(hi)), (int(s1), int(hi1)), (int(sp), int(hip))}
            check(counts == {(sweeps, n)}, f"{label}: sweeps and hi {counts}")
            check(bool(torch.isfinite(t).all()) and bool(torch.isfinite(q).all()),
                  f"{label}: non-finite output")
            if n == QR_N and sched is None:
                k_ms, p_ms = timed_pair(lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0),
                                        lambda: qb.qr_eig_blocked_plain(h, sweeps, 0.0),
                                        lambda fn: time_events_ms(fn, reps=2),
                                        lambda fn: time_events_ms(fn, reps=1))
            elif n == LARGE_N:  # ~1.3 s a sweep in the plain version: its one run above
                k_ms = time_events_ms(lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0), reps=2)
                p_ms = plain_once_ms
            if n >= QR_N and sched is None:
                schur_ms = time_events_ms(
                    lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0, accumulate_q=True), 2)
                print(f"time B13 {dt} n={n} bs={bs}: kernel {k_ms / sweeps:.4f} ms/sweep "
                      f"(Schur mode {schur_ms / sweeps:.4f}), plain {p_ms / sweeps:.2f} ms/sweep "
                      f"[{card_name}, {card_limit}]")
                if n == LARGE_N:
                    err_main = float((t - tp).abs().max())
                    timing = (k_ms / sweeps, p_ms / sweeps)
    return err_main, timing


def blocked_boundary_phase(dev, card_name, card_limit):
    """Phase 13: the sweep that sets ``UNBLOCKED_MAX_N``: B8 against B13 in
    complex64, per sweep on a Gaussian operand's Hessenberg form with a
    budget of 4 sweeps and deflation off (the window stays full), per whole
    solve on the bench operand (whose active window is small) and, up to
    ``NONSYM_MAX_N``, on a non-symmetric uniform(-1, 1) operand (whose window
    shrinks from full); B13's block sizes at 4096 and its device kernels per
    call there."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as qe

    rng = np.random.default_rng(70)
    sweeps = 4
    print(f"boundary (complex64, ms; per sweep: {sweeps} sweeps, tol 0; whole solve: bench "
          f"operand, tol {QR_TOL}; one CUDA-event loop per point) [{card_name}, {card_limit}]")
    print("boundary n B8/sweep B13/sweep B8/solve B13/solve (sweeps) "
          f"B8/non-symmetric B13/non-symmetric (sweeps; n <= {NONSYM_MAX_N})")
    faster_from, full = None, None
    for n in BOUNDARY_SIZES:
        h = qk.hessenberg_reduce(device_operand(rng, n, torch.complex64, dev, "gaussian")[0])
        times = [time_events_ms(lambda: qk.qr_eig_kernel(h, sweeps, 0.0), 1) / sweeps,
                 time_events_ms(lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0), 1) / sweeps]
        solves = [qk.hessenberg_reduce(device_operand(rng, n, torch.float32, dev, "geometric")[0])]
        if n <= NONSYM_MAX_N:
            solves.append(qk.hessenberg_reduce(
                torch.from_numpy(rng.uniform(-1, 1, (n, n))).to(dev, torch.float32)))
        line = f"boundary {n} {times[0]:.4f} {times[1]:.4f}"
        for hs in solves:
            hs = hs.to(torch.complex64)
            pair = [time_events_ms(lambda: qk.qr_eig_kernel(hs, 20 * n, QR_TOL), 1),
                    time_events_ms(lambda: qb.qr_eig_blocked_kernel(hs, 20 * n, QR_TOL), 1)]
            _, s8, hi8 = qk.qr_eig_kernel(hs, 20 * n, QR_TOL)
            _, s13, hi13 = qb.qr_eig_blocked_kernel(hs, 20 * n, QR_TOL)
            check(int(hi8) <= 1 and int(hi13) <= 1, f"boundary n={n}: a solve did not converge")
            line += f" {pair[0]:.3f} {pair[1]:.3f} ({int(s8)}/{int(s13)})"
            times += pair
        print(line)
        faster_from = (faster_from or n) if all(b13 < b8 for b8, b13 in
                                                zip(times[::2], times[1::2])) else None
        full = h
    print(f"boundary: B13 faster than B8 on every measure from n = {faster_from} on; "
          f"UNBLOCKED_MAX_N = {qe.UNBLOCKED_MAX_N}")
    n = BOUNDARY_SIZES[-1]
    hg = qk.hessenberg_reduce(device_operand(rng, n, torch.float32, dev, "geometric")[0])
    hg = hg.to(torch.complex64)
    for bs in (16, 32, 64):
        per_sweep = time_events_ms(lambda: qb.qr_eig_blocked_kernel(full, sweeps, 0.0, block=bs),
                                   1) / sweeps
        schur = time_events_ms(lambda: qb.qr_eig_blocked_kernel(
            full, sweeps, 0.0, accumulate_q=True, block=bs), 1) / sweeps
        whole = time_events_ms(lambda: qb.qr_eig_blocked_kernel(hg, 20 * n, QR_TOL, block=bs), 1)
        print(f"block {bs}: B13 complex64 n={n} {per_sweep:.4f} ms/sweep (Schur mode "
              f"{schur:.4f}), bench-operand solve {whole:.3f} ms [{card_name}, {card_limit}]")
    names = device_kernels(lambda: qb.qr_eig_blocked_kernel(full, sweeps, 0.0))
    kernels = "not measured" if names is None else \
        f"{len(names)} ({sum('sweeps_kernel' in x for x in names)} of B13's)"
    print(f"B13 complex64 n={n}, {sweeps} sweeps a call: device kernels a call {kernels}, "
          f"cooperative launches {qb.qr_eig_blocked_kernel.device_launches}")


def blocked_path_phase(eigsol, dev):
    """Phase 14: the public path beyond ``UNBLOCKED_MAX_N`` on CUDA tensors:
    eigenvalues of the bench operand at 4096 float32, of the complex64 normal
    operand at 2048 and of a non-symmetric float32 matrix at 2048 (against
    numpy in float64), and eigenpairs of the bench operand at 2048 and 4096.
    Every size lies beyond ``UNBLOCKED_MAX_N``. Every check raises on
    failure."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.qr_eigenvalues import qr_dispatch

    rng = np.random.default_rng(80)
    a4, d4 = device_operand(rng, FULL_N, torch.float32, dev, "geometric")
    a2, d2 = device_operand(rng, LARGE_N, torch.float32, dev, "geometric")
    c2, dc2 = device_operand(rng, LARGE_N, torch.complex64, dev, "geometric")
    g = torch.from_numpy(rng.uniform(-1, 1, (LARGE_N, LARGE_N))).to(dev, torch.float32)
    g_eigs = np.linalg.eigvals(g.double().cpu().numpy())
    # limits of phases 7 and 10: planted spectra 1e-4, the non-symmetric
    # matrix 5e-3 against numpy in float64, the residual one unit (1e-6 n)
    runs = {f"eigenvalues f32 bench {FULL_N}": (a4, d4, 1e-4, False),
            f"eigenvalues c64 normal {LARGE_N}": (c2, dc2, 1e-4, False),
            f"eigenvalues f32 non-symmetric {LARGE_N}": (g, g_eigs, 5e-3, False),
            f"eigenpairs f32 bench {LARGE_N}": (a2, d2, 1e-4, True),
            f"eigenpairs f32 bench {FULL_N}": (a4, d4, 1e-4, True)}
    torch.cuda.synchronize()
    results, seconds = {}, {}
    for name, (a, _, _, vectors) in runs.items():
        n = a.shape[0]
        check(qr_dispatch(n, a.device) == "cuda_blocked", f"{name}: n = {n} is not beyond "
              f"UNBLOCKED_MAX_N")
        t0 = time.perf_counter()
        opts = eigsol.QROptions(mode="accelerated", compute_vectors=vectors,
                                max_iterations=20 * n, tolerance=QR_TOL)
        r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), opts)
        results[name] = (r.eigenvalues, int(r.iterations), bool(r.converged), r.eigenvectors)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    for name, (a, want, limit, vectors) in runs.items():
        lam, sweeps, converged, V = results[name]
        n = a.shape[0]
        check(lam.shape == (n,) and bool(torch.isfinite(lam).all()), f"{name}: bad eigenvalues")
        err = nearest_err(lam.cpu().numpy(), want)
        line = (f"{name}: max eigenvalue error {err:.3e} (limit {limit:.0e}), "
                f"{sweeps} sweeps, converged={converged}, {seconds[name]:.3f} s")
        check(converged, f"{name}: did not converge")
        check(err <= limit, f"{name}: eigenvalue error {err:.3e} above {limit:.0e}")
        if vectors:
            check(V is not None and V.shape == (n, n) and bool(torch.isfinite(V).all()),
                  f"{name}: bad eigenvectors")
            ac = a.to(lam.dtype)
            res = float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max()) / \
                float(torch.linalg.matrix_norm(ac, 2))
            line += f", max_k |A v_k - lambda_k v_k| / |A| {res:.3e} (limit {1e-6 * n:.1e})"
            check(res <= 1e-6 * n, f"{name}: residual {res:.3e} above {1e-6 * n:.1e}")
        print(line)


class PlainMatvec:
    """A split operator with its matvec replaced by the plain version: the
    reference loop of phase 16."""

    def __init__(self, op, matvec):
        self.op, self.matvec = op, matvec

    def __getattr__(self, name):
        return getattr(self.op, name)


def symmetric_band(n, boost, seed):
    """A symmetric 33-diagonal band, uniform(-0.5, 0.5) entries, with
    ``boost`` added to the head of the diagonal (tests/test_lanczos.py's
    construction), as float32 numpy data (k, n)."""
    rng = np.random.default_rng(seed)
    offs = tuple(range(-BANDWIDTH, BANDWIDTH + 1))
    data = np.zeros((len(offs), n), np.float32)
    for d, off in enumerate(offs):
        if off < 0:
            continue
        v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        if off > 0:
            v[n - off:] = 0
            data[offs.index(-off), off:] = v[:n - off]
        data[d] = v
    data[BANDWIDTH, :len(boost)] += np.asarray(boost, np.float32)
    return data


def banded_block_kernel_phase(ctx):
    """Phase 15: the split-plane kernels (B4 interleaved, B3's planes entry
    row-major) and the block kernel B5 (row-major and interleaved) against
    their plain versions on the bench operator (1M rows, 33 diagonals), with
    each time per call beside the plain version's, and the library call
    ``torch.sparse.mm`` of the band's CSR times the (n, 8) block. Returns
    ({tag: max abs error}, {tag: (kernel ms, plain ms, bytes)}, {tag: library ms})."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import SplitComplexDIA
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds

    dev, offs, op32, op64c, xc = ctx["dev"], ctx["offs"], ctx["op32"], ctx["op64c"], ctx["xc"]
    card_name, card_limit = ctx["card_name"], ctx["card_limit"]
    rng = np.random.default_rng(90)
    errors, timings, library = {}, {}, {}

    def compare(label, tag, y, y_ref, limit, main_case=False):
        torch.cuda.synchronize()
        err = rel_err(y, y_ref)
        print(f"check {label}: rel err {err:.3e} (limit {limit:.0e})")
        check(torch.isfinite(y).all().item(), f"{label}: non-finite output")
        check(err <= limit, f"{label}: rel err {err:.3e} above {limit:.0e}")
        if main_case:
            errors[tag] = float((y - y_ref).abs().max())

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def plain_timer(fn):
        return time_ms(fn, reps=5)

    # B3's planes entry and B4 on the planes of the complex bench operator
    sc = SplitComplexDIA.from_complex_dia(op64c)
    xp = torch.stack([xc.real, xc.imag]).contiguous()
    y = ds.dia_matvec_planes(sc.planes, offs, xp)
    compare(f"planes dia_planes_kernel float32 n={N}", "planes", y,
            ds.dia_matvec_planes_plain(sc.planes, offs, xp), 1e-5, True)
    compare(f"planes dia_planes_kernel against B3 complex64 n={N}", "planes",
            torch.complex(y[0], y[1]), ds.dia_matvec(op64c.data, offs, xc), 1e-5)
    k_ms, p_ms = timed_pair(lambda: ds.dia_planes_kernel(sc.planes, offs, xp),
                            lambda: ds.dia_matvec_planes_plain(sc.planes, offs, xp),
                            plain_timer=plain_timer)
    timings[("planes", torch.float32)] = (k_ms, p_ms, nbytes(sc.planes, xp, y))
    pr = ds.il_window_halo(offs)
    for dt in (torch.float32, torch.bfloat16):
        il = SplitComplexDIA(planes=sc.planes.to(dt), offsets=offs, shape=sc.shape).interleaved()
        x_il = il.encode_vec(xp)
        y_il = ds.dia_matvec_il_planes(il.planes_il, offs, x_il)
        compare(f"B4 dia_il_planes_kernel {dt} n={N}", "B4", y_il,
                ds.dia_matvec_il_planes_plain(il.planes_il, offs, x_il), 1e-5,
                dt == torch.float32)
        w = ds._il_window(x_il, pr)
        k_ms, p_ms = timed_pair(lambda: ds.dia_il_planes_kernel(il.planes_il, offs, w),
                                lambda: ds.dia_matvec_il_planes_plain(il.planes_il, offs, x_il),
                                plain_timer=plain_timer)
        timings[("B4", dt)] = (k_ms, p_ms, nbytes(il.planes_il, w, y_il))
        k_ms = min(time_ms(lambda: ds.dia_matvec_il_planes(il.planes_il, offs, x_il))
                   for _ in range(2))
        timings[("B4+window", dt)] = (k_ms, p_ms, nbytes(il.planes_il, w, y_il))
    # B5 row-major and interleaved: nvec 8 in f32, bf16, f64 and complex64,
    # the ragged chunks 1, 3 and 13 in f32; at nvec 8 the (n, 8) entry of the
    # block solvers too, against the transposed copy that it replaced
    cases = [(8, torch.float32), (8, torch.bfloat16), (8, torch.float64), (1, torch.float32),
             (3, torch.float32), (13, torch.float32), (8, torch.complex64)]
    for nvec, dt in cases:
        vals = op64c.data if dt.is_complex else op32.data.to(dt)
        xs = rng.uniform(-1, 1, (nvec, N))
        if dt.is_complex:
            xs = xs + 1j * rng.uniform(-1, 1, (nvec, N))
        xs = torch.from_numpy(xs).to(dev, ds.acc_dtype(dt))
        main = nvec == 8 and dt == torch.float32
        ys = ds.dia_matmat(vals, offs, xs)
        route = ds.dia_block_kernel.last_route
        ref = ds.dia_matmat_plain(vals, offs, xs)
        compare(f"B5 dia_block_kernel {dt} nvec={nvec} n={N} ({route} route)", "B5", ys, ref,
                1e-5, main)
        il_vals = ds.interleave_dia_vals(vals, ds.il_rows(N))
        xs_il = torch.stack([ds.interleave_vec(v, il_vals.shape[1]) for v in xs])
        ys_il = ds.dia_matmat_il(il_vals, offs, xs_il)
        compare(f"B5 dia_il_block_kernel {dt} nvec={nvec} n={N} "
                f"({ds.dia_il_block_kernel.last_route} route)", "B5il", ys_il,
                ds.dia_matmat_il_plain(il_vals, offs, xs_il), 1e-5, main)
        if nvec == 8:
            X = xs.T.contiguous()
            compare(f"B5 dia_block_kernel (n, 8) entry {dt} n={N} "
                    f"({ds.block_route(False, offs, vals.dtype, 8, vectors_last=True)} route)",
                    "B5", ds.dia_matmat_cols(vals, offs, X).T, ref, 1e-5)
            w8 = ds._il_window(xs_il, pr)
            # each entry by each route (the route rule, ds.block_route, was set
            # from this table); the kernels line takes the path's: the (n, 8)
            # block of the block solvers and the interleaved window
            entries = {
                "(nvec, n)": lambda r: ds.dia_block_kernel(vals, offs, xs, route=r),
                "(n, 8)": lambda r: ds.dia_block_kernel(vals, offs, X, vectors_last=True,
                                                        route=r),
                "interleaved": lambda r: ds.dia_il_block_kernel(il_vals, offs, w8, route=r)}
            picked = {"(nvec, n)": ds.block_route(False, offs, vals.dtype, 8),
                      "(n, 8)": ds.block_route(False, offs, vals.dtype, 8, vectors_last=True),
                      "interleaved": ds.block_route(True, offs, vals.dtype, 8)}
            by_route = {}
            for entry, fn in entries.items():
                for route in ("staged", "direct"):
                    if route == "staged" and ds.block_stage_smem(
                            entry == "interleaved", offs, vals.dtype, 8) > ds.BLOCK_STAGED_SMEM:
                        continue
                    by_route[(entry, route)] = min(time_ms(lambda: fn(route)) for _ in range(2))
                print(f"time B5 {entry} {dt} {N}x33 nvec 8: " + ", ".join(
                    f"{r} {by_route[(entry, r)] * 1e3:.1f} us" for r in ("staged", "direct")
                    if (entry, r) in by_route) + f"; picked {picked[entry]} "
                    f"[{card_name}, {card_limit}]")
            k_ms = by_route[("(n, 8)", picked["(n, 8)"])]
            p_ms = min(plain_timer(lambda: ds.dia_matmat_plain(vals, offs, xs)) for _ in range(2))
            timings[("B5", dt)] = (k_ms, p_ms, nbytes(vals, xs, ys))
            k_ms = by_route[("interleaved", picked["interleaved"])]
            p_ms = min(plain_timer(lambda: ds.dia_matmat_il_window_plain(il_vals, offs, w8))
                       for _ in range(2))
            timings[("B5il", dt)] = (k_ms, p_ms, nbytes(il_vals, w8, ys_il))
            # the block solvers' (n, 8) block before the strided entry: the
            # kernel on a transposed copy, and the copy alone
            copy = min(time_ms(lambda: ds.dia_block_kernel(vals, offs, X.T.contiguous()))
                       for _ in range(2))
            transpose = min(time_ms(lambda: X.T.contiguous()) for _ in range(2))
            print(f"time B5 (n, 8) block {dt} {N}x33: by strides "
                  f"{by_route[('(n, 8)', picked['(n, 8)'])] * 1e3:.1f} us, on a transposed "
                  f"copy {copy * 1e3:.1f} us (the copy alone {transpose * 1e3:.1f} us) "
                  f"[{card_name}, {card_limit}]")
            if dt == torch.float32:
                # the library call: CSR times the (n, 8) block (timed only)
                csr = band_csr(vals, offs)
                y_lib = torch.sparse.mm(csr, X)
                print(f"library torch.sparse.mm (CSR) x (n, 8) float32 n={N}: rel err against "
                      f"the plain version {rel_err(y_lib.T, ys):.2e}")
                lib_ms = time_events_ms(lambda: torch.sparse.mm(csr, X), reps=20)
                library.update({"B5": lib_ms, "B5il": lib_ms})
                print(f"time library torch.sparse.mm (CSR) x (n, 8) float32 {N}x33: "
                      f"{lib_ms * 1e3:.1f} us [{card_name}, {card_limit}]")
                del csr, y_lib
            del X, w8
        del xs, ys, xs_il, ys_il, il_vals, ref
    for (tag, dt), (k_ms, p_ms, nb) in timings.items():
        print(f"time {tag} {dt} {N}x33: kernel {k_ms * 1e3:.1f} us "
              f"({nb / (k_ms * 1e-3) / 1e9:.0f} GB/s, {nb / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} "
              f"of 3.35 TB/s: the bytes bound {nb / HBM_BYTES_PER_S * 1e6:.1f} us), "
              f"plain {p_ms * 1e3:.1f} us, library "
              f"{library.get(tag, float('nan')) * 1e3:.1f} us [{card_name}, {card_limit}]")
    return errors, timings, library


def banded_block_path_phase(ctx):
    """Phase 16: the split-plane power method and the block solvers through
    the public API at 1M x 33 on the card: (a) ``power_method`` on
    ``SplitComplexDIA`` (f32 planes) and ``InterleavedSplitComplexDIA`` (f32
    and bf16 planes) of the planted complex band of phases 4-5, with a fixed
    budget (held to the loop driven by the plain planes matvec) and
    converging (held to scipy's ``eigs``); (b) ``subspace_iteration(k=3,
    block=8)`` on the planted real band as ``SparseDIA`` and
    ``InterleavedDIA``, held to scipy's ``eigs(k=3)``; (c)
    ``chebyshev_subspace_iteration(k=4)`` on a symmetric band with four
    planted top values, row-major and interleaved, held to scipy's
    ``eigsh(k=4, which="LA")``. The launch counts are zeroed just before and
    read just after the runs (the references and oracles run outside)."""
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import split_complex as sc_ops
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers import subspace as sub

    dev, offs = ctx["dev"], ctx["offs"]
    card_name, card_limit = ctx["card_name"], ctx["card_limit"]
    planted, planted_c = ctx["planted"], ctx["planted_c"]
    x0 = np.random.default_rng(4).uniform(-1, 1, (2, N))
    budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
    converge = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-6)
    sc32 = eigsol.SplitComplexDIA.from_complex_dia(
        eigsol.SparseDIA(data=torch.from_numpy(planted_c).to(dev), offsets=offs, shape=(N, N)))
    sc16 = eigsol.SplitComplexDIA(planes=sc32.planes.to(torch.bfloat16), offsets=offs,
                                  shape=(N, N))
    p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev), offsets=offs, shape=(N, N))
    sym = symmetric_band(N, (8.0, 7.0, 6.5, 6.0), seed=5)
    s32 = eigsol.SparseDIA(data=torch.from_numpy(sym).to(dev), offsets=offs, shape=(N, N))
    powers = {"split f32": sc32, "split IL f32": sc32.interleaved(),
              "split IL bf16": sc16.interleaved()}
    blocks = {"subspace DIA f32": (p32, "subspace"),
              "subspace IL f32": (p32.interleaved(), "subspace"),
              "chebyshev DIA f32": (s32, "chebyshev"),
              "chebyshev IL f32": (s32.interleaved(), "chebyshev")}
    sub_opts = eigsol.SolverOptions(max_iterations=300, tolerance=1e-6)
    cheb_opts = eigsol.SolverOptions(max_iterations=200, tolerance=1e-5)

    def solve(M, kind):
        if kind == "subspace":
            return eigsol.subspace_iteration(M, k=3, block=8, opts=sub_opts)
        return eigsol.chebyshev_subspace_iteration(M, k=4, opts=cheb_opts)

    for M in powers.values():  # warm-up (allocator, library handles)
        eigsol.power_method(M, eigsol.SolverOptions(max_iterations=3), x0=x0)
    for M, kind in blocks.values():
        eigsol.subspace_iteration(M, k=3, block=8, opts=eigsol.SolverOptions(max_iterations=1),
                                  sweeps_per_check=1)
    torch.cuda.synchronize()

    t_path = time.perf_counter()
    ds.reset_launch_counts()
    results, seconds = {}, {}
    for name, M in powers.items():
        for label, opts in (("budget", budget), ("converge", converge)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            results[(name, label)] = eigsol.power_method(M, opts, x0=x0)
            end.record()
            end.synchronize()
            seconds[(name, label)] = start.elapsed_time(end) / 1e3
    for name, (M, kind) in blocks.items():
        t0 = time.perf_counter()
        results[name] = solve(M, kind)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ds.KERNELS}
    print(f"phase-16 launches: {launches}")
    for name in ("dia_il_planes_kernel", "dia_planes_kernel", "dia_block_kernel",
                 "dia_il_block_kernel"):
        check(launches[name] > 0, f"{name} was not launched by the phase-16 paths")

    # (a) the split-plane power method
    oracle = {"f32": scipy_dominant(planted_c, offs),
              "bf16": scipy_dominant((sc16.planes[0].float() + 1j * sc16.planes[1].float())
                                     .cpu().numpy(), offs)}
    for name, M in powers.items():
        r = results[(name, "budget")]
        plain = (ds.dia_matvec_il_planes_plain if name.startswith("split IL")
                 else ds.dia_matvec_planes_plain)
        planes = M.planes_il if hasattr(M, "planes_il") else M.planes
        ref = eigsol.power_method_split_complex(
            PlainMatvec(M, lambda v, planes=planes, plain=plain: plain(planes, offs, v)),
            budget, x0=x0)
        lam = complex(sc_ops.from_planes(r.eigenvalue))
        lam_ref = complex(sc_ops.from_planes(ref.eigenvalue))
        err = abs(lam - lam_ref) / abs(lam_ref)
        per_iter = seconds[(name, "budget")] / int(r.iterations)
        print(f"power {name} budget: lambda {lam:.7g} vs plain loop {lam_ref:.7g} (rel "
              f"{err:.2e}, limit 1e-4), {int(r.iterations)} iterations (plain loop "
              f"{int(ref.iterations)}), {per_iter * 1e6:.1f} us/iteration "
              f"[{card_name}, {card_limit}]")
        check(int(r.iterations) == int(ref.iterations) == budget.max_iterations,
              f"{name}: iteration counts")
        check(r.eigenvector.shape == (2, N) and torch.isfinite(r.eigenvector).all().item(),
              f"{name}: bad eigenvector")
        check(err <= 1e-4, f"{name}: eigenvalue off the plain loop by {err:.2e}")
        r = results[(name, "converge")]
        lam, lam_ref = complex(sc_ops.from_planes(r.eigenvalue)), oracle[name.split()[-1]]
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"power {name} converge: lambda {lam:.7g} vs scipy eigs {lam_ref:.7g} (rel "
              f"{err:.2e}, limit 1e-4), {int(r.iterations)} iterations, "
              f"converged={bool(r.converged)}, {seconds[(name, 'converge')]:.3f} s")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= 1e-4, f"{name}: eigenvalue off scipy by {err:.2e}")
    # (b) and (c) the block solvers
    oracles = {"subspace": scipy_top(planted, offs, 3),
               "chebyshev": scipy_top(sym, offs, 4, which="LA", symmetric=True)}
    ctx["oracles16"] = oracles  # phase 21 holds its Krylov solves to the same references
    for name, (M, kind) in blocks.items():
        r = results[name]
        want = oracles[kind]
        got = r.eigenvalues.cpu().numpy()
        err = nearest_err(got, want) / np.abs(want).max()
        print(f"{name}: Ritz values {np.round(got, 6)} vs scipy {np.round(want, 6)} (rel "
              f"{err:.2e}, limit 1e-4), {int(r.iterations)} sweeps, "
              f"converged={bool(r.converged)}, {seconds[name]:.3f} s [{card_name}, {card_limit}]")
        check(got.shape == want.shape and np.isfinite(got).all(), f"{name}: bad Ritz values")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= 1e-4, f"{name}: Ritz values off scipy by {err:.2e}")
    print(f"phase-16 paths: {time.perf_counter() - t_path:.1f} s")
    # where a subspace chunk's time goes (10 sweeps of k=3, block 8)
    for name in ("subspace DIA f32", "subspace IL f32"):
        M = blocks[name][0]
        rows = isinstance(M, eigsol.InterleavedDIA)
        X = sub._start_block(M, N, 8, torch.float32, None, None, rows)
        chunk = sub._subspace_chunk_rows if rows else sub._subspace_chunk
        profile_breakdown(f"{name} chunk of 10 sweeps", lambda: chunk(M, X, 10))
    # why CholeskyQR2 multiplies by the inverse of the b x b factor: the
    # triangular solve against the (8, n) block of the path (one call each)
    block = torch.randn(8, N, device=dev)
    L = torch.linalg.cholesky(block @ block.T)
    eye = torch.eye(8, device=dev)
    solve_ms = time_events_ms(lambda: torch.linalg.solve_triangular(L, block, upper=False), 1)
    inverse_ms = time_events_ms(
        lambda: torch.linalg.solve_triangular(L, eye, upper=False) @ block, 1)
    print(f"CholeskyQR2 step, (8, {N}) block: solve_triangular {solve_ms:.3f} ms, "
          f"inverse factor times the block {inverse_ms:.3f} ms [{card_name}, {card_limit}]")
    return launches


def general_coo(n, per_row, pattern, seed=0):
    """bench.py:127-143's operator: ``per_row`` entries a row, columns
    uniform or within +-8192 of the row (wrapping), standard normal float32
    values, duplicates removed, as numpy COO sorted by (row, col)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    if pattern == "local":
        cols = (rows + rng.integers(-8192, 8193, n * per_row)) % n
    else:
        cols = rng.integers(0, n, n * per_row)
    vals = rng.standard_normal(n * per_row).astype(np.float32)
    _, uniq = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    return rows[uniq], cols[uniq], vals[uniq]


def hub_coo(n, seed=0):
    """``general_coo``'s uniform operator with ``GELL_HUBS`` entries more
    in nine rows spread over it, uniform columns: rows that B6's CSR route
    splits over whole blocks."""
    r, c, v = general_coo(n, GELL_PER_ROW, "uniform", seed)
    rng = np.random.default_rng(seed + 1)
    hub_rows = np.arange(len(GELL_HUBS)) * (n // len(GELL_HUBS)) + 7
    hr = np.repeat(hub_rows, GELL_HUBS)
    return (np.concatenate([r, hr]), np.concatenate([c, rng.integers(0, n, len(hr))]),
            np.concatenate([v, rng.standard_normal(len(hr)).astype(np.float32)]))


def hub_rect_coo(n, n_cols, seed=0):
    """``n`` rows over ``n_cols`` columns: ``GELL_PER_ROW`` uniform entries a
    row, and ``HUB_RECT_ROWS`` rows among them with 1025 to 12,000 entries
    more, uniform columns: rows that B6's CSR route splits, whose chunks
    then run over several windows of x."""
    rng = np.random.default_rng(seed)
    long = rng.choice(n, HUB_RECT_ROWS, replace=False)
    r = np.concatenate([np.repeat(np.arange(n), GELL_PER_ROW),
                        np.repeat(long, rng.integers(1025, 12_001, HUB_RECT_ROWS))])
    return r, rng.integers(0, n_cols, len(r)), rng.standard_normal(len(r)).astype(np.float32)


def gell_hub_checks(dev, card_name, card_limit):
    """Phase 17's long rows: B6's CSR route splits them over whole blocks.
    On ``hub_coo(N)`` (nine hub rows, one window of x) and on
    ``hub_rect_coo(N, HUB_RECT_COLS)`` (thousands of long rows, chunks run
    window by window), in f32 and bf16 values: against the plain version in
    float64 (limit 1e-5), repeated bit for bit, timed with and without the
    split."""
    import dataclasses

    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs

    rng = np.random.default_rng(171)
    for label, coo, n_cols in (("hub rows", hub_coo(N), N),
                               ("hub rectangle", hub_rect_coo(N, HUB_RECT_COLS), HUB_RECT_COLS)):
        pack = gs.pack_gell(*coo, (N, n_cols), device=dev)
        del coo
        sp = pack.split
        n_long = len(GELL_HUBS) if label == "hub rows" else HUB_RECT_ROWS
        check(sp is not None and len(sp.rows) == n_long, f"B6 {label}: no split")
        in_row_order = torch.equal(sp.order.cpu(), torch.arange(sp.n_chunks, dtype=torch.int32))
        check(in_row_order == (n_cols <= gs.SPLIT_WINDOW),
              f"B6 {label}: the chunks' run order is not window by window")
        x = torch.from_numpy(rng.uniform(-1, 1, n_cols)).to(dev, torch.float32)
        for name, p in (("f32", pack), ("bf16", pack.with_values_dtype(torch.bfloat16))):
            whole = dataclasses.replace(p, split=None)
            y = gs.gell_kernel(p, x, route="csr")
            # against the plain version in float64: float32 sums of 2^20 terms would not do
            want = gs.gell_matvec_plain(p, x.double())
            torch.cuda.synchronize()
            err = rel_err(y.double(), want)
            print(f"check B6 {label} {name} csr, {len(sp.rows)} rows split into "
                  f"{sp.n_chunks} blocks over {-(-n_cols // gs.SPLIT_WINDOW)} windows: "
                  f"rel err {err:.3e} (limit 1e-05)")
            check(err <= 1e-5, f"B6 {label} {name}: rel err {err:.3e} above 1e-05")
            for _ in range(2):
                check(torch.equal(y, gs.gell_kernel(p, x, route="csr")),
                      f"B6 {label} {name}: not repeated bit for bit")
            check(not sp.counters.any(), f"B6 {label} {name}: counters not reset")
            del want
            split_ms = min(time_ms(lambda: gs.gell_kernel(p, x, route="csr"))
                           for _ in range(2))
            whole_ms = min(time_ms(lambda: gs.gell_kernel(whole, x, route="csr"), reps=5)
                           for _ in range(2))
            print(f"time B6 {label} {name} {N}x{n_cols} (us per call): csr split "
                  f"{split_ms * 1e3:.1f}, csr one group a row {whole_ms * 1e3:.1f} "
                  f"[{card_name}, {card_limit}]")
        del pack, p, whole


def auto_cases(n):
    """bench.py:338-376's three patterns at n, in its order of draws:
    banded (bandwidth 16), the same band under shuffled labels, and uniform
    with 6 entries a row (duplicates removed)."""
    rng = np.random.default_rng(0)

    def banded(shuffle=None):
        i = np.repeat(np.arange(n), 2 * BANDWIDTH + 1)
        j = i + np.tile(np.arange(-BANDWIDTH, BANDWIDTH + 1), n)
        keep = (j >= 0) & (j < n)
        i, j = i[keep], j[keep]
        v = rng.standard_normal(len(i)).astype(np.float32)
        if shuffle is not None:
            i, j = shuffle[i], shuffle[j]
        return i, j, v

    def uniform(k=6):
        i = np.repeat(np.arange(n), k)
        j = rng.integers(0, n, k * n)
        v = rng.standard_normal(k * n).astype(np.float32)
        _, uniq = np.unique(i.astype(np.int64) * n + j, return_index=True)
        return i[uniq], j[uniq], v[uniq]

    return {"banded": banded(), "shuffled_banded": banded(rng.permutation(n)),
            "uniform": uniform()}


def coo_csr64(r, c, v, n_rows, n_cols):
    """scipy CSR of the COO in float64 (complex128), duplicates summed."""
    import scipy.sparse as sp
    dt = np.complex128 if np.iscomplexobj(v) else np.float64
    return sp.csr_matrix((np.asarray(v, dt), (r, c)), shape=(n_rows, n_cols))


class GELLPlanes:
    """A complex GELL pack seen through its planes entry, as a split-plane
    operator: the loop the JAX package runs for a complex GELL operator on a
    backend without complex dtypes (``gell_matvec`` through
    ``gell_matvec_planes``), driven by ``power_method_split_complex``."""

    def __init__(self, pack, matvec):
        self.pack, self.matvec = pack, matvec
        self.shape, self.device = pack.shape, pack.device
        self.dtype = pack.vector_dtype.to_real()

    def encode_vec(self, x):
        return x

    def decode_vec(self, x):
        return x


def general_sparse_kernel_phase(ctx):
    """Phase 17: B6 against its plain version on the card, on bench.py's
    general operators at 1M rows x 33 entries a row (uniform and local
    columns): f32 values, bf16 values (f32 sums), f64, complex64 on native
    vectors and on re/im planes, complex128, each by the route the dispatch
    picks, by the CSR route and by the windowed route at cluster sizes 1, 2
    and 4; small cases (the empty matrix, empty rows, duplicates, a
    5000-entry row, the 700 x 40000 rectangle); hub rows split by the CSR
    route. Times per call from a CUDA-graph replay for every route, plain versions (which read the device
    to size their row ids) between CUDA events, ``torch.sparse.mm`` of the
    CSR times the (n, 1) block beside them. Returns ({tag: max abs error},
    {tag: (picked route's ms, plain ms, CSR-equivalent bytes, flops, {route:
    ms}, picked route)}, {tag: library ms}, the uniform COO)."""
    import dataclasses

    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs

    dev, card_name, card_limit = ctx["dev"], ctx["card_name"], ctx["card_limit"]
    rng = np.random.default_rng(170)
    errors, timings, library = {}, {}, {}

    def compare(label, y, y_ref, limit, tag=None):
        torch.cuda.synchronize()
        err = rel_err(y, y_ref)
        print(f"check {label}: rel err {err:.3e} (limit {limit:.0e})")
        check(y.shape == y_ref.shape and y.dtype == y_ref.dtype, f"{label}: shape or dtype")
        check(torch.isfinite(y).all().item(), f"{label}: non-finite output")
        check(err <= limit, f"{label}: rel err {err:.3e} above {limit:.0e}")
        if tag:
            errors[tag] = float((y - y_ref).abs().max())

    def nbytes(pack, x, y):
        return sum(t.numel() * t.element_size()
                   for t in (pack.values, pack.indices, pack.indptr, x, y))

    def plain_timer(fn):
        return time_events_ms(fn, reps=3)

    uniform_coo = None
    for pattern in ("uniform", "local"):
        t0 = time.perf_counter()
        r, c, v = general_coo(N, GELL_PER_ROW, pattern)
        if pattern == "uniform":
            uniform_coo = (r, c, v)
        pack = gs.pack_gell(r, c, v, (N, N), device=dev)
        t_pack = time.perf_counter() - t0
        im = torch.from_numpy(rng.standard_normal(pack.nnz).astype(np.float32)).to(dev)
        cpack = gs.attach_windows(dataclasses.replace(
            pack, values=torch.stack([pack.values, im], -1), is_complex=True, windows=None))
        win = pack.windows
        print(f"B6 {pattern} {N}x{GELL_PER_ROW}: nnz {pack.nnz}, group {pack.group} lanes a "
              f"row, route {gs.pick_route(pack)}"
              + (f" (R {win.rows} rows, W {win.cols} columns, {win.n_ranges} ranges, cluster "
                 f"{win.cluster}, {win.staged_windows} windows staged)" if win else "")
              + f", packed in {t_pack:.1f} s host")
        cases = {"f32": pack, "bf16": pack.with_values_dtype(torch.bfloat16),
                 "f64": pack.with_values_dtype(torch.float64), "c64": cpack,
                 "c128": cpack.with_values_dtype(torch.float64)}
        xr, xi = rng.uniform(-1, 1, N), rng.uniform(-1, 1, N)
        for name, p in cases.items():
            x = torch.from_numpy(xr + 1j * xi if p.is_complex else xr).to(dev, p.vector_dtype)
            limit = 1e-12 if name in ("f64", "c128") else 1e-5
            main = pattern == "uniform" and name == "f32"
            ref = gs.gell_matvec_plain(p, x)
            y = gs.gell_matvec(p, x)
            compare(f"B6 gell_kernel {name} {pattern} {N}x{GELL_PER_ROW} (route "
                    f"{gs.pick_route(p)})", y, ref, limit, "B6" if main else None)
            # every route and cluster size, native and on planes, against the plain version
            variants = {"csr": (p, "csr")}
            variants.update({f"windows c{cs}": (gs.with_windows(p, cs), "windows")
                             for cs in gs.CLUSTER_SIZES})
            planes = torch.stack([x.real, x.imag]) if p.is_complex else None
            ref_p = gs.gell_matvec_planes_plain(p, planes) if p.is_complex else None
            for label, (pv, route) in variants.items():
                compare(f"B6 {label} {name} {pattern}", gs.gell_kernel(pv, x, route=route), ref,
                        limit)
                if p.is_complex:
                    yp = gs.gell_planes_kernel(pv, planes, route=route)
                    compare(f"B6 cpx {label} {name} planes {pattern}", yp, ref_p, limit)
                    compare(f"B6 cpx {label} planes against native {name} {pattern}",
                            torch.complex(yp[0], yp[1]), y, limit)
            if main:
                compare("B6 windows against its own plain version (window_coo)",
                        gs.gell_kernel(variants["windows c1"][0], x, route="windows"),
                        gs.gell_window_matvec_plain(variants["windows c1"][0], x), limit)
            if p.is_complex:
                yp = gs.gell_matvec_planes(p, planes)
                compare(f"B6 gell_planes_kernel {name} planes {pattern} (route "
                        f"{gs.pick_route(p, planes=True)})", yp, ref_p, limit,
                        "B6cpx" if pattern == "uniform" and name == "c64" else None)
            if name not in ("f32", "bf16", "c64"):
                del variants
                continue
            entries = [(name, x, False)] + ([("c64 planes", planes, True)] if p.is_complex else [])
            for label, vec, on_planes in entries:
                kernel = gs.gell_planes_kernel if on_planes else gs.gell_kernel
                row = {v_label: min(time_ms(lambda: kernel(pv, vec, route=route))
                                    for _ in range(2))
                       for v_label, (pv, route) in variants.items()}
                picked = gs.pick_route(p, planes=on_planes)
                picked_label = "csr" if picked == "csr" else f"windows c{p.windows.cluster}"
                plain_fn = ((lambda: gs.gell_matvec_planes_plain(p, vec)) if on_planes
                            else (lambda: gs.gell_matvec_plain(p, vec)))
                p_ms = plain_timer(plain_fn) if name != "bf16" else None
                flops = (8 if p.is_complex else 2) * p.nnz
                tag = ("B6cpx" if on_planes else name, pattern)
                timings[tag] = (row[picked_label], p_ms, nbytes(p, vec, ref_p if on_planes else y),
                                flops, row, picked_label)
                if not on_planes and name in ("f32", "c64"):
                    # the library call: torch.sparse.mm of the CSR times the (n, 1)
                    # block (timed only; the port never calls it)
                    vals = p.values if not p.is_complex else torch.complex(p.values[:, 0],
                                                                           p.values[:, 1])
                    csr = torch.sparse_csr_tensor(p.indptr.long(), p.indices.long(), vals,
                                                  (N, N))
                    y_lib = torch.sparse.mm(csr, x[:, None])[:, 0]
                    compare(f"library torch.sparse.mm (CSR) {name} {pattern} against the "
                            f"kernel", y_lib, y, limit)
                    library[(name, pattern)] = time_events_ms(
                        lambda: torch.sparse.mm(csr, x[:, None]), reps=20)
                    del csr, y_lib
            del variants
        del cases, pack, cpack
    for (name, pattern), (k_ms, p_ms, nb, _, row, picked) in timings.items():
        lib = library.get(("c64" if name == "B6cpx" else name, pattern))
        print(f"time B6 {'c64 planes' if name == 'B6cpx' else name} {pattern} {N}x"
              f"{GELL_PER_ROW} (us per call): "
              + ", ".join(f"{label} {ms * 1e3:.1f}" for label, ms in row.items())
              + (f", plain {p_ms * 1e3:.1f}" if p_ms is not None else "")
              + (f", torch.sparse.mm {lib * 1e3:.1f}" if lib is not None else "")
              + f"; picked {picked}: {k_ms * 1e3:.1f} ({nb / 1e6:.0f} MB of CSR-equivalent "
              f"bytes, bound {nb / HBM_BYTES_PER_S * 1e6:.1f} us, "
              f"{nb / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s) "
              f"[{card_name}, {card_limit}]")

    gell_hub_checks(dev, card_name, card_limit)

    # small cases, f32 and complex64, against the plain version
    none = np.zeros(0, np.int64)
    small = {
        "empty 64x64": (none, none, np.zeros(0, np.float32), (64, 64)),
        "empty rows": (np.array([2, 2, 9]), np.array([1, 7, 3]), np.float32([1, 2, 3]),
                       (12, 10)),
        "duplicates": (np.array([3, 3, 3, 3, 7, 7]), np.array([5] * 6),
                       np.float32([1, 2, 3, 4, 10, 20]), (10, 10)),
        "5000-entry row": (np.concatenate([np.full(5000, 3), np.arange(40)]),
                           np.concatenate([rng.integers(0, 6000, 5000), np.arange(40)]),
                           rng.standard_normal(5040).astype(np.float32), (40, 6000)),
        "700x40000": (rng.integers(0, 700, 15_000), rng.integers(0, 40_000, 15_000),
                      rng.standard_normal(15_000).astype(np.float32), (700, 40_000)),
    }
    for label, (r, c, v, shape) in small.items():
        for cplx in (False, True):
            vv = (v + 1j * v[::-1]).astype(np.complex64) if cplx else v
            p = gs.pack_gell(r, c, vv, shape, device=dev)
            x = torch.from_numpy(rng.uniform(-1, 1, shape[1])).to(dev, p.vector_dtype)
            y, y_ref = gs.gell_matvec(p, x), gs.gell_matvec_plain(p, x)
            torch.cuda.synchronize()
            if label == "empty 64x64":
                check(torch.equal(y, y_ref) and not y.any().item(), f"B6 {label}: not zero")
                continue
            compare(f"B6 {label} {'c64' if cplx else 'f32'} (route {gs.pick_route(p)})", y,
                    y_ref, 1e-5)
            # the windowed route on small ranges and windows (64 rows, 128 columns)
            for cs in gs.CLUSTER_SIZES:
                pw = gs.with_windows(p, cs, rows=64, cols=128)
                yw = gs.gell_kernel(pw, x, route="windows")
                compare(f"B6 {label} {'c64' if cplx else 'f32'} windows c{cs}", yw, y_ref, 1e-5)
            if label == "duplicates" and not cplx:
                want = torch.tensor([10.0, 30.0], device=dev) * x[5]
                check(torch.allclose(y[[3, 7]], want, rtol=1e-6), "B6 duplicates do not sum")
                check(torch.allclose(yw[[3, 7]], want, rtol=1e-6),
                      "B6 windows: duplicates do not sum")
    return errors, timings, library, uniform_coo


def general_sparse_path_phase(ctx, uniform_coo):
    """Phase 18: the general-sparse path through the public API on CUDA
    tensors. (a) ``from_coo(layout="auto")`` on bench.py's three auto
    patterns at n = 100,000 (kinds as ``BENCH_R05_SET.jsonl:8`` records
    them), ``power_method`` with a budget of 200 iterations (tolerance 0) on
    each auto pick and on the hand-picked layout (GELL for the shuffled
    band), held to the loop driven by the plain matvec; (b)
    ``power_method`` on ``SparseGELL`` at 1M x 33 uniform, with the budget
    against the plain loop and converging on a planted variant (values /
    sqrt(33), 14, 10, 8 on the first three diagonal entries) against scipy's
    ``eigs`` and the residual with scipy's CSR in float64; (c) a planted
    shuffled band through the auto layout (``PermutedOperator``), its
    eigenvector in the caller's indexing held to the residual of the COO in
    float64; (d) ``data/B.txt`` as complex128 ``to_gell()`` against numpy;
    (e) the complex64 uniform operator through the planes entry
    (``GELLPlanes``), the JAX package's complex GELL loop, against the plain
    planes loop and the native complex loop. The launch counts of B6 and of
    the banded kernels are zeroed before the runs and read after them (the
    plain loops launch nothing). Returns the launch counts."""
    import dataclasses

    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import split_complex as sc_ops
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import (
        norm, power_iteration_loop, vdot)

    dev, card_name, card_limit = ctx["dev"], ctx["card_name"], ctx["card_limit"]
    budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
    converge = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-6)

    def plain_matvec(M):
        inner = M.inner if isinstance(M, eigsol.PermutedOperator) else M
        if isinstance(inner, eigsol.InterleavedDIA):
            return lambda v: ds.dia_matvec_il_plain(inner.data_il, inner.offsets, v)
        return lambda v: gs.gell_matvec_plain(inner.pack, v)

    # (a) the auto layout at 100k
    ops, coo = {}, {}
    want = {"banded": ("InterleavedDIA", False), "shuffled_banded": ("InterleavedDIA", True),
            "uniform": ("SparseGELL", False)}
    for name, (i, j, v) in auto_cases(AUTO_N).items():
        t0 = time.perf_counter()
        dec = eigsol.suggest_layout(i, j, v, (AUTO_N, AUTO_N))
        t1 = time.perf_counter()
        auto = eigsol.from_coo(i, j, v, (AUTO_N, AUTO_N), layout="auto", device=dev)
        t2 = time.perf_counter()
        hand = eigsol.from_coo(i, j, v, (AUTO_N, AUTO_N),
                               layout="dia_il" if name == "banded" else "gell", device=dev)
        kind = type(getattr(auto, "inner", auto)).__name__
        print(f"auto {name} n={AUTO_N} nnz={len(i)}: {kind}"
              f"{' (permuted)' if isinstance(auto, eigsol.PermutedOperator) else ''}, "
              f"suggest_layout {t1 - t0:.2f} s, from_coo {t2 - t1:.2f} s host; stats {dec.stats}")
        check((kind, isinstance(auto, eigsol.PermutedOperator)) == want[name],
              f"auto {name}: picked {kind}")
        check(auto.device.type == "cuda", f"auto {name}: not on the card")
        ops[(name, "auto")], ops[(name, "hand")] = auto, hand
        coo[name] = (i, j, v)
    # (b) SparseGELL at 1M x 33, budget and planted
    r, c, v = uniform_coo
    t0 = time.perf_counter()
    ops[("gell 1M", "budget")] = eigsol.SparseGELL.from_coo(r, c, v, (N, N), device=dev)
    plant = np.arange(3)
    r2, c2 = np.concatenate([r, plant]), np.concatenate([c, plant])
    v2 = np.concatenate([v / np.sqrt(GELL_PER_ROW), [14.0, 10.0, 8.0]]).astype(np.float32)
    ops[("gell 1M", "planted")] = eigsol.SparseGELL.from_coo(r2, c2, v2, (N, N), device=dev)
    print(f"SparseGELL.from_coo at {N}x{GELL_PER_ROW}: {(time.perf_counter() - t0) / 2:.1f} s "
          f"host each")
    # (c) a planted shuffled band, through the auto layout
    rng = np.random.default_rng(18)
    i = np.repeat(np.arange(AUTO_N), 2 * BANDWIDTH + 1)
    j = i + np.tile(np.arange(-BANDWIDTH, BANDWIDTH + 1), AUTO_N)
    keep = (j >= 0) & (j < AUTO_N)
    i, j = i[keep], j[keep]
    vb = (rng.uniform(-1, 1, len(i)) / np.sqrt(2 * BANDWIDTH + 1)).astype(np.float32)
    vb[(i == j) & (i < 3)] = (14.0, 10.0, 8.0)
    shuffle = rng.permutation(AUTO_N)
    coo["planted shuffled"] = (shuffle[i], shuffle[j], vb)
    ops[("planted shuffled", "auto")] = eigsol.from_coo(*coo["planted shuffled"],
                                                        (AUTO_N, AUTO_N), device=dev)
    check(isinstance(ops[("planted shuffled", "auto")], eigsol.PermutedOperator),
          "planted shuffled band: not permuted")
    # (d) the reference's sparse file as complex128 GELL
    B_csr = eigsol.read_matrix_from_file("data/B.txt", torch.complex128, device=dev)
    B = B_csr.to_gell()
    # (e) the complex64 operator through the planes entry
    im = np.random.default_rng(19).standard_normal(len(v)).astype(np.float32)
    cgell = eigsol.SparseGELL.from_coo(r, c, (v + 1j * im).astype(np.complex64), (N, N),
                                       device=dev)
    planes_op = GELLPlanes(cgell.pack, lambda x: gs.gell_matvec_planes(cgell.pack, x))

    runs = {key: (M, converge if key[1] == "planted" or key[0] == "planted shuffled"
                  else budget) for key, M in ops.items()}
    runs[("B.txt", "gell c128")] = (B, eigsol.SolverOptions(max_iterations=1000,
                                                            tolerance=1e-10))
    runs[("gell 1M c64", "native")] = (cgell, budget)
    runs[("gell 1M c64", "planes")] = (planes_op, budget)
    x0s = {N: np.random.default_rng(1).uniform(-1, 1, N),
           AUTO_N: np.random.default_rng(1).uniform(-1, 1, AUTO_N),
           5: np.ones(5)}

    def start(M):
        x0 = x0s[M.shape[0]]
        return np.stack([x0, np.zeros_like(x0)]) if isinstance(M, GELLPlanes) else x0

    def solve(M, opts):
        if isinstance(M, GELLPlanes):
            return eigsol.power_method_split_complex(M, opts, x0=start(M))
        return eigsol.power_method(M, opts, x0=start(M))

    for M, _ in runs.values():  # warm-up (allocator, library handles)
        solve(M, eigsol.SolverOptions(max_iterations=3))
    torch.cuda.synchronize()

    t_path = time.perf_counter()
    gs.reset_launch_counts()
    ds.reset_launch_counts()
    results, seconds = {}, {}
    for key, (M, opts) in runs.items():
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        results[key] = solve(M, opts)
        end.record()
        end.synchronize()
        seconds[key] = begin.elapsed_time(end) / 1e3
    launches = {k.__name__: k.launches for k in (*gs.KERNELS, *ds.KERNELS)}
    print(f"phase-18 launches: {launches}; B6 by route: {dict(gs.ROUTE_LAUNCHES)}")
    for key, (M, _) in runs.items():
        pack = getattr(M, "pack", None)
        if pack is not None:
            print(f"phase-18 route {key[0]} {key[1]}: "
                  f"{gs.pick_route(pack, planes=isinstance(M, GELLPlanes))}")
    # B1's window under the permuted bands, its power step on the plain band
    for name in ("gell_kernel", "gell_planes_kernel", "dia_il_kernel", "dia_il_power_kernel",
                 "power_finish_kernel"):
        check(launches[name] > 0, f"{name} was not launched by the phase-18 paths")
    print(f"phase-18 paths: {time.perf_counter() - t_path:.1f} s")

    # the budget runs against the loop driven by the plain matvec; the
    # eigenvalue is held relative to max(|lambda|, ||A x||) of the plain
    # loop, since an unconverged Rayleigh quotient may sit far below ||A||
    per_iter = {}
    for key, (M, opts) in runs.items():
        if opts is not budget:
            continue
        r_k = results[key]
        if isinstance(M, GELLPlanes):
            plain = PlainMatvec(M, lambda x: gs.gell_matvec_planes_plain(M.pack, x))
            ref = eigsol.power_method_split_complex(plain, budget, x0=start(M))
            lam = complex(sc_ops.from_planes(r_k.eigenvalue))
            lam_ref = complex(sc_ops.from_planes(ref.eigenvalue))
            scale = max(abs(lam_ref), float(sc_ops.splitc_norm(plain.matvec(ref.eigenvector))))
        else:
            vec_dt = torch.promote_types(M.dtype, torch.float32)
            xs = torch.from_numpy(start(M)).to(dev, vec_dt)
            plain = plain_matvec(M)
            ref = power_iteration_loop(plain, vdot, norm, M.encode_vec(xs / norm(xs)),
                                       opts.max_iterations, opts.tolerance)
            lam, lam_ref = complex(r_k.eigenvalue), complex(ref.eigenvalue)
            scale = max(abs(lam_ref), float(norm(plain(ref.eigenvector))))
        err = abs(lam - lam_ref) / scale
        per_iter[key] = seconds[key] / int(r_k.iterations)
        print(f"power {key[0]} {key[1]} budget: lambda {lam:.7g} vs plain loop {lam_ref:.7g} "
              f"(err {err:.2e} of {scale:.4g}, limit 1e-4), {int(r_k.iterations)} iterations "
              f"(plain {int(ref.iterations)}), {per_iter[key] * 1e6:.1f} us/iteration "
              f"[{card_name}, {card_limit}]")
        # tolerance 0 still stops where the Rayleigh quotient repeats exactly
        check(0 < int(r_k.iterations) <= budget.max_iterations, f"{key}: iteration count")
        check(torch.isfinite(r_k.eigenvector).all().item(), f"{key}: bad eigenvector")
        check(err <= 1e-4, f"{key}: eigenvalue off the plain loop by {err:.2e}")
    for name in ("banded", "shuffled_banded", "uniform"):
        print(f"auto/hand-pick {name}: {per_iter[(name, 'auto')] * 1e6:.1f} / "
              f"{per_iter[(name, 'hand')] * 1e6:.1f} us/iteration, ratio "
              f"{per_iter[(name, 'hand')] / per_iter[(name, 'auto')]:.2f}x")
    # the host's share of a B6 call in these host-bound loops: the time to
    # enqueue one call (checks, the route's pick, the ctypes launch)
    for key in (("gell 1M", "budget"), ("gell 1M c64", "native")):
        pack = runs[key][0].pack
        x = torch.ones(pack.shape[1], dtype=pack.vector_dtype, device=dev)
        gs.gell_kernel(pack, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            gs.gell_kernel(pack, x)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"host enqueue of a B6 call ({key[0]}, route {gs.pick_route(pack)}): "
              f"{host_us:.1f} us [{card_name}, {card_limit}]")
    lam_n = complex(results[("gell 1M c64", "native")].eigenvalue)
    lam_p = complex(sc_ops.from_planes(results[("gell 1M c64", "planes")].eigenvalue))
    print(f"complex GELL native against planes: {lam_n:.7g} vs {lam_p:.7g}")

    # converging runs against scipy in float64, residuals in the caller's indexing
    from scipy.sparse.linalg import eigs
    for key, (rr, cc, vv, n) in ((("gell 1M", "planted"), (r2, c2, v2, N)),
                                 (("planted shuffled", "auto"),
                                  (*coo["planted shuffled"], AUTO_N))):
        A = coo_csr64(rr, cc, vv, n, n)
        lam_ref = complex(eigs(A, k=1, which="LM", v0=np.ones(n), ncv=20,
                               return_eigenvectors=False)[0])
        res = results[key]
        lam = complex(res.eigenvalue)
        x = res.eigenvector.cpu().numpy().astype(np.float64)
        resid = np.linalg.norm(A @ x - lam * x) / abs(lam) / np.linalg.norm(x)
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"power {key[0]} converge: lambda {lam:.7g} vs scipy eigs {lam_ref:.7g} (rel "
              f"{err:.2e}, limit 1e-4), {int(res.iterations)} iterations, "
              f"converged={bool(res.converged)}, |A v - lambda v| / |lambda| {resid:.2e} "
              f"(limit 1e-3), {seconds[key]:.3f} s")
        check(bool(res.converged), f"{key}: did not converge")
        check(err <= 1e-4, f"{key}: eigenvalue off scipy by {err:.2e}")
        check(resid <= 1e-3, f"{key}: residual {resid:.2e}")
    res = results[("B.txt", "gell c128")]
    ev = np.linalg.eigvals(B_csr.to_dense().cpu().numpy())
    lam_ref = complex(ev[np.argmax(np.abs(ev))])
    err = abs(complex(res.eigenvalue) - lam_ref) / abs(lam_ref)
    print(f"data/B.txt to_gell complex128: lambda {complex(res.eigenvalue):.10g} vs numpy "
          f"{lam_ref:.10g} (rel {err:.2e}, limit 1e-6), {int(res.iterations)} iterations")
    check(bool(res.converged) and err <= 1e-6, "data/B.txt to_gell: eigenvalue")
    del ops, runs, results, cgell, planes_op, B
    return launches


def b6_host_compare(root: str) -> None:
    """``--b6-host ROOT`` (see the module docstring). Prints one line a
    reading; fails if the port is not the one under ROOT or a run does not
    finish with a finite eigenvalue."""
    import os

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.abspath(eigsol.__file__).startswith(os.path.abspath(root) + os.sep),
          f"the port under {root} was not the one imported")
    card_name, card_limit = card_line().split(", ")
    r, c, v = general_coo(N, GELL_PER_ROW, "uniform")
    im = np.random.default_rng(19).standard_normal(len(v)).astype(np.float32)
    ops = {"f32": eigsol.SparseGELL.from_coo(r, c, v, (N, N), device="cuda"),
           "c64": eigsol.SparseGELL.from_coo(r, c, (v + 1j * im).astype(np.complex64), (N, N),
                                             device="cuda")}
    for name, M in ops.items():
        x = torch.ones(N, dtype=torch.promote_types(M.dtype, torch.float32), device="cuda")
        gs.gell_kernel(M.pack, x)
        torch.cuda.synchronize()
        readings = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(200):
                gs.gell_kernel(M.pack, x)
            readings.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        print(f"b6-host {root}: enqueue of a B6 call ({name}): "
              + ", ".join(f"{us:.1f}" for us in readings) + f" us [{card_name}, {card_limit}]")
    x0 = np.random.default_rng(1).uniform(-1, 1, N)
    budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
    for name, M in ops.items():
        eigsol.power_method(M, eigsol.SolverOptions(max_iterations=3), x0=x0)
        readings = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eigsol.power_method(M, budget, x0=x0)
            torch.cuda.synchronize()
            readings.append((time.perf_counter() - t0) / int(res.iterations) * 1e6)
            check(np.isfinite(complex(res.eigenvalue)), "power_method: eigenvalue not finite")
        print(f"b6-host {root}: power_method {name} budget 200 ({int(res.iterations)} "
              f"iterations): " + ", ".join(f"{us:.1f}" for us in readings)
              + f" us/iteration [{card_name}, {card_limit}]")


def b6_compare(root: str) -> None:
    """``--b6 ROOT`` (see the module docstring). Prints one line a reading;
    fails if the port is not the one under ROOT or a product is off its
    plain version."""
    eigsol = import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs

    card_name, card_limit = card_line().split(", ")
    x = torch.from_numpy(np.random.default_rng(17).uniform(-1, 1, N)).to("cuda", torch.float32)
    for label, coo in (("uniform", general_coo(N, GELL_PER_ROW, "uniform")),
                       ("hub rows", hub_coo(N))):
        pack = eigsol.SparseGELL.from_coo(*coo, (N, N), device="cuda").pack
        routes = ("picked", "csr") if label == "uniform" else ("csr",)
        for route in routes:
            chosen = gs.pick_route(pack) if route == "picked" else route
            y = gs.gell_kernel(pack, x, route=chosen).double()
            check(rel_err(y, gs.gell_matvec_plain(pack, x.double())) <= 1e-5,
                  f"B6 {label} {route}")
            readings = [min(time_ms(lambda: gs.gell_kernel(pack, x, route=chosen), reps=20)
                            for _ in range(2)) for _ in range(3)]
            print(f"b6 {root}: {label} f32 {N}x{GELL_PER_ROW} {route} ({chosen}): "
                  + ", ".join(f"{ms * 1e3:.2f}" for ms in readings)
                  + f" us per call [{card_name}, {card_limit}]")
        del pack


def b11_compare(root: str) -> None:
    """``--b11 ROOT`` (see the module docstring). Prints one line a size;
    fails if the port is not the one under ROOT or an H is not finite."""
    import os

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.abspath(eigsol.__file__).startswith(os.path.abspath(root) + os.sep),
          f"the port under {root} was not the one imported")
    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(5)
    for n, dt in ((FULL_N, torch.float32), (LARGE_N, torch.complex64), (1024, torch.float32),
                  (LARGE_N, torch.float32), (QR_N, torch.float32)):
        a, _ = device_operand(rng, n, dt, "cuda", "gaussian")
        with_q = time_events_ms(lambda: hb.hessenberg_blocked_kernel(a, accumulate_q=True))
        without_q = time_events_ms(lambda: hb.hessenberg_blocked_kernel(a))
        check(bool(torch.isfinite(hb.hessenberg_blocked_kernel(a)).all()), "B11: H not finite")
        kernels = getattr(hb.hessenberg_blocked_kernel, "device_launches", "not counted")
        print(f"b11 {root}: {dt} n={n}: with Q {with_q:.3f} ms, without Q {without_q:.3f} ms "
              f"(three calls after a warm-up), device kernels a call {kernels} "
              f"[{card_name}, {card_limit}]")
        del a


def import_port(root: str):
    """The port found under ROOT (another checkout, for a comparison in turns)."""
    import os

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.abspath(eigsol.__file__).startswith(os.path.abspath(root) + os.sep),
          f"the port under {root} was not the one imported")
    return eigsol


def b7_compare(root: str) -> None:
    """``--b7 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT or an H is not finite."""
    import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(7)
    for n, dt in ((QR_N, torch.float32), (QR_N, torch.complex64), (256, torch.float32),
                  (1023, torch.float32), (QR_N, torch.float64)):
        a, _ = device_operand(rng, n, dt, "cuda", "gaussian")
        without_q = time_events_ms(lambda: qk.hessenberg_kernel(a), 5)
        with_q = time_events_ms(lambda: qk.hessenberg_kernel(a, accumulate_q=True), 5)
        check(bool(torch.isfinite(qk.hessenberg_kernel(a)).all()), "B7: H not finite")
        kernels = device_kernels(lambda: qk.hessenberg_kernel(a))
        print(f"b7 {root}: {dt} n={n}: without Q {without_q:.3f} ms, with Q {with_q:.3f} ms "
              f"(five calls after a warm-up), device kernels a call "
              f"{'not measured' if kernels is None else len(kernels)} "
              f"[{card_name}, {card_limit}]")
        del a


def b5_compare(root: str) -> None:
    """``--b5 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT or a product is not finite."""
    eigsol = import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers import subspace as sub

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(8)
    op32 = banded_full(N, bandwidth=BANDWIDTH, dtype=np.float32, seed=0, device="cuda")
    offs = op32.offsets
    pr = ds.il_window_halo(offs)
    for dt in (torch.float32, torch.bfloat16, torch.float64, torch.complex64):
        vals = op32.data.to(dt)
        acc = ds.acc_dtype(dt)
        xs = torch.from_numpy(rng.uniform(-1, 1, (8, N))).to("cuda", acc)
        il_vals = ds.interleave_dia_vals(vals, ds.il_rows(N))
        w8 = ds._il_window(torch.stack([ds.interleave_vec(v, il_vals.shape[1]) for v in xs]), pr)
        M = eigsol.SparseDIA(data=vals, offsets=offs, shape=(N, N))
        X = xs.T.contiguous()
        rowmajor = min(time_ms(lambda: ds.dia_block_kernel(vals, offs, xs)) for _ in range(2))
        window = min(time_ms(lambda: ds.dia_il_block_kernel(il_vals, offs, w8)) for _ in range(2))
        block = min(time_ms(lambda: sub._apply_block(M, X)) for _ in range(2))
        check(bool(torch.isfinite(sub._apply_block(M, X)).all()), "B5: product not finite")
        print(f"b5 {root}: {dt} {N}x33 nvec 8: row-major {rowmajor * 1e3:.1f} us, interleaved "
              f"{window * 1e3:.1f} us, the solvers' (n, 8) block (_apply_block) "
              f"{block * 1e3:.1f} us [{card_name}, {card_limit}]")
        del vals, xs, il_vals, w8, M, X
    # the block solvers of phase 16 at a fixed budget (tolerance 0: 30
    # subspace sweeps of k = 3, block 8; 8 Chebyshev sweeps of k = 4), two
    # solves between CUDA events after a warm-up, and the device's busy share
    # of a 10-sweep subspace chunk
    sym = symmetric_band(N, (8.0, 7.0, 6.5, 6.0), seed=5)
    s32 = eigsol.SparseDIA(data=torch.from_numpy(sym).to("cuda"), offsets=offs, shape=(N, N))
    budget = {"subspace": eigsol.SolverOptions(max_iterations=30, tolerance=0.0),
              "chebyshev": eigsol.SolverOptions(max_iterations=8, tolerance=0.0)}
    for name, M in (("subspace DIA", op32), ("subspace IL", op32.interleaved()),
                    ("chebyshev DIA", s32), ("chebyshev IL", s32.interleaved())):
        kind = name.split()[0]
        solve = eigsol.subspace_iteration if kind == "subspace" else \
            eigsol.chebyshev_subspace_iteration
        k = 3 if kind == "subspace" else 4
        ms = time_events_ms(lambda: solve(M, k=k, opts=budget[kind]), 2)
        print(f"b5 {root}: {name} f32 {N}x33, {budget[kind].max_iterations} sweeps: "
              f"{ms:.3f} ms a solve [{card_name}, {card_limit}]")
        if name.startswith("subspace"):
            rows = isinstance(M, eigsol.InterleavedDIA)
            X = sub._start_block(M, N, 8, torch.float32, None, None, rows)
            chunk = sub._subspace_chunk_rows if rows else sub._subspace_chunk
            profile_breakdown(f"b5 {root}: {name} f32 chunk of 10 sweeps",
                              lambda: chunk(M, X, 10), top=3)


def b13_compare(root: str) -> None:
    """``--b13 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT, a result is not finite or
    the solve does not converge."""
    eigsol = import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(13)
    sweeps = 4
    full = {}
    for n in (QR_N, LARGE_N, FULL_N):
        h = qk.hessenberg_reduce(device_operand(rng, n, torch.complex64, "cuda", "gaussian")[0])
        eig_ms = time_events_ms(lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0), 2) / sweeps
        schur_ms = time_events_ms(
            lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0, accumulate_q=True), 2) / sweeps
        check(bool(torch.isfinite(qb.qr_eig_blocked_kernel(h, sweeps, 0.0)[0]).all()),
              "B13: eigenvalues not finite")
        kernels = device_kernels(lambda: qb.qr_eig_blocked_kernel(h, sweeps, 0.0))
        print(f"b13 {root}: complex64 n={n} bs={qb.BLOCK}: {eig_ms:.4f} ms a full-window sweep, "
              f"Schur mode {schur_ms:.4f} ({sweeps} sweeps a call, two calls after a warm-up), "
              f"device kernels a call {'not measured' if kernels is None else len(kernels)} "
              f"[{card_name}, {card_limit}]")
        full[n] = h
    # phase 14's non-symmetric solve at LARGE_N through the public path
    g = torch.from_numpy(rng.uniform(-1, 1, (LARGE_N, LARGE_N))).to("cuda", torch.float32)
    opts = eigsol.QROptions(mode="accelerated", max_iterations=20 * LARGE_N, tolerance=QR_TOL)
    eigsol.qr_eigenvalues(eigsol.DenseMatrix(g[:600, :600].contiguous()), opts)  # warm-up
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(g), opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(bool(r.converged), "B13: the non-symmetric solve did not converge")
        launches = getattr(qb.qr_eig_blocked_kernel, "device_launches", "not counted")
        print(f"b13 {root}: non-symmetric float32 n={LARGE_N} solve {seconds:.3f} s, "
              f"{int(r.iterations)} sweeps, B13 launches {launches} [{card_name}, {card_limit}]")
    if not hasattr(qb, "blocked_capacity"):
        return
    # block sizes per full-window sweep
    for n in (LARGE_N, FULL_N):
        line = f"b13 {root}: block sizes, complex64 n={n}, ms a sweep (Schur mode):"
        for bs in (16, 30, 32, 46, 48, 62, 64):
            eig_ms = time_events_ms(
                lambda: qb.qr_eig_blocked_kernel(full[n], sweeps, 0.0, block=bs), 1) / sweeps
            schur_ms = time_events_ms(lambda: qb.qr_eig_blocked_kernel(
                full[n], sweeps, 0.0, accumulate_q=True, block=bs), 1) / sweeps
            line += f" {bs}: {eig_ms:.4f} ({schur_ms:.4f});"
        print(f"{line} [{card_name}, {card_limit}]")


def b14_compare(root: str) -> None:
    """``--b14 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT or a Y is not finite."""
    import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import trisolve_vec as tv

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(14)
    for n in (QR_N, LARGE_N):
        for dt in (torch.complex64, torch.complex128):
            t = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
            T = torch.from_numpy(t + np.diag(np.linspace(1.0, 3.0, n))).to("cuda", dt)
            eps = torch.finfo(dt.to_real()).eps * max(float(T.abs().max()), 1.0)
            ms = min(time_ms(lambda: tv.triangular_eigenvectors_kernel(T, eps), reps=5)
                     for _ in range(2))
            check(bool(torch.isfinite(tv.triangular_eigenvectors_kernel(T, eps)).all()),
                  "B14: Y not finite")
            kernels = device_kernels(lambda: tv.triangular_eigenvectors_kernel(T, eps))
            print(f"b14 {root}: {dt} n={n}: {ms:.4f} ms a call (CUDA-graph replay of five), "
                  f"device kernels a call {'not measured' if kernels is None else len(kernels)} "
                  f"[{card_name}, {card_limit}]")


def b10_compare(root: str) -> None:
    """``--b10 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT, a result is not finite or a
    parity solve does not converge."""
    eigsol = import_port(root)
    import math

    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(10)
    for n, sweeps in ((QR_SWEEP_N, 10), (QR_N, 10)):
        for dt in (torch.float32, torch.complex64):
            h = qk.hessenberg_kernel(device_operand(rng, n, dt, "cuda", "gaussian")[0])
            ms = time_events_ms(lambda: qk.qr_parity_kernel(h, sweeps, 0.0), 2) / sweeps
            check(bool(torch.isfinite(qk.qr_parity_kernel(h, sweeps, 0.0)[0]).all()),
                  "B10: H not finite")
            kernels = device_kernels(lambda: qk.qr_parity_kernel(h, sweeps, 0.0)) \
                if n == QR_SWEEP_N else None
            print(f"b10 {root}: {dt} n={n}: {ms:.4f} ms a sweep ({sweeps} sweeps a call, two "
                  f"calls after a warm-up), device kernels a call "
                  f"{'not measured' if kernels is None else len(kernels)} [{card_name}, {card_limit}]")
    # phase 7's parity solves at QR_N through the public path
    for dt in (torch.float32, torch.complex64):
        a, want = device_operand(rng, QR_N, dt, "cuda", "geometric")
        opts = eigsol.QROptions(mode="parity", tolerance=QR_TOL,
                                max_iterations=max(40 * int(math.log(QR_N) * 10), 2000))
        eigsol.qr_eigenvalues(eigsol.DenseMatrix(a[:64, :64].contiguous()), opts)  # warm-up
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), opts)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            err = nearest_err(r.eigenvalues.cpu().numpy(), want)
            check(bool(r.converged) and err <= 1e-4, f"B10 {dt}: the parity solve failed ({err})")
            launches = getattr(qk.qr_parity_kernel, "device_launches", "not counted")
            print(f"b10 {root}: parity solve {dt} n={QR_N} {seconds:.4f} s, {int(r.iterations)} "
                  f"iterations, eigenvalue error {err:.2e}, B10 cooperative launches {launches} "
                  f"[{card_name}, {card_limit}]")
    # B9 (its split-K: atomics in the parent, ordered partials here)
    for n in (QR_N, LARGE_N, FULL_N):
        a, _ = device_operand(rng, n, torch.float32, "cuda", "gaussian")
        ms = time_events_ms(lambda: qk.qr_decompose_kernel(a), 3)
        r1, q1 = qk.qr_decompose_kernel(a)
        r2, q2 = qk.qr_decompose_kernel(a)
        same = torch.equal(r1, r2) and torch.equal(q1, q2)
        print(f"b9 {root}: float32 n={n}: {ms:.3f} ms a call (three calls after a warm-up), "
              f"device kernels a call {qk.qr_decompose_kernel.device_launches}, a second call "
              f"bitwise equal: {same} [{card_name}, {card_limit}]")
        del a, r1, q1, r2, q2


def b8_compare(root: str) -> None:
    """``--b8 ROOT`` (see the module docstring). Prints one line a case;
    fails if the port is not the one under ROOT, a result is not finite or a
    solve does not converge."""
    import_port(root)
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    card_name, card_limit = card_line().split(", ")
    rng = np.random.default_rng(8)
    sweeps = 10
    for n in (64, QR_SWEEP_N, 256):
        h = qk.hessenberg_plain(device_operand(rng, n, torch.complex64, "cuda", "gaussian")[0])
        g, _ = device_operand(rng, n, torch.float32, "cuda", "geometric")
        g = qk.hessenberg_reduce(g).to(torch.complex64)
        for q in (False, True):
            ms = time_events_ms(lambda: qk.qr_eig_kernel(h, sweeps, 0.0, accumulate_q=q), 2)
            solve = time_events_ms(lambda: qk.qr_eig_kernel(g, 20 * n, QR_TOL, accumulate_q=q), 2)
            e, s, hi = qk.qr_eig_kernel(g, 20 * n, QR_TOL, accumulate_q=q)[:3]
            check(int(hi) <= 1 and bool(torch.isfinite(e).all()), f"B8 n={n}: the solve failed")
            kernels = device_kernels(lambda: qk.qr_eig_kernel(h, sweeps, 0.0, accumulate_q=q))
            print(f"b8 {root}: complex64 n={n} {'with' if q else 'without'} Q: "
                  f"{ms / sweeps:.4f} ms a full-window sweep ({sweeps} sweeps a call), bench "
                  f"operand {solve:.3f} ms ({int(s)} sweeps; two calls after a warm-up each), "
                  f"device kernels a call {'not measured' if kernels is None else len(kernels)} "
                  f"[{card_name}, {card_limit}]")


def aed_operand(rng, n, dev, kind):
    """The four operands of ROADMAP A1 at n: ``"bench"`` (f32, spectrum
    0.9^i), ``"c64"`` (the complex64 normal operand, 0.9^i e^(i theta)),
    ``"nonsym"`` (f32 uniform[-1, 1] entries) and ``"uniform"`` (f32, full
    rank, spectrum uniform[1, 2], BENCH_R05_SET.jsonl:11). Returns (matrix,
    reference spectrum or None for the non-symmetric one, limit)."""
    import torch
    if kind == "bench":
        a, d = device_operand(rng, n, torch.float32, dev, "geometric")
        return a, d, 1e-4
    if kind == "c64":
        a, d = device_operand(rng, n, torch.complex64, dev, "geometric")
        return a, d, 1e-4
    if kind == "nonsym":
        return torch.from_numpy(rng.uniform(-1, 1, (n, n))).to(dev, torch.float32), None, 5e-3
    g = torch.from_numpy(rng.standard_normal((n, n))).to(dev)
    u, _ = torch.linalg.qr(g)
    d = np.sort(rng.uniform(1.0, 2.0, n))[::-1].copy()
    return ((u * torch.from_numpy(d).to(dev)) @ u.T).to(torch.float32), d, 1e-4


def aed_solve(a, driver, vectors, **kw):
    """One solve by ``blocked_eigenvalues`` with ``schur_driver=driver``:
    (eigenvalues, sweeps, converged, V, seconds, AED rounds, launches of B7,
    B8, B11 and B13 by their wrappers)."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    n = a.shape[0]
    qk.reset_launch_counts()
    qr_aed.last_run.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kw:  # the window and the round's sweeps of the table's sweep
        eig, sweeps, conv = qr_aed.qr_eigenvalues_blocked_aed(a, 20 * n, QR_TOL, **kw)
        out = (eig, sweeps, conv, None)
    else:
        out = qb.blocked_eigenvalues(a, 20 * n, QR_TOL, compute_vectors=vectors,
                                     schur_driver=driver)
        out = out if vectors else out + (None,)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"B7": qk.hessenberg_kernel.launches, "B8": qk.qr_eig_kernel.launches,
                "B11": qk.hessenberg_blocked_kernel.launches,
                "B13": qk.qr_eig_blocked_kernel.launches}
    return out + (seconds, qr_aed.last_run.get("rounds", 0), launches)


def eig_error(lam, want, ref_future=None):
    """Nearest-neighbour error against the planted spectrum or numpy's."""
    if want is None:
        want = ref_future.result()
    return nearest_err(lam.cpu().numpy(), want)


def residual(a, lam, V):
    """max_k |A v_k - lambda_k v_k| / |A|_2 on the card."""
    import torch
    ac = a.to(lam.dtype)
    return float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max()) / \
        float(torch.linalg.matrix_norm(ac, 2))


def aed_phase(eigsol, dev, card_name, card_limit):
    """Phase 19: AED on the card. Eigenvalues at 2048 and 4096 of the bench,
    c64 normal and non-symmetric operands and of the uniform-[1, 2]
    full-rank operand at 2048; eigenpairs of the bench operand in float32 and
    of the c64 operand at 2048, and of the bench operand at 4096; each by
    AED (``schur_driver="aed"``) with its sweeps, rounds, seconds, kernel
    launches and error or residual against phase 14's limits, and by plain
    B13 (``"monolithic"``) at 2048 on the same operands; then one solve a
    size through ``qr_eigenvalues``, whose route must follow ``AED_MIN_N``.
    Raises on failure, including the sweep cut at the default window and
    sweeps a round: fewer sweeps under AED than plain B13 on the
    non-symmetric matrix at 2048, fewer than n on the full-rank operand.
    Returns the launches of the public solves."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    rng = np.random.default_rng(190)
    ops = {}
    for n in (LARGE_N, FULL_N):
        for kind in ("bench", "c64", "nonsym"):
            ops[kind, n] = aed_operand(rng, n, dev, kind)
    ops["uniform", LARGE_N] = aed_operand(rng, LARGE_N, dev, "uniform")
    pool = ThreadPoolExecutor(2)  # numpy's float64 spectra, beside the card's work
    refs = {n: pool.submit(np.linalg.eigvals, ops["nonsym", n][0].double().cpu().numpy())
            for n in (LARGE_N, FULL_N)}
    runs = [(kind, n, False) for (kind, n) in ops] + \
        [("bench", LARGE_N, True), ("c64", LARGE_N, True), ("bench", FULL_N, True)]
    records = {("uniform", LARGE_N): TPU_RECORDS["f32 2048"],
               ("c64", LARGE_N): TPU_RECORDS["c64 2048"], ("c64", FULL_N): TPU_RECORDS["c64 4096"]}
    sweeps_of = {}
    for kind, n, vectors in runs:
        a, want, limit = ops[kind, n]
        drivers = ("aed", "monolithic") if n == LARGE_N else ("aed",)
        for driver in drivers:
            lam, sweeps, conv, V, seconds, rounds, launches = aed_solve(a, driver, vectors)
            what = "eigenpairs" if vectors else "eigenvalues"
            line = (f"phase 19 {what} {kind} {a.dtype} n={n} {driver}: {sweeps} sweeps, "
                    f"{rounds} AED rounds, {seconds:.3f} s, launches {launches}")
            check(lam.shape == (n,) and bool(torch.isfinite(lam).all()),
                  f"{line}: bad eigenvalues")
            check(conv, f"{line}: did not converge")
            err = eig_error(lam, want, refs.get(n))
            line += f", eigenvalue error {err:.3e} (limit {limit:.0e}"
            if not vectors and (kind, n) in records:
                line += f"; the JAX package's TPU record {records[kind, n]:.1e}"
            line += ")"
            check(err <= limit, f"{line}: eigenvalue error above the limit")
            if vectors:
                check(V is not None and bool(torch.isfinite(V).all()), f"{line}: bad vectors")
                res = residual(a, lam, V)
                line += (f", residual {res:.3e} (limit {1e-6 * n:.1e}; TPU records "
                         f"{TPU_RECORDS['eigenpairs'][0]:.1e}-{TPU_RECORDS['eigenpairs'][1]:.1e})")
                check(res <= 1e-6 * n, f"{line}: residual above the limit")
            if driver == "aed":
                # the spectra 0.9^i deflate within the warm-up and its
                # remainder; on the others the rounds must run
                check(rounds > 0 or kind in ("bench", "c64"), f"{line}: no AED round ran")
                check(launches["B13"] > 0 and (rounds == 0 or launches["B7"] + launches["B8"] > 0),
                      f"{line}: the AED path did not launch B7/B8 and B13")
            sweeps_of[kind, n, vectors, driver] = sweeps
            print(f"{line} [{card_name}, {card_limit}]")
    pool.shutdown()
    # the sweep cut of tests/test_qr_aed.py:30-45 at the drivers' defaults
    cut = (sweeps_of["nonsym", LARGE_N, False, "aed"],
           sweeps_of["nonsym", LARGE_N, False, "monolithic"])
    uni = (sweeps_of["uniform", LARGE_N, False, "aed"],
           sweeps_of["uniform", LARGE_N, False, "monolithic"])
    print(f"phase 19 sweep cut at the defaults w = {qr_aed.WINDOW} and "
          f"{qr_aed.SWEEPS_PER_ROUND} sweeps a round: non-symmetric f32 {LARGE_N}: AED "
          f"{cut[0]} against plain B13 {cut[1]}; full-rank uniform-[1, 2] {LARGE_N}: AED "
          f"{uni[0]} (fewer than n = {LARGE_N} wanted), plain B13 {uni[1]} (the JAX package's "
          f"record on its TPU: 1887 at w = 256 and 96) [{card_name}, {card_limit}]")
    check(cut[0] < cut[1], "AED did not cut the non-symmetric solve's sweeps")
    check(uni[0] < LARGE_N, "AED took n sweeps or more on the full-rank operand")
    # the public path: qr_eigenvalues' route follows AED_MIN_N
    qk.reset_launch_counts()
    for n in (LARGE_N, FULL_N):
        a, want, limit = ops["bench", n]
        qr_aed.last_run.clear()
        r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), eigsol.QROptions(
            mode="accelerated", max_iterations=20 * n, tolerance=QR_TOL))
        aed = qb.AED_MIN_N is not None and n >= qb.AED_MIN_N
        print(f"phase 19 qr_eigenvalues bench n={n}: AED_MIN_N {qb.AED_MIN_N}, AED driver "
              f"{qr_aed.last_run or 'not run'}, {int(r.iterations)} sweeps")
        check(bool(r.converged) and eig_error(r.eigenvalues, want) <= limit,
              f"qr_eigenvalues at {n}: wrong eigenvalues")
        check(bool(qr_aed.last_run) == aed, f"qr_eigenvalues at {n}: the route does not "
              f"follow AED_MIN_N")
    # C4: the public eigenvalues-only solve of --aed-table's 4096
    # uniform-[1, 2] draw, held to phase 14's limit
    a, want = aed_table_uniform(dev, (FULL_N,))[FULL_N]
    qr_aed.last_run.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), eigsol.QROptions(
        mode="accelerated", max_iterations=20 * FULL_N, tolerance=QR_TOL))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = eig_error(r.eigenvalues, want)
    print(f"phase 19 C4 qr_eigenvalues uniform-[1, 2] n={FULL_N} (--aed-table's draw): "
          f"{int(r.iterations)} sweeps, AED driver {qr_aed.last_run or 'not run'}, "
          f"{seconds:.3f} s, eigenvalue error {err:.3e} (limit 1e-4) [{card_name}, {card_limit}]")
    check(bool(r.converged) and err <= 1e-4, f"C4: the public solve's error {err:.3e} is "
          f"above 1e-4")
    return {kernel.__name__: kernel.launches for kernel in qk.KERNELS}


def aed_table() -> None:
    """``--aed-table`` (see the module docstring): the switch table that set
    ``AED_MIN_N``, ``SCHUR_AED_MIN_N`` and the defaults of the window and of
    the sweeps between two rounds. One line a solve, an error above phase
    14's limits marked on it; raises if a solve does not converge."""
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch  # noqa: F401  (the port, not JAX)

    check(torch.cuda.is_available(), "no CUDA device")
    card_name, card_limit = card_line().split(", ")
    dev = torch.device("cuda")
    rng = np.random.default_rng(191)
    warm, _, _ = aed_operand(rng, 512, dev, "nonsym")
    for driver in ("aed", "monolithic"):  # builds and warms both routes
        aed_solve(warm, driver, False)
    table, grid_ops, missed, c4_ops = {}, [], {}, {}

    def run(kind, n, a, want, limit, driver, vectors, sweeps=False, **kw):
        lam, sweeps_run, conv, V, seconds, rounds, launches = aed_solve(a, driver, vectors,
                                                                         **kw)
        err = eig_error(lam, want)
        tag = f"w={kw['w']} S={kw['sweeps_per_round']}" if kw else driver
        line = (f"aed-table {'eigenpairs' if vectors else 'eigenvalues'} {kind} n={n} {tag}: "
                f"{seconds:.3f} s, {sweeps_run} sweeps, {rounds} rounds, error {err:.2e}")
        if vectors:
            line += f", residual {residual(a, lam, V):.2e}"
        if err > limit:  # recorded, not raised: the table times; phase 19 checks
            line += f" ABOVE phase 14's limit {limit:.0e}"
        if not kw:
            what = "eigenpairs" if vectors else "eigenvalues"
            missed[what, kind, n, driver] = missed.get((what, kind, n, driver), False) or \
                err > limit
        print(f"{line}, launches {launches} [{card_name}, {card_limit}]")
        check(conv, f"{line}: did not converge")
        return (seconds, sweeps_run) if sweeps else seconds

    def pair(kind, n, a, want, limit, vectors):
        """AED and plain B13 in turns (AED, plain, plain, AED); the lower
        time of each."""
        t = [run(kind, n, a, want, limit, d, vectors)
             for d in ("aed", "monolithic", "monolithic", "aed")]
        return min(t[0], t[3]), min(t[1], t[2])

    for n in AED_SIZES:
        for kind in ("bench", "c64", "nonsym", "uniform"):
            a, want, limit = aed_operand(rng, n, dev, kind)
            if want is None:
                want = np.linalg.eigvals(a.double().cpu().numpy())
            (table["eigenvalues", kind, n, "aed"],
             table["eigenvalues", kind, n, "monolithic"]) = pair(kind, n, a, want, limit, False)
            if n >= LARGE_N and kind in ("bench", "nonsym"):
                (table["eigenpairs", kind, n, "aed"],
                 table["eigenpairs", kind, n, "monolithic"]) = pair(kind, n, a, want, limit,
                                                                    True)
            if n == LARGE_N and kind in ("nonsym", "uniform"):
                grid_ops.append((kind, a, want, limit))
            if kind == "uniform":
                c4_ops[n] = (a, want)
    # the window and the round's sweeps at 2048: the sweeps and seconds of
    # each pair on the non-symmetric operand and two uniform-[1, 2] operands
    a, want, limit = aed_operand(rng, LARGE_N, dev, "uniform")
    grid_ops.append(("uniform", a, want, limit))
    grid = {}
    for i, (kind, a, want, limit) in enumerate(grid_ops):
        for w in AED_WINDOWS:
            for s in AED_ROUND_SWEEPS:
                grid[i, w, s] = run(kind, LARGE_N, a, want, limit, "aed", False, w=w,
                                    sweeps_per_round=s, sweeps=True)
    plain = grid_ops[0][1]
    plain_sweeps = aed_solve(plain, "monolithic", False)[1]
    del a, plain, grid_ops
    # C4's backward-error rows on the uniform-[1, 2] operands: plain B13 at
    # each size, AED at the largest (Schur mode)
    c4_rows([("uniform", c4_ops[n][0], c4_ops[n][1], "monolithic", None) for n in AED_SIZES] +
            [("uniform", c4_ops[FULL_N][0], c4_ops[FULL_N][1], "aed", None)],
            card_name, card_limit)
    del c4_ops
    # the rules of the switch constants (ROADMAP A1, C4): the smallest n from
    # which plain B13 misses phase 14's limit on any operand, or AED is no
    # slower on every operand
    def first(what, sizes, kinds):
        return next((n for n in sizes if any(missed[what, k, n, "monolithic"] for k in kinds)
                     or all(table[what, k, n, "aed"] <= table[what, k, n, "monolithic"]
                            for k in kinds)), None)

    aed_min = first("eigenvalues", AED_SIZES, ("bench", "c64", "nonsym", "uniform"))
    schur_min = first("eigenpairs", (LARGE_N, FULL_N), ("bench", "nonsym"))
    for key in sorted(k for k in missed if missed[k]):
        print(f"aed-table {key[0]} {key[1]} n={key[2]} {key[3]}: above phase 14's limit")
    for key in sorted(k for k in table if k[3] == "aed"):
        print(f"aed-table {key[0]} {key[1]} n={key[2]}: AED {table[key]:.3f} s, plain B13 "
              f"{table[key[:3] + ('monolithic',)]:.3f} s (the lower of two in turns)")
    print(f"aed-table rule: AED_MIN_N = {aed_min}, SCHUR_AED_MIN_N = {schur_min} "
          f"[{card_name}, {card_limit}]")
    # the defaults: the least summed time among the pairs that meet the sweep cut
    pairs = [(w, s) for w in AED_WINDOWS for s in AED_ROUND_SWEEPS]
    meets = [(w, s) for (w, s) in pairs if grid[0, w, s][1] < plain_sweeps and
             all(grid[i, w, s][1] <= SWEEP_CUT_MARGIN * LARGE_N for i in (1, 2))]
    for w, s in pairs:
        print(f"aed-table w={w} S={s} n={LARGE_N}: "
              f"{sum(grid[i, w, s][0] for i in range(3)):.3f} s over the three operands, "
              f"sweeps {[grid[i, w, s][1] for i in range(3)]} (plain B13 {plain_sweeps} on "
              f"the non-symmetric one), sweep cut with the margin "
              f"{'met' if (w, s) in meets else 'missed'}")
    best = min(meets, key=lambda p: sum(grid[i, p[0], p[1]][0] for i in range(3)), default=None)
    print(f"aed-table defaults: w, S = {best} [{card_name}, {card_limit}]")


def schur_backward(a, want, driver, chunk=None):
    """C4's measure: the Schur form of ``a`` by plain B13 (``"monolithic"``)
    or the Schur-mode AED driver (``"aed"``) after the Hessenberg reduction
    with Q, at ``QR_TOL`` and at most 20 n sweeps. Returns a dict: sweeps,
    the backward errors ``||X - Q T Q^H||_F / ||X||_F`` in float64 of the
    whole (X = A, Q = Qh Qs), of the reduction alone (A = Qh H Qh^H) and of
    the sweeps alone (H = Qs T Qs^H), the whole with T's deflated
    subdiagonal entries dropped (the eigenvalues the solve reports are
    triu(T)'s), and the eigenvalue error of diag(T) against ``want``. With
    ``chunk``, plain B13 runs ``chunk`` sweeps a call (resumed from the last
    call's T and Q) and the dict also holds ``curve``: (sweeps so far, hi,
    sweeps' backward error) after each call."""
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    n = a.shape[0]
    h, qh = qk.hessenberg_reduce(a, accumulate_q=True)
    if not h.is_complex():
        h, qh = h.to(h.dtype.to_complex()), qh.to(qh.dtype.to_complex())
    wide = torch.complex128

    def rel(x, q, t):
        q, t = q.to(wide), t.to(wide)
        return float(torch.linalg.matrix_norm(x - q @ t @ q.conj().T) /
                     torch.linalg.matrix_norm(x))

    out = {"curve": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if driver == "aed":
        _, sweeps, hi, t, qs = qr_aed.qr_eig_blocked_aed_schur(h, 20 * n, QR_TOL)
        sweeps, hi = int(sweeps), int(hi)
    elif chunk is None:
        _, sweeps, hi, t, qs = qb.blocked_sweeps(h, 20 * n, QR_TOL, accumulate_q=True)
        sweeps, hi = int(sweeps), int(hi)
    else:
        t, qs, sweeps, hi = h, None, 0, n
        qs = torch.eye(n, dtype=h.dtype, device=h.device)
        while hi > 1 and sweeps < 20 * n:
            t, qs, _, s, hi = qb.qr_eig_blocked_step_q(t, qs, min(chunk, 20 * n - sweeps),
                                                       QR_TOL)
            sweeps, hi = sweeps + int(s), int(hi)
            out["curve"].append((sweeps, hi, rel(h.to(wide), qs, t)))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    a64, h64 = a.to(wide), h.to(wide)
    out.update(sweeps=sweeps, converged=hi <= 1, whole=rel(a64, qh @ qs, t),
               reduction=rel(a64, qh, h), sweeps_only=rel(h64, qs, t),
               triu=rel(a64, qh @ qs, torch.triu(t)),
               eig_err=nearest_err(t.diagonal().cpu().numpy(), want))
    return out


def c4_rows(rows, card_name, card_limit) -> None:
    """Print C4's backward-error rows (``schur_backward``) for ``rows``, a
    list of (label, matrix, planted spectrum, driver, chunk)."""
    for label, a, want, driver, chunk in rows:
        r = schur_backward(a, want, driver, chunk)
        print(f"c4 {label} {a.dtype} n={a.shape[0]} {driver}: {r['sweeps']} sweeps, "
              f"converged={r['converged']}, {r['seconds']:.3f} s, backward error "
              f"||A - Q T Q^H||/||A|| {r['whole']:.3e} (reduction {r['reduction']:.3e}, "
              f"sweeps {r['sweeps_only']:.3e}, with the deflated entries dropped "
              f"{r['triu']:.3e}), eigenvalue error of diag(T) {r['eig_err']:.3e} "
              f"(phase 14's limit 1e-4) [{card_name}, {card_limit}]")
        for sweeps, hi, err in r["curve"]:
            print(f"c4 {label} n={a.shape[0]} curve: after {sweeps} sweeps hi={hi}, "
                  f"sweeps' backward error {err:.3e}")


def aed_table_uniform(dev, sizes=AED_SIZES):
    """The uniform-[1, 2] operands that ``--aed-table`` draws from
    ``default_rng(191)`` at ``sizes``, the same draws replayed in the
    table's order: {n: (matrix, planted spectrum)}."""
    rng = np.random.default_rng(191)
    aed_operand(rng, 512, dev, "nonsym")  # the table's warm-up operand
    uniform = {}
    for n in AED_SIZES[:max(AED_SIZES.index(m) for m in sizes) + 1]:
        for kind in ("bench", "c64", "nonsym", "uniform"):
            a, want, _ = aed_operand(rng, n, dev, kind)
            if kind == "uniform" and n in sizes:
                uniform[n] = (a, want)
            del a
    return uniform


def c4_table() -> None:
    """``--c4``: C4's rows on the uniform-[1, 2] operands that
    ``--aed-table`` draws from ``default_rng(191)`` (the same draws, replayed
    in the table's order): at 4096, the eigenvalues-only error by plain B13
    and by AED (the numbers C4 records), then ``schur_backward`` by plain
    B13 and by AED, by plain B13 on the same matrix in complex128, and by
    plain B13 in chunks of 500 sweeps (the growth of the backward error
    within one solve); at 1024 and 2048, ``schur_backward`` by plain B13."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    card_name, card_limit = card_line().split(", ")
    dev = torch.device("cuda")
    uniform = aed_table_uniform(dev)
    warm = uniform[AED_SIZES[0]][0][:512, :512].contiguous()
    for driver in ("aed", "monolithic"):  # builds and warms both routes
        aed_solve(warm, driver, False)
    a, want = uniform[FULL_N]
    for driver in ("monolithic", "aed"):
        lam, sweeps, conv, _, seconds, rounds, _ = aed_solve(a, driver, False)
        print(f"c4 eigenvalues uniform n={FULL_N} {driver}: {sweeps} sweeps, {rounds} rounds, "
              f"{seconds:.3f} s, converged={conv}, eigenvalue error "
              f"{eig_error(lam, want):.3e} (phase 14's limit 1e-4) [{card_name}, {card_limit}]")
    rows = [("uniform", a, want, "monolithic", None), ("uniform", a, want, "aed", None),
            ("uniform", a.to(torch.float64), want, "monolithic", None),
            ("uniform", a, want, "monolithic", 500)]
    rows += [("uniform", uniform[n][0], uniform[n][1], "monolithic", None)
             for n in AED_SIZES if n != FULL_N]
    c4_rows(rows, card_name, card_limit)


def shifted_phase(eigsol, ctx):
    """Phase 20: the shifted solves on the card. The demo's sigma = 3.1 and
    2.3 on data/A.txt and data/B.txt (complex128) against numpy's eigenvalue
    nearest the shift; dense-LU inverse power at 2048 float32 on the bench
    operand; BiCGStab inverse power on the 1M-row 33-diagonal planted band
    (row-major B2 and interleaved B1) with the shift 1% above its dominant
    eigenvalue, against scipy; and bench.py's n = 4096 ``SplitComplexDIA``
    interior-shift GMRES case (B3's planes entry) against scipy's
    shift-invert ``eigs``, with iterations, seconds, error and residual.
    Every check raises; each case's SpMV kernel must have launched."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops.split_complex import from_planes
    dev, card = ctx["dev"], f"[{ctx['card_name']}, {ctx['card_limit']}]"

    def timed(M, opts, x0=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eigsol.shifted_inverse_power_method(M, opts, x0=x0)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # (a) the demo's shifted section
    for name, shift in (("A", 3.1), ("B", 2.3)):
        M = eigsol.read_matrix_from_file(f"data/{name}.txt", torch.complex128, device=dev)
        r, seconds = timed(M, eigsol.ShiftedSolverOptions(shift=shift, tolerance=1e-12))
        ev = np.linalg.eigvals(M.to_dense().cpu().numpy())
        want = complex(ev[np.argmin(np.abs(ev - shift))])
        err = abs(complex(r.eigenvalue) - want) / abs(want)
        print(f"phase 20 demo data/{name}.txt sigma={shift}: lambda {complex(r.eigenvalue):.10g} "
              f"vs numpy {want:.10g} (rel {err:.2e}, limit 1e-8), {int(r.iterations)} "
              f"iterations, converged={bool(r.converged)}, {seconds:.3f} s")
        check(bool(r.converged) and err <= 1e-8, f"demo data/{name}.txt: wrong eigenvalue")
    # (b) dense LU inverse power at 2048 float32 (factorised once)
    rng = np.random.default_rng(200)
    a, d = device_operand(rng, LARGE_N, torch.float32, dev, "geometric")
    shift = 0.52  # nearest 0.9^6 = 0.531; the next, 0.9^7, is 3.7x as far
    r, seconds = timed(eigsol.DenseMatrix(a), eigsol.ShiftedSolverOptions(
        shift=shift, tolerance=1e-6, max_iterations=200))
    want = d[np.argmin(np.abs(d - shift))]
    err = abs(complex(r.eigenvalue) - want)
    print(f"phase 20 dense LU f32 n={LARGE_N} sigma={shift}: lambda {complex(r.eigenvalue):.7g} "
          f"vs planted {want:.7g} (err {err:.2e}, limit 1e-4), {int(r.iterations)} iterations, "
          f"{seconds:.3f} s {card}")
    check(bool(r.converged) and err <= 1e-4, "dense LU inverse power: wrong eigenvalue")
    # (c) BiCGStab inverse power on the planted 1M x 33 band
    offs, planted = ctx["offs"], ctx["planted"]
    lam1 = ctx["oracle_f32"]
    p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev), offsets=offs, shape=(N, N))
    opts = eigsol.ShiftedSolverOptions(shift=1.01 * lam1.real, tolerance=1e-6, max_iterations=50,
                                       inner_method="bicgstab", inner_tolerance=1e-6,
                                       inner_max_iterations=200)
    x0 = np.random.default_rng(201).uniform(-1, 1, N)
    for label, M, kernel in (("DIA (B2)", p32, ds.dia_kernel),
                             ("interleaved (B1)", p32.interleaved(), ds.dia_il_kernel)):
        ds.reset_launch_counts()
        r, seconds = timed(M, opts, x0)
        err = abs(complex(r.eigenvalue) - lam1) / abs(lam1)
        print(f"phase 20 BiCGStab f32 {label} {N}x33 sigma={opts.shift:.6g}: lambda "
              f"{complex(r.eigenvalue):.7g} vs scipy {lam1:.7g} (rel {err:.2e}, limit 1e-4), "
              f"{int(r.iterations)} iterations, {seconds:.3f} s, {kernel.__name__} launches "
              f"{kernel.launches} {card}")
        check(kernel.launches > 0, f"{kernel.__name__} was not launched by BiCGStab")
        check(bool(r.converged) and err <= 1e-4, f"BiCGStab {label}: wrong eigenvalue")
        check(r.eigenvector.shape == (N,) and bool(torch.isfinite(r.eigenvector).all()),
              f"BiCGStab {label}: bad eigenvector")
    # (d) bench.py:579-670's interior-shift GMRES case at n = 4096
    n = 4096
    rng = np.random.default_rng(0)
    goffs = (-3, -1, 0, 2)
    planes = np.zeros((2, len(goffs), n), np.float32)
    for k, off in enumerate(goffs):
        amp = 1.0 if off == 0 else 0.3
        planes[0, k] = amp * rng.standard_normal(n)
        planes[1, k] = amp * rng.standard_normal(n)
        if off > 0:
            planes[:, k, n - off:] = 0
        elif off < 0:
            planes[:, k, :-off] = 0
    planes[0, goffs.index(0)] += 4.0 + rng.uniform(-2, 2, n).astype(np.float32)
    sc = eigsol.SplitComplexDIA(planes=torch.from_numpy(planes).to(dev), offsets=goffs,
                                shape=(n, n))
    rows, cols, vals = [], [], []
    for k, off in enumerate(goffs):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append((planes[0, k] + 1j * planes[1, k])[i])
    A_sp = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n)).tocsc()
    t0 = time.perf_counter()
    target = complex(spla.eigs(A_sp, k=1, sigma=4.0 + 0.3j, tol=1e-10)[0][0])
    host_s = time.perf_counter() - t0
    shift = complex(target + 0.01 * (1 + 1j))
    target = complex(spla.eigs(A_sp, k=1, sigma=shift, tol=1e-10)[0][0])
    opts = eigsol.ShiftedSolverOptions(shift=shift, max_iterations=60, tolerance=1e-5,
                                       inner_method="gmres", inner_tolerance=1e-6)
    ds.reset_launch_counts()
    r, seconds = timed(sc, opts)
    lam = complex(from_planes(r.eigenvalue))
    err = abs(lam - target) / (1 + abs(target))
    xc = from_planes(r.eigenvector).astype(np.complex128)
    resid = float(np.abs(A_sp @ xc - lam * xc).max() / max(np.abs(xc).max(), 1e-30)
                  / (1 + abs(lam)))
    print(f"phase 20 GMRES SplitComplexDIA n={n} sigma={shift:.6g}: lambda {lam:.6f} vs scipy "
          f"shift-invert {target:.6f} (err {err:.2e}, limit 1e-4; the JAX package's TPU record "
          f"5.0e-06), residual {resid:.2e} (limit 1e-3), {int(r.iterations)} iterations, "
          f"converged={bool(r.converged)}, {seconds:.3f} s (scipy shift-invert {host_s:.3f} s), "
          f"dia_planes_kernel launches {ds.dia_planes_kernel.launches} {card}")
    check(ds.dia_planes_kernel.launches > 0, "dia_planes_kernel was not launched by GMRES")
    check(bool(r.converged) and err <= 1e-4 and resid <= 1e-3, "GMRES case: wrong eigenpair")


def band_scipy(data: np.ndarray, offsets):
    """The row-indexed DIA band as a scipy CSR matrix in float64."""
    import scipy.sparse as sp
    n = data.shape[1]
    diags = [data[d, :n - off] if off >= 0 else data[d, -off:]
             for d, off in enumerate(offsets)]
    return sp.diags([np.asarray(v, np.float64) for v in diags], list(offsets), shape=(n, n),
                    format="csr")


def host_power_f64(A, x0, max_iterations, tol):
    """The power loop of ``power_method_ds64`` on the host in float64 (scipy
    CSR): no test on the first iterate, then ``|l_k - l_{k-1}| <= tol (1 +
    |l_k|)`` with ``tol`` at float32; (eigenvalue, eigenvector, iterations,
    converged)."""
    x, z, lam, init, conv, used = x0, A @ x0, 0.0, False, False, 0
    tol = float(np.float32(tol))
    for k in range(max_iterations):
        nz = np.sqrt(z @ z)
        used = k + 1
        if nz == 0:
            break
        xn = z / nz
        zn = A @ xn
        ln = xn @ zn
        done = init and abs(ln - lam) <= tol * (1 + abs(ln))
        x, z, lam, init = xn, zn, ln, True
        if done:
            conv = True
            break
    return lam, x, used, conv


def krylov_phase(eigsol, ctx):
    """Phase 21: the Krylov and block eigensolvers, ``power_method_ds64``,
    the writer and the demo through the public API on the card, at the
    operand sizes of the earlier phases (1M rows x 33 diagonals):
    (a) ``arnoldi_eigenvalues(k=3, m=30)`` on the planted band of phases 4-5
    as ``SparseDIA`` (B2) and ``InterleavedDIA`` (B1), the projection on B8;
    ``krylov_schur_eigenvalues(k=3)`` on it and as ``SparseGELL`` (B6);
    against scipy's ``eigs`` (phase 16's reference); (b)
    ``lanczos_eigenvalues`` (LM and LA), ``lanczos_eigenpairs`` (residuals
    against their Ritz bounds) and ``lanczos_thick_restart`` (LA), k = 4,
    on phase 16's symmetric band, against scipy's ``eigsh``; (c)
    ``lobpcg_eigenvalues(k=4, "LA")`` on it in float64, row-major and
    interleaved (B5);
    (d) ``power_method_ds64`` on bench.py's ds64 operator at 100,000 and 1M
    rows against a host float64 loop from the same ``x0``; (e)
    ``write_matrix_to_file`` of a 100,000-row sparse complex128 matrix and a
    512 dense one, read back; (f) the demo's reference flow on the card, then
    its solvers on a 2000-row file the writer produced. Each solve prints its
    seconds, the launches of the kernels its path names (each must be more
    than 0) and its error beside its limit; any limit missed raises."""
    import contextlib
    import io
    import os
    import re
    import shutil
    import tempfile

    import torch

    from pcsc_eigenvalue_solver_project_tpu_torch import demo
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.lanczos import lanczos_decomposition
    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

    dev, offs = ctx["dev"], ctx["offs"]
    card = f"[{ctx['card_name']}, {ctx['card_limit']}]"
    planted = ctx["planted"]
    oracles = ctx.get("oracles16")
    if oracles is None:  # run alone (--krylov)
        oracles = {"subspace": scipy_top(planted, offs, 3),
                   "chebyshev": scipy_top(symmetric_band(N, (8.0, 7.0, 6.5, 6.0), seed=5),
                                          offs, 4, which="LA", symmetric=True)}
    want3 = np.asarray(oracles["subspace"])
    want3 = want3[np.argsort(-np.abs(want3))]
    want4 = np.sort(np.asarray(oracles["chebyshev"]).real)[::-1]
    print(f"phase 21 wanted eigenvalues: planted band {np.round(want3, 6)} (gaps "
          f"{np.abs(np.diff(want3)).round(4)} against the 1e-4 relative limit), symmetric "
          f"band {want4.round(6)} (gaps {np.abs(np.diff(want4)).round(4)}) {card}")
    kernels = {"B1": ds.dia_il_kernel, "B2": ds.dia_kernel, "B5": ds.dia_block_kernel,
               "B5 interleaved": ds.dia_il_block_kernel, "B6": gs.gell_kernel,
               "B8": qk.qr_eig_kernel}
    launch_log = {}

    def run(label, fn, names):
        """One solve between zeroed counts, after an untimed warm-up solve
        (the first launches of a kernel, the library handles): (result,
        seconds, launches)."""
        fn()
        ds.reset_launch_counts()
        gs.reset_launch_counts()
        qk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: kernels[name].launches for name in names}
        for name, count in launches.items():
            check(count > 0, f"phase 21 {label}: {name} was not launched")
        launch_log[label] = launches
        return out, seconds, launches

    def rel_set_err(got, want):
        return nearest_err(np.asarray(got), np.asarray(want)) / np.abs(want).max()

    x0 = np.random.default_rng(21).uniform(-1, 1, N)
    p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev), offsets=offs, shape=(N, N))
    rows = np.arange(N)[:, None] + np.asarray(offs)[None, :]
    keep = (rows >= 0) & (rows < N)
    t0 = time.perf_counter()
    gell = eigsol.SparseGELL.from_coo(np.broadcast_to(np.arange(N)[:, None], rows.shape)[keep],
                                      rows[keep], planted.T[keep], (N, N), device=dev)
    print(f"phase 21 SparseGELL.from_coo of the planted band: {time.perf_counter() - t0:.1f} s")
    sym = symmetric_band(N, (8.0, 7.0, 6.5, 6.0), seed=5)
    s32 = eigsol.SparseDIA(data=torch.from_numpy(sym).to(dev), offsets=offs, shape=(N, N))

    # (a) Arnoldi and Krylov-Schur on the planted band
    ks_opts = eigsol.SolverOptions(tolerance=1e-6)
    solves = [("arnoldi DIA f32", lambda: eigsol.arnoldi_eigenvalues(p32, k=3, m=30, x0=x0),
               ("B2", "B8")),
              ("arnoldi IL f32", lambda: eigsol.arnoldi_eigenvalues(p32.interleaved(), k=3,
                                                                     m=30, x0=x0), ("B1", "B8")),
              ("krylov-schur DIA f32", lambda: eigsol.krylov_schur_eigenvalues(
                  p32, k=3, opts=ks_opts, x0=x0), ("B2",)),
              ("krylov-schur GELL f32", lambda: eigsol.krylov_schur_eigenvalues(
                  gell, k=3, opts=ks_opts, x0=x0), ("B6",))]
    for label, fn, names in solves:
        r, seconds, launches = run(label, fn, names)
        err = rel_set_err(r.eigenvalues.cpu().numpy(), want3)
        print(f"phase 21 {label} {N}x33 k=3: {seconds:.3f} s, launches {launches}, "
              f"{int(r.iterations)} {'QR sweeps' if 'arnoldi' in label else 'matvecs'}, "
              f"converged={bool(r.converged)}, Ritz values {np.round(r.eigenvalues.cpu().numpy(), 6)}"
              f" vs scipy eigs: rel err {err:.2e} (limit 1e-4) {card}")
        check(err <= 1e-4, f"phase 21 {label}: Ritz values off scipy by {err:.2e}")
        check(bool(r.converged), f"phase 21 {label}: did not converge")
    del gell
    # (b) Lanczos on the symmetric band
    lz_opts = eigsol.SolverOptions(tolerance=1e-5)
    for which in ("LM", "LA"):
        label = f"lanczos {which} DIA f32"
        r, seconds, launches = run(label, lambda: eigsol.lanczos_eigenvalues(
            s32, k=4, which=which, opts=lz_opts, x0=x0), ("B2",))
        err = rel_set_err(r.eigenvalues.cpu().numpy(), want4)
        print(f"phase 21 {label} {N}x33 k=4: {seconds:.3f} s, launches {launches}, "
              f"{int(r.iterations)} steps, converged={bool(r.converged)}, rel err {err:.2e} "
              f"(limit 1e-4) {card}")
        check(err <= 1e-4, f"phase 21 {label}: Ritz values off scipy by {err:.2e}")
    label = "lanczos eigenpairs LA DIA f32"
    (r, Y), seconds, launches = run(label, lambda: eigsol.lanczos_eigenpairs(
        s32, k=4, which="LA", opts=lz_opts, x0=x0), ("B2",))
    norm1 = float(np.abs(sym).sum(axis=0).max())  # ||A||_1 of the symmetric band
    steps = int(r.iterations)
    # the Ritz bounds |beta_m s_{m,i}| of the same (deterministic) basis
    _, alpha, beta, _ = lanczos_decomposition(s32.matvec, torch.from_numpy(x0).to(
        dev, torch.float32), steps)
    T_m = np.diag(alpha.cpu().numpy().astype(np.float64))
    b = beta.cpu().numpy().astype(np.float64)
    T_m += np.diag(b[:steps - 1], 1) + np.diag(b[:steps - 1], -1)
    theta, S = np.linalg.eigh(T_m)
    for i in range(4):
        th = float(r.eigenvalues[i])
        bound = abs(b[steps - 1] * S[-1, np.argmin(np.abs(theta - th))])
        y = Y[:, i].contiguous()
        res_i = float(torch.linalg.vector_norm(s32.matvec(y) - th * y))
        print(f"phase 21 {label}: theta {th:.6f}, residual {res_i:.3e} (limit Ritz bound "
              f"{bound:.3e} + 1e-5 ||A||_1 = {bound + 1e-5 * norm1:.3e})")
        check(res_i <= bound + 1e-5 * norm1, f"phase 21 {label}: residual {res_i:.3e} above "
              f"its limit")
    print(f"phase 21 {label} {N}x33 k=4: {seconds:.3f} s, launches {launches} {card}")
    label = "lanczos thick restart LA DIA f32"
    r, seconds, launches = run(label, lambda: eigsol.lanczos_thick_restart(
        s32, k=4, opts=lz_opts, x0=x0), ("B2",))
    err = rel_set_err(r.eigenvalues.cpu().numpy(), want4)
    print(f"phase 21 {label} {N}x33 k=4: {seconds:.3f} s, launches {launches}, "
          f"{int(r.iterations)} matvecs, converged={bool(r.converged)}, rel err {err:.2e} "
          f"(limit 1e-4) {card}")
    check(bool(r.converged) and err <= 1e-4, f"phase 21 {label}: not converged or off scipy")
    # (c) LOBPCG on the symmetric band, B5 row-major and interleaved, in
    # float64: the upstream routine stops when every residual is below
    # eps 10 n (theta + |A u|), which at n = 1M in float32 (~19 here) holds
    # at the first iteration; in float64 it is ~4e-8
    X0 = np.random.default_rng(22).standard_normal((N, 4))
    lob_opts = eigsol.SolverOptions(max_iterations=100, tolerance=1e-6)
    s64 = eigsol.SparseDIA(data=s32.data.double(), offsets=offs, shape=(N, N))
    for label, M, name in (("lobpcg LA DIA f64", s64, "B5"),
                           ("lobpcg LA IL f64", s64.interleaved(), "B5 interleaved")):
        r, seconds, launches = run(label, lambda: eigsol.lobpcg_eigenvalues(
            M, k=4, which="LA", opts=lob_opts, X0=X0), (name,))
        err = rel_set_err(r.eigenvalues.cpu().numpy(), want4)
        print(f"phase 21 {label} {N}x33 k=4: {seconds:.3f} s, launches {launches}, "
              f"{int(r.iterations)} iterations, converged={bool(r.converged)}, rel err "
              f"{err:.2e} (limit 1e-4) {card}")
        check(err <= 1e-4, f"phase 21 {label}: values off scipy by {err:.2e}")
    del s32, s64
    # (d) power_method_ds64 on bench.py's ds64 operator, against a host float64 loop
    for n, budget in ((100_000, 200), (N, 100)):
        dia = banded_full(n, bandwidth=BANDWIDTH, dtype=np.float64, seed=0, device=dev)
        xs = np.full(n, n ** -0.5)
        opts = eigsol.SolverOptions(max_iterations=budget)
        label = f"power_method_ds64 n={n}"
        r, seconds, launches = run(label, lambda: eigsol.power_method_ds64(dia, opts, x0=xs),
                                   ("B2",))
        t0 = time.perf_counter()
        lam, x, used, conv = host_power_f64(band_scipy(dia.data.cpu().numpy(), dia.offsets),
                                            xs, budget, opts.tolerance)
        host_s = time.perf_counter() - t0
        err = abs(r.eigenvalue - lam) / abs(lam)
        verr = float(np.abs(r.eigenvector - x).max())
        print(f"phase 21 {label}: {seconds:.3f} s ({seconds / int(r.iterations) * 1e6:.1f} us "
              f"an iteration; host float64 loop {host_s:.2f} s), launches {launches}, lambda "
              f"{r.eigenvalue:.15g} vs host {lam:.15g} (rel {err:.2e}, limit 1e-12), eigenvector "
              f"max diff {verr:.1e}, iterations {int(r.iterations)} vs {used}, converged "
              f"{bool(r.converged)} vs {conv} {card}")
        check(err <= 1e-12 and int(r.iterations) == used and bool(r.converged) == conv,
              f"phase 21 {label}: off the host float64 loop")
        del dia
    # (e) the writer: a 100k-row sparse complex128 matrix and a 512 dense one
    tmp = tempfile.mkdtemp(prefix="eigsol-smoke-")
    try:
        rng = np.random.default_rng(23)
        n = 100_000
        r_ = np.concatenate([np.arange(max(0, -o), min(n, n - o)) for o in (-2, -1, 0, 1, 2)])
        c_ = np.concatenate([np.arange(max(0, -o), min(n, n - o)) + o for o in (-2, -1, 0, 1, 2)])
        v_ = rng.standard_normal(len(r_)) + 1j * rng.standard_normal(len(r_))
        sparse = eigsol.SparseCSR.from_coo(r_, c_, v_, (n, n), dtype=np.complex128, device=dev)
        dense = eigsol.DenseMatrix.from_array(rng.standard_normal((512, 512)), device=dev)
        for label, m, dt in (("sparse c128 100k", sparse, np.complex128),
                             ("dense f64 512", dense, np.float64)):
            path = os.path.join(tmp, "m.txt")
            t0 = time.perf_counter()
            eigsol.write_matrix_to_file(path, m)
            t1 = time.perf_counter()
            back = eigsol.read_matrix_from_file(path, dt, device=dev)
            t2 = time.perf_counter()
            if m.is_dense:
                exact = torch.equal(back.as_dense(), m.as_dense())
            else:
                exact = all(torch.equal(getattr(back, f), getattr(m, f))
                            for f in ("data", "indices", "rows", "indptr"))
            print(f"phase 21 write_matrix_to_file {label}: write {t1 - t0:.2f} s, read back "
                  f"{t2 - t1:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB, exact {exact}")
            check(exact, f"phase 21 writer {label}: not read back exactly")
        # (f) the demo on the card: the reference flow, then the solvers on a file
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = demo.main(["--data-dir", "data"])
        text = out.getvalue()
        print(f"phase 21 demo reference flow on the card: exit {rc}, "
              f"{time.perf_counter() - t0:.2f} s; "
              f"{[ln.strip() for ln in text.splitlines() if 'qr_eigenvalues(A)' in ln]}")
        check(rc == 0 and "[(1+3i), (2+4i), (5-1i)]" in text and "raised as expected" in text,
              "phase 21: the demo's reference flow")
        small = symmetric_band(2000, (8.0, 7.0, 6.5, 6.0), seed=5)
        path = os.path.join(tmp, "band2000.txt")
        a = band_scipy(small, offs)
        coo = a.tocoo()
        eigsol.write_matrix_to_file(path, eigsol.SparseCSR.from_coo(
            coo.row, coo.col, coo.data, a.shape, dtype=np.float64, device=dev))
        want = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:4]
        for solver in ("arnoldi", "lanczos", "trlanczos", "lobpcg", "subspace"):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = demo.main([path, "--solver", solver, "--k", "4"])
            got = [complex(v.replace("i", "j").strip("()"))
                   for v in re.findall(r"ritz\[\d+\] = (\S+)", out.getvalue())]
            err = (float(np.abs(np.sort(np.real(got))[::-1] - want).max())
                   if len(got) == 4 else float("inf"))
            print(f"phase 21 demo --solver {solver} --k 4 (2000 rows, the writer's file): exit "
                  f"{rc}, {time.perf_counter() - t0:.2f} s, max error {err:.2e} against numpy "
                  f"(limit 1e-4)")
            check(rc == 0 and err <= 1e-4, f"phase 21 demo --solver {solver}: wrong values")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launch_log


def krylov_alone() -> None:
    """``--krylov``: phase 21 alone, with its own scipy references."""
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card_name, card_limit = card_line().split(", ")
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    ctx = {"dev": torch.device("cuda"), "offs": tuple(range(-BANDWIDTH, BANDWIDTH + 1)),
           "planted": planted_band(N, np.float32, seed=2), "card_name": card_name,
           "card_limit": card_limit}
    t0 = time.perf_counter()
    krylov_phase(eigsol, ctx)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s (with its scipy references)")


def csr_of_sorted_coo(eigsol, r, c, v, n, plant=()):
    """The port's CPU ``SparseCSR`` of a COO sorted by (row, column) without
    duplicates (``general_coo``'s), with ``plant`` (i, value) pairs added to
    its diagonal, built without a sort of the 33M entries."""
    import torch
    r, c, v = np.asarray(r, np.int64), np.asarray(c, np.int64), np.asarray(v)
    key = r * n + c
    for i, value in plant:
        pos = int(np.searchsorted(key, i * n + i))
        if pos < len(key) and key[pos] == i * n + i:
            v = v.copy()
            v[pos] += value
        else:
            key, r, c = np.insert(key, pos, i * n + i), np.insert(r, pos, i), np.insert(c, pos, i)
            v = np.insert(v, pos, value)
    indptr = np.searchsorted(r, np.arange(n + 1))
    return eigsol.SparseCSR(data=torch.from_numpy(v.astype(np.float32)),
                            indices=torch.from_numpy(c.astype(np.int32)),
                            rows=torch.from_numpy(r.astype(np.int32)),
                            indptr=torch.from_numpy(indptr.astype(np.int32)), shape=(n, n))


def band_ell(eigsol, data, offsets):
    """The row-indexed DIA band (k, n) as the port's CPU ``SparseELL``: row i
    holds its k entries, the ones outside the matrix zero at column 0."""
    import torch
    k, n = data.shape
    cols = np.arange(n)[:, None] + np.asarray(offsets)[None, :]
    inside = (cols >= 0) & (cols < n)
    return eigsol.SparseELL(data=torch.from_numpy(np.ascontiguousarray(data.T)),
                            indices=torch.from_numpy(np.where(inside, cols, 0).astype(np.int32)),
                            shape=(n, n))


def distributed_phase(eigsol, ctx):
    """Phase 22: the distributed layer (``parallel/``, ``utils/checkpoint.py``)
    on the card, on an NCCL process group of world size 1 (one H100 hosts one
    NCCL rank; more ranks are proven on gloo CPU ranks by the tests), at
    1M rows. Every result is held against the port's single-device solver
    on the same operator and ``x0`` (power paths: a budget of 200
    iterations at tolerance 0, eigenvalues within 1e-5 of max(|lambda|,
    ||A x||)), or against scipy's eigenvalues to 1e-4 (Krylov, block and
    shifted solves); the checkpointed runs, stopped after their first chunk
    and resumed, must equal the uninterrupted runs bit for bit. The launch
    counts are zeroed before the phase's solves and read after: B1, B2, B5,
    B6 and B8 must have run. Returns the launches by kernel name."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from pcsc_eigenvalue_solver_project_tpu_torch.io.distributed import load_partitioned
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    from pcsc_eigenvalue_solver_project_tpu_torch.ops.split_complex import from_planes
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell as pg
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell_pruned as pp
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import mesh as pm
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import split_complex as psc
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues, distributed_krylov_schur_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.inverse_power import (
        _partitioned_diagonal, distributed_shifted_inverse_power)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.krylov import (
        solve_shifted_distributed)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.lanczos import (
        distributed_lanczos_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.power import (
        distributed_power_method, reductions)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import partition_ell
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.subspace import (
        distributed_subspace_iteration)
    from pcsc_eigenvalue_solver_project_tpu_torch.utils.checkpoint import (
        distributed_dia_il_power_checkpointed, power_method_checkpointed)
    from scipy.sparse.linalg import eigs

    dev, offs = ctx["dev"], ctx["offs"]
    card = f"[{ctx['card_name']}, {ctx['card_limit']}]"
    folder = tempfile.mkdtemp(prefix="phase22-")
    t_setup = time.perf_counter()
    pm.initialize_distributed(device=dev, init_method=f"file://{folder}/store", world_size=1,
                              rank=0)
    try:
        backend = dist.get_backend()
        print(f"phase 22 process group: backend {backend}, world size {dist.get_world_size()} "
              f"{card}")
        check(backend == "nccl", f"phase 22: backend {backend}, not nccl")
        mesh = pm.make_row_mesh(1)
        check(mesh.device.type == "cuda", "phase 22: the rank is not on the card")
        budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
        x0 = np.random.default_rng(22).uniform(-1, 1, N)
        op32, op64c, planted = ctx["op32"], ctx["op64c"], ctx["planted"]
        p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev), offsets=offs,
                               shape=(N, N))
        sym = symmetric_band(N, (8.0, 7.0, 6.5, 6.0), seed=5)
        s32 = eigsol.SparseDIA(data=torch.from_numpy(sym).to(dev), offsets=offs, shape=(N, N))
        r, c, v = ctx["uniform_coo"]
        # the general operator, and phase 18's planted variant (the bulk scaled
        # by 1 / sqrt(33), 14, 10, 8 added on the head of the diagonal)
        general = csr_of_sorted_coo(eigsol, r, c, v, N)
        plant = ((0, 14.0), (1, 10.0), (2, 8.0))
        planted_general = csr_of_sorted_coo(eigsol, r, c, v / np.sqrt(GELL_PER_ROW), N, plant)
        t0 = time.perf_counter()
        gell_ref = eigsol.SparseGELL.from_coo(r, c, v, (N, N), device=dev)
        split = eigsol.SplitComplexDIA.from_complex_dia(op64c)
        print(f"phase 22 CSR forms and the single-device SparseGELL: "
              f"{time.perf_counter() - t_setup:.1f} s host (the GELL pack "
              f"{time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        oracle_general = eigs(coo_csr64(planted_general.rows.numpy(),
                                        planted_general.indices.numpy(),
                                        planted_general.data.numpy(), N, N),
                              k=3, which="LM", v0=np.ones(N), ncv=20,
                              return_eigenvectors=False)
        print(f"phase 22 scipy eigs (k = 3) of the planted general operator: "
              f"{time.perf_counter() - t0:.1f} s")
        oracles = ctx.get("oracles16") or {
            "subspace": scipy_top(planted, offs, 3),
            "chebyshev": scipy_top(sym, offs, 4, which="LA", symmetric=True)}
        lam1 = ctx.get("oracle_f32") or scipy_dominant(planted, offs)
        partitioners = {
            "il": lambda: pd.partition_dia_il(op32, mesh),
            "dia": lambda: pd.partition_dia(op32, mesh),
            "ell": lambda: partition_ell(band_ell(eigsol, op32.data.cpu().numpy(), offs), mesh),
            "splitc": lambda: psc.partition_splitc_dia(split, mesh),
            "gell": lambda: pg.partition_gell(general, mesh),
            "pruned": lambda: pp.partition_gell_pruned(general, mesh),
            "pruned planted": lambda: pp.partition_gell_pruned(planted_general, mesh),
            "ell planted": lambda: partition_ell(planted_general, mesh),
            "il sym": lambda: pd.partition_dia_il(s32, mesh),
            "il planted": lambda: pd.partition_dia_il(p32, mesh),
            "ell band": lambda: partition_ell(band_ell(eigsol, planted, offs), mesh),
        }
        parts, host_s = {}, {}
        for name, build in partitioners.items():
            t0 = time.perf_counter()
            parts[name] = build()
            host_s[name] = round(time.perf_counter() - t0, 2)
        print(f"phase 22 partitions, host s each: {host_s}")
        torch.cuda.synchronize()
        print(f"phase 22 set-up (partitions, references, scipy eigs of the planted general "
              f"operator): {time.perf_counter() - t_setup:.1f} s")
        del general, planted_general

        kernels = {"B1": ds.dia_il_kernel, "B2": ds.dia_kernel, "B5": ds.dia_il_block_kernel,
                   "B6": gs.gell_kernel, "B8": qk.qr_eig_kernel}
        x0p = np.random.default_rng(23).uniform(-1, 1, (2, N))
        legs = {  # label -> (distributed solve, single-device reference)
            "dia_il_power_method": (
                lambda: pd.distributed_dia_il_power_method(parts["il"], mesh, budget, x0=x0),
                lambda: eigsol.power_method(op32.interleaved(), budget, x0=x0)),
            "dia_power_method": (
                lambda: pd.distributed_dia_power_method(parts["dia"], mesh, budget, x0=x0),
                lambda: eigsol.power_method(op32, budget, x0=x0)),
            "power_method ELL": (
                lambda: distributed_power_method(parts["ell"], mesh, budget, x0=x0),
                lambda: eigsol.power_method(op32, budget, x0=x0)),
            "splitc_power_method": (
                lambda: psc.distributed_splitc_power_method(parts["splitc"], mesh, budget,
                                                            x0=x0p),
                lambda: eigsol.power_method(split, budget, x0=x0p)),
            "gell_power_method": (
                lambda: pg.distributed_gell_power_method(parts["gell"], mesh, budget, x0=x0),
                lambda: eigsol.power_method(gell_ref, budget, x0=x0)),
            "gell_power_pruned": (
                lambda: pp.distributed_gell_power_pruned(parts["pruned"], mesh, budget, x0=x0),
                lambda: eigsol.power_method(gell_ref, budget, x0=x0)),
        }
        for fn, ref in legs.values():  # warm-up: allocator, library handles, NCCL
            fn()
            ref()
        torch.cuda.synchronize()

        ds.reset_launch_counts()
        gs.reset_launch_counts()
        qk.reset_launch_counts()
        t_path = time.perf_counter()
        results, seconds, refs = {}, {}, {}
        for label, (fn, ref) in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[label] = fn()
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
        units = {"lanczos": "steps", "subspace": "sweeps", "arnoldi": "QR sweeps",
                 "krylov_schur": "matvecs"}
        krylov = {
            "lanczos LA k=3 (interleaved)": (
                lambda: distributed_lanczos_eigenvalues(
                    parts["il sym"], mesh, k=3, m=40, which="LA", x0=x0,
                    opts=eigsol.SolverOptions(tolerance=1e-5)),
                np.sort(np.asarray(oracles["chebyshev"]).real)[::-1][:3]),
            "subspace k=2 (interleaved, B5)": (
                lambda: distributed_subspace_iteration(
                    parts["il planted"], mesh, k=2,
                    opts=eigsol.SolverOptions(max_iterations=300, tolerance=1e-6)),
                np.asarray(oracles["subspace"])[np.argsort(-np.abs(oracles["subspace"]))][:2]),
            "arnoldi k=3 m=30 (pruned GELL, B6 + B8)": (
                lambda: distributed_arnoldi_eigenvalues(parts["pruned planted"], mesh, k=3,
                                                        m=30, x0=x0),
                oracle_general),
            "krylov_schur k=3 (ELL)": (
                lambda: distributed_krylov_schur_eigenvalues(
                    parts["ell planted"], mesh, k=3, x0=x0,
                    opts=eigsol.SolverOptions(tolerance=1e-6)),
                oracle_general),
        }
        for label, (fn, _) in krylov.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[label] = fn()
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
        # shifted: BiCGStab inverse power (phase 20's options) and a solve
        shifted_opts = eigsol.ShiftedSolverOptions(
            shift=1.01 * lam1.real, tolerance=1e-6, max_iterations=50, inner_method="bicgstab",
            inner_tolerance=1e-6, inner_max_iterations=200)
        A = parts["ell band"]
        t0 = time.perf_counter()
        inv = distributed_shifted_inverse_power(A, mesh, shifted_opts, x0=x0)
        torch.cuda.synchronize()
        seconds["shifted_inverse_power"] = time.perf_counter() - t0
        vdot, norm = reductions(mesh)
        matvec = A.local_matvec(mesh)
        b = A.local_block(np.random.default_rng(24).uniform(-1, 1, N), mesh).to(torch.float32)
        sigma = 2.0 * lam1.real
        t0 = time.perf_counter()
        y = solve_shifted_distributed(matvec, sigma, b, vdot=vdot, norm=norm,
                                      diag=_partitioned_diagonal(A, mesh), tol=1e-6,
                                      maxiter=400)
        residual = float(norm(matvec(y) - sigma * y - b) / norm(b))
        seconds["solve_shifted_distributed"] = time.perf_counter() - t0
        # checkpointed: uninterrupted, and stopped after the first chunk then resumed
        ckpt = {}
        stop = eigsol.SolverOptions(max_iterations=100, tolerance=0.0)
        t0 = time.perf_counter()
        ckpt["distributed whole"] = distributed_dia_il_power_checkpointed(
            parts["il"], mesh, budget, checkpoint_dir=f"{folder}/a", chunk=100, x0=x0)
        distributed_dia_il_power_checkpointed(parts["il"], mesh, stop,
                                              checkpoint_dir=f"{folder}/b", chunk=100, x0=x0)
        ckpt["distributed resumed"] = distributed_dia_il_power_checkpointed(
            parts["il"], mesh, budget, checkpoint_dir=f"{folder}/b", chunk=100, x0=x0)
        ckpt["single whole"] = power_method_checkpointed(op32, budget,
                                                         checkpoint_dir=f"{folder}/c",
                                                         chunk=100, x0=x0)
        power_method_checkpointed(op32, stop, checkpoint_dir=f"{folder}/d", chunk=100, x0=x0)
        ckpt["single resumed"] = power_method_checkpointed(op32, budget,
                                                           checkpoint_dir=f"{folder}/d",
                                                           chunk=100, x0=x0)
        torch.cuda.synchronize()
        seconds["checkpointed (4 runs, 2 resumed)"] = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        by_name = {k.__name__: k.launches for k in kernels.values()}
        # the host cost of one collective of the power loops at world size 1
        scalar = torch.ones((), device=dev)
        pm.all_reduce_sum(scalar, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            pm.all_reduce_sum(scalar, mesh)
        torch.cuda.synchronize()
        print(f"phase 22 NCCL all_reduce of a scalar at world size 1: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} us a call {card}")
        print(f"phase 22 launches: {launches} {card}")
        for name, count in launches.items():
            check(count > 0, f"phase 22: {name} was not launched by the distributed paths")
        print(f"phase-22 paths: {time.perf_counter() - t_path:.1f} s")

        # the power paths against the single-device solver (timed the same way)
        for label, (fn, ref) in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref()
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            r = results[label]
            if label.startswith("splitc"):
                lam = complex(from_planes(r.eigenvalue))
                lam_ref = complex(from_planes(want.eigenvalue))
            else:
                lam, lam_ref = complex(r.eigenvalue), complex(want.eigenvalue)
            vec = r.eigenvector
            scale = max(abs(lam_ref), float(torch.linalg.vector_norm(vec.float())))
            err = abs(lam - lam_ref) / scale
            print(f"phase 22 {label} {N}x33 budget: lambda {lam:.7g} vs single device "
                  f"{lam_ref:.7g} (err {err:.2e}, limit 1e-5), {int(r.iterations)} iterations "
                  f"(single device {int(want.iterations)}), {seconds[label]:.3f} s, "
                  f"{seconds[label] / int(r.iterations) * 1e6:.1f} us/iteration (single device "
                  f"{ref_s / int(want.iterations) * 1e6:.1f}) {card}")
            check(0 < int(r.iterations) <= budget.max_iterations, f"{label}: iterations")
            check(bool(torch.isfinite(vec).all()), f"phase 22 {label}: bad eigenvector")
            check(err <= 1e-5, f"phase 22 {label}: eigenvalue off by {err:.2e}")
        for label, (_, want) in krylov.items():
            r = results[label]
            got = r.eigenvalues.cpu().numpy()
            err = nearest_err(got, want) / np.abs(want).max()
            print(f"phase 22 {label}: {seconds[label]:.3f} s, {int(r.iterations)} "
                  f"{units[label.split()[0]]}, converged={bool(r.converged)}, values "
                  f"{np.round(got, 6)} vs scipy "
                  f"{np.round(np.asarray(want), 6)} (rel {err:.2e}, limit 1e-4) {card}")
            # Lanczos' flag is its Ritz bounds' at 1e-5, which a fixed basis of
            # 40 need not reach; its values are held to scipy all the same
            check(bool(r.converged) or label.startswith("lanczos"),
                  f"phase 22 {label}: did not converge")
            check(err <= 1e-4, f"phase 22 {label}: off scipy by {err:.2e}")
        err = abs(complex(inv.eigenvalue) - lam1) / abs(lam1)
        print(f"phase 22 shifted_inverse_power (ELL, BiCGStab) sigma={shifted_opts.shift:.6g}: "
              f"lambda {complex(inv.eigenvalue):.7g} vs scipy {lam1:.7g} (rel {err:.2e}, limit "
              f"1e-4), {int(inv.iterations)} iterations, "
              f"{seconds['shifted_inverse_power']:.3f} s {card}")
        check(bool(inv.converged) and err <= 1e-4, "phase 22 shifted inverse power: eigenvalue")
        print(f"phase 22 solve_shifted_distributed sigma={sigma:.6g}: ||(A - sigma I) y - b|| / "
              f"||b|| = {residual:.2e} (limit 1e-5), "
              f"{seconds['solve_shifted_distributed']:.3f} s {card}")
        check(residual <= 1e-5, f"phase 22 solve_shifted_distributed: residual {residual:.2e}")
        for kind in ("distributed", "single"):
            whole, resumed = ckpt[f"{kind} whole"], ckpt[f"{kind} resumed"]
            same = (torch.equal(whole.eigenvector, resumed.eigenvector)
                    and torch.equal(whole.eigenvalue, resumed.eigenvalue)
                    and int(whole.iterations) == int(resumed.iterations))
            print(f"phase 22 checkpointed {kind}: resumed after 100 of {int(whole.iterations)} "
                  f"iterations, bitwise equal to the uninterrupted run: {same}")
            check(same, f"phase 22 checkpointed {kind}: the resumed run differs")
        check(torch.equal(ckpt["distributed whole"].eigenvector,
                          results["dia_il_power_method"].eigenvector),
              "phase 22: the checkpointed distributed run differs from the plain one")
        print(f"phase 22 checkpointed: {seconds['checkpointed (4 runs, 2 resumed)']:.3f} s")
        # the row-block loader on the reference's sparse file
        B = load_partitioned("data/B.txt", mesh, torch.complex128)
        r = distributed_power_method(B, mesh, eigsol.SolverOptions(tolerance=1e-10))
        ev = np.linalg.eigvals(eigsol.read_matrix_from_file(
            "data/B.txt", torch.complex128, device="cpu").to_dense().numpy())
        want = complex(ev[np.argmax(np.abs(ev))])
        err = abs(complex(r.eigenvalue) - want) / abs(want)
        print(f"phase 22 load_partitioned data/B.txt: lambda {complex(r.eigenvalue):.10g} vs "
              f"numpy {want:.10g} (rel {err:.2e}, limit 1e-6)")
        check(bool(r.converged) and err <= 1e-6, "phase 22 load_partitioned: eigenvalue")
        return by_name
    finally:
        dist.destroy_process_group()
        shutil.rmtree(folder, ignore_errors=True)


def distributed_alone() -> None:
    """``--distributed``: phase 22 alone, with its own scipy references."""
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card_name, card_limit = card_line().split(", ")
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    op32 = banded_full(N, bandwidth=BANDWIDTH, dtype=np.float32, seed=0, device=dev)
    ctx = {"dev": dev, "offs": op32.offsets, "op32": op32,
           "op64c": banded_full(N, bandwidth=BANDWIDTH, dtype=np.complex64, seed=1, device=dev),
           "planted": planted_band(N, np.float32, seed=2),
           "uniform_coo": general_coo(N, GELL_PER_ROW, "uniform"),
           "card_name": card_name, "card_limit": card_limit}
    t0 = time.perf_counter()
    launches = distributed_phase(eigsol, ctx)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s (with its scipy references); "
          f"launches {launches}")


def main() -> None:
    import torch

    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb
    from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.hessenberg import (
        HESSENBERG_BLOCKED_MIN_N)
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import (
        norm, power_iteration_loop, vdot)
    from pcsc_eigenvalue_solver_project_tpu_torch.solvers.qr_eigenvalues import qr_dispatch

    # ---- 1. the card -------------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    dev = torch.device("cuda")

    # ---- 2. the build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path()})")

    # ---- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-1, 1, N)
    op32 = banded_full(N, bandwidth=BANDWIDTH, dtype=np.float32, seed=0, device=dev)
    offs = op32.offsets
    x32 = torch.from_numpy(x_np).to(dev, torch.float32)
    errors = {}  # kernel -> max abs error at the main shape and dtype
    timings = {}

    def compare(label, kernel_name, y, y_ref, limit, main_case=False):
        torch.cuda.synchronize()
        err = rel_err(y, y_ref)
        print(f"check {label}: rel err {err:.3e} (limit {limit:.0e})")
        check(torch.isfinite(y).all().item(), f"{label}: non-finite output")
        check(err <= limit, f"{label}: rel err {err:.3e} above {limit:.0e}")
        if main_case:
            errors[kernel_name] = float((y - y_ref).abs().max())

    def bytes_rowmajor(vals, x):
        return vals.numel() * vals.element_size() + 2 * x.numel() * x.element_size()

    # B2: f32, bf16, f64 on the bench operator
    for dt, limit in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5),
                      (torch.float64, 1e-12)):
        vals = op32.data.to(dt)
        x = x32.to(ds.acc_dtype(dt))
        compare(f"B2 dia_kernel {dt} n={N}", "B2", ds.dia_matvec(vals, offs, x),
                ds.dia_matvec_plain(vals, offs, x), limit, dt == torch.float32)
        if dt != torch.float64:
            k_ms, p_ms = timed_pair(lambda: ds.dia_kernel(vals, offs, x),
                                    lambda: ds.dia_matvec_plain(vals, offs, x))
            timings[("B2", dt)] = (k_ms, p_ms, bytes_rowmajor(vals, x))
    # B2 on (-130, 0, 129) at a ragged n
    n_r, offs_r = N + 3, (-130, 0, 129)
    vals_r = torch.from_numpy(rng.uniform(-1, 1, (3, n_r))).to(dev, torch.float32)
    vals_r[0, :130] = 0
    vals_r[2, n_r - 129:] = 0
    x_r = torch.from_numpy(rng.uniform(-1, 1, n_r)).to(dev, torch.float32)
    compare(f"B2 dia_kernel offsets {offs_r} n={n_r}", "B2",
            ds.dia_matvec(vals_r, offs_r, x_r),
            ds.dia_matvec_plain(vals_r, offs_r, x_r), 1e-5)
    # B3: complex64
    op64c = banded_full(N, bandwidth=BANDWIDTH, dtype=np.complex64, seed=1, device=dev)
    xc = torch.from_numpy(x_np + 1j * rng.uniform(-1, 1, N)).to(dev, torch.complex64)
    compare(f"B3 dia_complex_kernel complex64 n={N}", "B3",
            ds.dia_matvec(op64c.data, offs, xc),
            ds.dia_matvec_plain(op64c.data, offs, xc), 1e-5, True)
    k_ms, p_ms = timed_pair(lambda: ds.dia_complex_kernel(op64c.data, offs, xc),
                            lambda: ds.dia_matvec_plain(op64c.data, offs, xc))
    timings[("B3", torch.complex64)] = (k_ms, p_ms, bytes_rowmajor(op64c.data, xc))
    # B1: f32 and bf16 diagonals, tile_s 64 and 8
    pr = ds.il_window_halo(offs)
    for dt in (torch.float32, torch.bfloat16):
        for tile_s in (64, 8):
            il = op32.interleaved(tile_s, dtype=dt)
            x_il = il.encode_vec(x32)
            compare(f"B1 dia_il_kernel {dt} tile_s={tile_s} n={N}", "B1",
                    ds.dia_matvec_il(il.data_il, offs, x_il),
                    ds.dia_matvec_il_plain(il.data_il, offs, x_il), 1e-5,
                    dt == torch.float32 and tile_s == 64)
            if tile_s == 64:
                w = ds._il_window(x_il, pr)
                k_ms, p_ms = timed_pair(
                    lambda: ds.dia_il_kernel(il.data_il, offs, w),
                    lambda: ds.dia_matvec_il_window_plain(il.data_il, offs, w))
                nbytes = (il.data_il.numel() * il.data_il.element_size()
                          + (w.numel() + x_il.numel()) * 4)
                timings[("B1", dt)] = (k_ms, p_ms, nbytes)
                k_ms, p_ms = timed_pair(
                    lambda: ds.dia_matvec_il(il.data_il, offs, x_il),
                    lambda: ds.dia_matvec_il_plain(il.data_il, offs, x_il))
                timings[("B1+window", dt)] = (k_ms, p_ms, nbytes)
    # B1 from a window whose halo rows carry values
    il = op32.interleaved()
    w = torch.from_numpy(rng.uniform(-1, 1, (il.R + 2 * pr, ds.LANES))).to(dev, torch.float32)
    compare(f"B1 dia_matvec_il_window with halo values n={N}", "B1",
            ds.dia_matvec_il_window(il.data_il, offs, w),
            ds.dia_matvec_il_window_plain(il.data_il, offs, w), 1e-5)
    # B1's power step and its finish, f32 and bf16 diagonals: launch by launch
    # from the same state as their plain versions (the start's product and
    # its finish, then one iteration), then timed from the state they leave
    for dt in (torch.float32, torch.bfloat16):
        il = op32.interleaved(dtype=dt)
        st = ds.power_state(il.encode_vec(x32 / torch.linalg.vector_norm(x32)))
        for it in range(2):
            ref = ds.PowerState(*(t.clone() for t in st))
            ds.dia_il_power_kernel(il.data_il, offs, st, it)
            ds.dia_il_power_step_plain(il.data_il, offs, ref, it)
            main = dt == torch.float32 and it == 1
            compare(f"B1 dia_il_power_kernel {dt} step {it} product n={N}", "B1 power",
                    st.zz[1 - it], ref.zz[1 - it], 1e-5, main)
            compare(f"B1 dia_il_power_kernel {dt} step {it} partials n={N}", "B1 power",
                    st.partials, ref.partials, 1e-5)
            ref = ds.PowerState(*(t.clone() for t in st))
            ds.power_finish_kernel(st, 0.0, init=it == 0)
            ds.power_finish_plain(ref, 0.0, init=it == 0)
            check(torch.equal(st.ctl, ref.ctl),
                  f"power_finish_kernel {dt} step {it}: carry {st.ctl.tolist()}, plain "
                  f"{ref.ctl.tolist()}")
            compare(f"power_finish_kernel {dt} step {it} scalars", "power finish",
                    st.sc, ref.sc, 1e-5, main)
        check(st.ctl.tolist() == [1, 0, 1, 0, 1, 0, 0, 0],
              f"power step {dt}: carry {st.ctl.tolist()} after one iteration")
        # the step reads half cur; the finish times a tolerance no difference
        # meets, so that each call makes the whole update
        step_bytes = (il.data_il.numel() * il.data_il.element_size() + 2 * st.zz[0].numel() * 4
                      + st.partials.numel() * 4)
        k_ms, p_ms = timed_pair(lambda: ds.dia_il_power_kernel(il.data_il, offs, st, 0),
                                lambda: ds.dia_il_power_step_plain(il.data_il, offs, st, 0),
                                plain_timer=time_events_ms)
        timings[("B1 power", dt)] = (k_ms, p_ms, step_bytes)
        finish_bytes = st.partials.numel() * 4 + 2 * (st.ctl.numel() + st.sc.numel()) * 4
        k_ms, p_ms = timed_pair(lambda: ds.power_finish_kernel(st, -1.0),
                                lambda: ds.power_finish_plain(st, -1.0),
                                plain_timer=time_events_ms)
        timings[("power finish", dt)] = (k_ms, p_ms, finish_bytes)
    spmv_kernels = (ds.dia_il_kernel, ds.dia_kernel, ds.dia_complex_kernel)  # B1-B3
    power_kernels = (ds.dia_il_power_kernel, ds.power_finish_kernel)
    for kernel in (*spmv_kernels, *power_kernels):
        print(f"launches in phase 3: {kernel.__name__} = {kernel.launches}")
        check(kernel.launches > 0, f"{kernel.__name__} never launched")
    card_name, card_limit = (s.strip() for s in card.splitlines()[0].split(","))
    # the library call computing the same product: torch.sparse.mm on the
    # band's CSR form (timed here only; the port never calls it)
    library = {}
    for tags, vals, x in ((("B1", "B2"), op32.data, x32), (("B3",), op64c.data, xc)):
        csr = band_csr(vals, offs)
        y_lib = torch.sparse.mm(csr, x[:, None])[:, 0]
        print(f"library torch.sparse.mm (CSR) {vals.dtype} n={N}: rel err against the plain "
              f"version {rel_err(y_lib, ds.dia_matvec_plain(vals, offs, x)):.2e}")
        lib_ms = time_events_ms(lambda: torch.sparse.mm(csr, x[:, None]), reps=20)
        library.update({tag: lib_ms for tag in tags})
        del csr, y_lib
    for (kernel, dt), (k_ms, p_ms, nbytes) in timings.items():
        print(f"time {kernel} {dt} {N}x33: kernel {k_ms * 1e3:.1f} us "
              f"({nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), "
              f"plain {p_ms * 1e3:.1f} us [{card_name}, {card_limit}]")

    # ---- 4/5. the main path ------------------------------------------------
    x0 = np.random.default_rng(1).uniform(-1, 1, N)
    budget = eigsol.SolverOptions(max_iterations=200, tolerance=0.0)
    converge = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-6)
    planted = planted_band(N, np.float32, seed=2)
    planted_c = planted_band(N, np.complex64, seed=3)
    p32 = eigsol.SparseDIA(data=torch.from_numpy(planted).to(dev),
                           offsets=offs, shape=(N, N))
    p64c = eigsol.SparseDIA(data=torch.from_numpy(planted_c).to(dev),
                            offsets=offs, shape=(N, N))
    runs = {  # name -> (operator, options)
        "IL f32 budget": (op32.interleaved(), budget),
        "IL bf16 budget": (op32.interleaved(dtype=torch.bfloat16), budget),
        "DIA f32 budget": (op32, budget),
        "DIA c64 budget": (op64c, budget),
        "IL f32 converge": (p32.interleaved(), converge),
        "IL bf16 converge": (p32.interleaved(dtype=torch.bfloat16), converge),
        "DIA f32 converge": (p32, converge),
        "DIA c64 converge": (p64c, converge),
    }
    for M, _ in runs.values():  # warm-up (allocator, library handles)
        eigsol.power_method(M, eigsol.SolverOptions(max_iterations=3), x0=x0)
    A = eigsol.read_matrix_from_file("data/A.txt", torch.complex128, device=dev)
    B = eigsol.read_matrix_from_file("data/B.txt", torch.complex128, device=dev)
    demo = eigsol.SolverOptions(max_iterations=1000, tolerance=1e-10)
    torch.cuda.synchronize()

    t_main = time.perf_counter()
    ds.reset_launch_counts()
    results, seconds = {}, {}
    for name, (M, opts) in runs.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results[name] = eigsol.power_method(M, opts, x0=x0)
        end.record()
        end.synchronize()
        seconds[name] = start.elapsed_time(end) / 1e3
    files = {"A": eigsol.power_method(A, demo), "B": eigsol.power_method(B, demo)}
    torch.cuda.synchronize()
    launches = {kernel.__name__: kernel.launches for kernel in (*spmv_kernels, *power_kernels)}

    print(f"main-path launches: {launches}")
    for kernel in (*spmv_kernels[1:], *power_kernels):
        check(launches[kernel.__name__] > 0,
              f"{kernel.__name__} was not launched by the main path")
    # the power runs on InterleavedDIA take B1's power step, not B1's window
    check(launches["dia_il_kernel"] == 0,
          f"dia_il_kernel launched {launches['dia_il_kernel']} times by the main path")
    # (a) fixed budget: against the loop driven by the plain matvec
    for name in ("IL f32 budget", "IL bf16 budget", "DIA f32 budget", "DIA c64 budget"):
        M, opts = runs[name]
        r = results[name]
        if isinstance(M, eigsol.InterleavedDIA):
            def plain(v, M=M):
                return ds.dia_matvec_il_plain(M.data_il, M.offsets, v)
        else:
            def plain(v, M=M):
                return ds.dia_matvec_plain(M.data, M.offsets, v)
        vec_dt = torch.promote_types(M.dtype, torch.float32)
        xs = torch.from_numpy(x0).to(dev, vec_dt)
        ref = power_iteration_loop(plain, vdot, norm, M.encode_vec(xs / norm(xs)),
                                   opts.max_iterations, opts.tolerance)
        lam, lam_ref = complex(r.eigenvalue), complex(ref.eigenvalue)
        err = abs(lam - lam_ref) / abs(lam_ref)
        per_iter = seconds[name] / int(r.iterations)
        nnz = int(torch.count_nonzero(M.data_il if hasattr(M, "data_il") else M.data))
        print(f"power {name}: lambda {lam:.7g} vs plain loop {lam_ref:.7g} "
              f"(rel {err:.2e}, limit 1e-4), {int(r.iterations)} iterations "
              f"(plain loop {int(ref.iterations)}), {per_iter * 1e6:.1f} us/iteration, {nnz / per_iter / 1e9:.1f} Gnnz/s "
              f"[{card_name}, {card_limit}]")
        check(0 < int(r.iterations) <= opts.max_iterations,
              f"{name}: {int(r.iterations)} iterations")
        check(r.eigenvector.shape == (N,) and torch.isfinite(r.eigenvector).all().item(),
              f"{name}: bad eigenvector")
        check(err <= 1e-4, f"{name}: eigenvalue off the plain loop by {err:.2e}")
    # (b) converging operator: against scipy's eigs in float64
    oracles = {"f32": scipy_dominant(planted, offs),
               "bf16": scipy_dominant(p32.interleaved(dtype=torch.bfloat16)
                                      .to_natural().data.float().cpu().numpy(), offs),
               "c64": scipy_dominant(planted_c, offs)}
    for name, key in (("IL f32 converge", "f32"), ("IL bf16 converge", "bf16"),
                      ("DIA f32 converge", "f32"), ("DIA c64 converge", "c64")):
        r = results[name]
        lam, lam_ref = complex(r.eigenvalue), oracles[key]
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"power {name}: lambda {lam:.7g} vs scipy eigs {lam_ref:.7g} "
              f"(rel {err:.2e}, limit 1e-4), {int(r.iterations)} iterations, "
              f"converged={bool(r.converged)}, {seconds[name]:.3f} s")
        check(bool(r.converged), f"{name}: did not converge")
        check(err <= 1e-4, f"{name}: eigenvalue off scipy by {err:.2e}")
    # the reference data files against numpy
    for key, M in (("A", A), ("B", B)):
        r = files[key]
        ev = np.linalg.eigvals(M.to_dense().cpu().numpy())
        lam_ref = complex(ev[np.argmax(np.abs(ev))])
        lam = complex(r.eigenvalue)
        err = abs(lam - lam_ref) / abs(lam_ref)
        print(f"data/{key}.txt ({type(M).__name__}): lambda {lam:.10g} vs numpy "
              f"{lam_ref:.10g} (rel {err:.2e}, limit 1e-6), "
              f"{int(r.iterations)} iterations, converged={bool(r.converged)}")
        check(bool(r.converged), f"data/{key}.txt: did not converge")
        check(err <= 1e-6, f"data/{key}.txt: eigenvalue off numpy by {err:.2e}")

    print(f"phases 4-5: {time.perf_counter() - t_main:.1f} s")

    # ---- 6. the QR kernels against their plain versions --------------------
    t0 = time.perf_counter()
    qr_errors, qr_timings = qr_kernel_phase(dev, card_name, card_limit)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # ---- 7. the QR path ----------------------------------------------------
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    qr_path_phase(eigsol, dev)
    torch.cuda.synchronize()
    qr_launches = {kernel.__name__: kernel.launches for kernel in qk.KERNELS}
    print(f"QR-path launches: {qr_launches}")
    for kernel in (qk.hessenberg_kernel, qk.qr_eig_kernel, qk.qr_decompose_kernel,
                   qk.qr_parity_kernel):  # the eigenvalue path at 512 (B11, B14: phases 10-11)
        check(kernel.launches > 0, f"{kernel.__name__} was not launched by the QR path")
    if qr_dispatch(QR_N, dev) == "cuda_blocked":
        check(qk.qr_eig_blocked_kernel.launches > 0,
              "qr_eig_blocked_kernel was not launched by the QR path")
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # ---- 8. the blocked Hessenberg and eigenvector kernels -----------------
    t0 = time.perf_counter()
    blk_errors, blk_timings = blocked_kernel_phase(dev, card_name, card_limit)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # ---- 9. the boundary sweep and the library calls -----------------------
    t0 = time.perf_counter()
    library.update(boundary_sweep_phase(dev, card_name, card_limit))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # ---- 10. the eigenpair path --------------------------------------------
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    eigenpair_path_phase(eigsol, dev)
    torch.cuda.synchronize()
    pair_launches = {kernel.__name__: kernel.launches for kernel in qk.KERNELS}
    print(f"eigenpair-path launches: {pair_launches}")
    check(pair_launches["hessenberg_kernel"] + pair_launches["hessenberg_blocked_kernel"] > 0,
          "no Hessenberg kernel was launched by the eigenpair path")
    for name in ("qr_eig_kernel", "triangular_eigenvectors_kernel"):
        check(pair_launches[name] > 0, f"{name} was not launched by the eigenpair path")
    if HESSENBERG_BLOCKED_MIN_N <= LARGE_N:  # run (e)
        check(pair_launches["hessenberg_blocked_kernel"] > 0,
              "hessenberg_blocked_kernel was not launched by the eigenpair path")
    if qr_dispatch(LARGE_N, dev) == "cuda_blocked":  # run (e)
        check(pair_launches["qr_eig_blocked_kernel"] > 0,
              "qr_eig_blocked_kernel was not launched by the eigenpair path")
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- 11. to_hessenberg on the blocked kernel ---------------------------
    t0 = time.perf_counter()
    hess_launches = to_hessenberg_phase(eigsol, dev, qk, hb)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- 12. the blocked sweeps against their plain version -----------------
    t0 = time.perf_counter()
    b13_err, b13_timing = blocked_sweeps_phase(dev, card_name, card_limit)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- 13. the boundary between the unblocked and blocked sweeps ----------
    t0 = time.perf_counter()
    blocked_boundary_phase(dev, card_name, card_limit)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # ---- 14. the path beyond the boundary -------------------------------------
    t0 = time.perf_counter()
    qk.reset_launch_counts()
    blocked_path_phase(eigsol, dev)
    torch.cuda.synchronize()
    big_launches = {kernel.__name__: kernel.launches for kernel in qk.KERNELS}
    print(f"blocked-path launches: {big_launches}")
    for name in ("hessenberg_blocked_kernel", "qr_eig_blocked_kernel",
                 "triangular_eigenvectors_kernel"):
        check(big_launches[name] > 0, f"{name} was not launched by the blocked path")
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # ---- 15/16. the split-plane and block kernels and their paths ------------
    ctx = {"dev": dev, "offs": offs, "op32": op32, "op64c": op64c, "xc": xc,
           "planted": planted, "planted_c": planted_c, "card_name": card_name,
           "card_limit": card_limit}
    t0 = time.perf_counter()
    blk_kernel_errors, blk_kernel_timings, blk_library = banded_block_kernel_phase(ctx)
    library.update(blk_library)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    block_launches = banded_block_path_phase(ctx)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # ---- 17/18. the general sparse kernel and its paths ---------------------
    t0 = time.perf_counter()
    gell_errors, gell_timings, gell_library, uniform_coo = general_sparse_kernel_phase(ctx)
    ctx["uniform_coo"] = uniform_coo
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gell_launches = general_sparse_path_phase(ctx, uniform_coo)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # ---- 19. AED on the card ------------------------------------------------
    t0 = time.perf_counter()
    aed_launches = aed_phase(eigsol, dev, card_name, card_limit)
    print(f"phase-19 public-path launches: {aed_launches}")
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # ---- 20. the shifted solves on the card ---------------------------------
    t0 = time.perf_counter()
    ctx["oracle_f32"] = oracles["f32"]
    shifted_phase(eigsol, ctx)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # ---- 21. the Krylov and block solvers, ds64, the writer, the demo --------
    t0 = time.perf_counter()
    krylov_phase(eigsol, ctx)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # ---- 22. the distributed layer on an NCCL group of one rank ---------------
    t0 = time.perf_counter()
    dist_launches = distributed_phase(eigsol, ctx)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s")

    # ---- report ------------------------------------------------------------
    rows = []

    def add_row(name, source, replaces, launch_count, err, k_ms, p_ms, nbytes, flops, tag):
        bound_ms, bound_by = bound(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launch_count, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library.get(tag)})

    nnz = len(offs) * N
    for kernel, tag, line, dt, flops in ((ds.dia_il_kernel, "B1", 390, torch.float32, 2 * nnz),
                                         (ds.dia_kernel, "B2", 36, torch.float32, 2 * nnz),
                                         (ds.dia_complex_kernel, "B3", 73, torch.complex64,
                                          8 * nnz)):
        k_ms, p_ms, nbytes = timings[(tag, dt)]
        add_row(kernel.__name__, KERNEL_SOURCE, f"{TPU_KERNELS}:{line}",
                launches[kernel.__name__], errors[tag], k_ms, p_ms, nbytes, flops, tag)
    # B1's power step per call at 1M x 33 f32 (the product, the scale of its
    # input and the two partial sums), and its one-block finish (the partials
    # read, the carry read and written); both replace the JAX package's B1
    # and its power loop's vector work
    m = ds.il_rows(N) * ds.LANES
    for kernel, tag, flops in ((ds.dia_il_power_kernel, "B1 power", 2 * nnz + 5 * m),
                               (ds.power_finish_kernel, "power finish",
                                2 * ds.power_blocks(ds.il_rows(N)))):
        k_ms, p_ms, nbytes = timings[(tag, torch.float32)]
        add_row(kernel.__name__, KERNEL_SOURCE, f"{TPU_KERNELS}:390, {TPU_POWER}:98",
                launches[kernel.__name__], errors[tag], k_ms, p_ms, nbytes, flops, tag)
    # B7/B9 per call at 512 float32; B8 (complex64) per sweep at 128 (a call
    # of 10 sweeps reads H once and writes it once). B10 (float32) per sweep
    # at 128 as a Hessenberg sweep's work, counted as B13's row below, over a
    # call of 10 sweeps as B8's: the upper-Hessenberg part read and written
    # once a call, and each sweep's rotations' own arithmetic (left rotation
    # k on rows k, k + 1 over columns k .. n - 1, right rotation k on columns
    # k, k + 1 over rows 0 .. k + 1, two real multiply-adds an entry). Its
    # iterate is that of the reference's
    # Householder QR and R Q product (14/3 n^3 flops a sweep) up to a
    # diagonal unitary; that count is the reference's algorithm, not the work
    # this iteration needs.
    n, m = QR_N, QR_SWEEP_N
    hess = m * (m + 1) // 2 + m - 1
    rot_madds = sum(4 * (m - k) + 4 * min(k + 2, m) for k in range(m - 1))
    for kernel, tag, line, dt, nbytes, flops in (
            (qk.hessenberg_kernel, "B7", 55, torch.float32, 2 * 4 * n * n, 10 / 3 * n ** 3),
            (qk.qr_eig_kernel, "B8", 293, torch.complex64, 2 * 8 * m * m / 10, 32 * m * m),
            (qk.qr_decompose_kernel, "B9", 756, torch.float32, 3 * 4 * n * n, 8 / 3 * n ** 3),
            (qk.qr_parity_kernel, "B10", 797, torch.float32, 2 * 4 * hess / 10, 2 * rot_madds)):
        k_ms, p_ms, _ = qr_timings[(tag, dt)]
        add_row(kernel.__name__, {"B7": B7_SOURCE, "B10": QRB_SOURCE}.get(tag, QR_SOURCE),
                f"{QR_TPU_KERNELS}:{line}", qr_launches[kernel.__name__], qr_errors[tag], k_ms,
                p_ms, nbytes, flops, tag)
    # B11/B12 per call with Q (A read; H and Q written; 10/3 n^3 + 4/3 n^3
    # real flops, four times that in complex); B14 per call (T read, Y
    # written; n^3 / 6 complex multiply-adds)
    for name, tag, source, replaces in (
            ("hessenberg_blocked_kernel", "B11", HB_SOURCE, f"{HB_TPU_KERNELS}:97"),
            ("hessenberg_blocked_kernel<complex64>", "B12", HB_SOURCE, f"{HB_TPU_KERNELS}:963"),
            ("triangular_eigenvectors_kernel", "B14", TRI_SOURCE, f"{TRI_TPU_KERNELS}:72")):
        k_ms, p_ms, n, dt = blk_timings[tag]
        size, per_madd = (8, 8) if dt.is_complex else (4, 2)
        if tag == "B14":
            nbytes, flops = 2 * size * n * n, per_madd * n ** 3 / 6
            launch_count = pair_launches["triangular_eigenvectors_kernel"]
        else:
            nbytes, flops = 3 * size * n * n, per_madd / 2 * 14 / 3 * n ** 3
            launch_count = hess_launches[tag]
        add_row(name, source, replaces, launch_count, blk_errors[tag], k_ms, p_ms, nbytes,
                flops, tag)
    # B13 per full-window sweep at LARGE_N in complex64, eigenvalues only:
    # the upper-Hessenberg part read once and written once, and the
    # rotations' own arithmetic, as B8's row counts it: left rotation k turns
    # rows k, k + 1 over columns k .. n - 1, right rotation k columns k, k + 1
    # over rows 0 .. k + 1, two complex multiply-adds (8 flops) per entry
    n = LARGE_N
    elements = n * (n + 1) // 2 + n - 1
    cmadds = sum(4 * (n - k) + 4 * min(k + 2, n) for k in range(n - 1))
    add_row("qr_eig_blocked_kernel", QRB_SOURCE, f"{QRB_TPU_KERNELS}:63",
            big_launches["qr_eig_blocked_kernel"], b13_err, b13_timing[0], b13_timing[1],
            2 * 8 * elements, 8 * cmadds, "B13")
    # B4 and B3's planes entry per call at 1M x 33 f32 planes (four FMAs per
    # stored complex entry); B5 per call at nvec = 8 (one FMA per entry and vector)
    for name, tag, line, flops in (
            ("dia_il_planes_kernel", "B4", 577, 8 * nnz),
            ("dia_planes_kernel", "planes", 73, 8 * nnz),
            ("dia_block_kernel", "B5", 223, 2 * nnz * 8),
            ("dia_il_block_kernel", "B5il", 695, 2 * nnz * 8)):
        k_ms, p_ms, nbytes = blk_kernel_timings[(tag, torch.float32)]
        add_row(name, KERNEL_SOURCE, f"{TPU_KERNELS}:{line}", block_launches[name],
                blk_kernel_errors[tag], k_ms, p_ms, nbytes, flops,
                tag if tag.startswith("B5") else "B3")
    # B6 per call at 1M x 33 uniform: f32 values on a native vector, and
    # complex64 pairs on re/im planes (one FMA per entry, four for complex)
    for name, tag, key, lib_key, line in (
            ("gell_kernel", "B6", ("f32", "uniform"), ("f32", "uniform"), 356),
            ("gell_planes_kernel", "B6cpx", ("B6cpx", "uniform"), ("c64", "uniform"), 367)):
        k_ms, p_ms, nbytes, flops, _, picked = gell_timings[key]
        library[tag] = gell_library[lib_key]
        # the source of the route the pack picked (the launches count both)
        add_row(name, GELL_SOURCE if picked == "csr" else GELL_WINDOW_SOURCE,
                f"{GELL_TPU_KERNELS}:{line}", gell_launches[name], gell_errors[tag], k_ms, p_ms,
                nbytes, flops, tag)
    for row in rows:  # the distributed paths' launches (phase 22) join their kernels' rows
        row["launches"] += dist_launches.get(row["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--b6-host"] and len(sys.argv) == 3:
        b6_host_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b6"] and len(sys.argv) == 3:
        b6_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b11"] and len(sys.argv) == 3:
        b11_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b7"] and len(sys.argv) == 3:
        b7_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b5"] and len(sys.argv) == 3:
        b5_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b13"] and len(sys.argv) == 3:
        b13_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b14"] and len(sys.argv) == 3:
        b14_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b10"] and len(sys.argv) == 3:
        b10_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b8"] and len(sys.argv) == 3:
        b8_compare(sys.argv[2])
    elif sys.argv[1:] == ["--aed-table"]:
        aed_table()
    elif sys.argv[1:] == ["--c4"]:
        c4_table()
    elif sys.argv[1:] == ["--krylov"]:
        krylov_alone()
    elif sys.argv[1:] == ["--distributed"]:
        distributed_alone()
    else:
        main()
    sys.stdout.flush()
