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
   device kernels per call), the shifted Givens sweeps (B8) and the parity sweeps (B10)
   with a budget of 10 sweeps at n = 128 in four dtypes and of a few sweeps
   at n = 512 in the path's dtypes, each with its time beside the plain
   version's;
7. the QR path through the public API on CUDA tensors at n = 512: the
   bench operand (symmetric, spectrum 0.9^i) in float32 and a complex64
   operand with spectrum 0.9^i e^(i theta) in both modes, a real
   non-symmetric matrix in accelerated mode against numpy in float64, the
   bench operand's construction at 128 in accelerated mode (B8: at most
   ``UNBLOCKED_MAX_N``; B13 beyond it), and the reference demo's QR section
   on ``data/A.txt``;
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
    plain version's and ``torch.sparse.mm``'s side by side;
18. the general-sparse path: ``from_coo(layout="auto")`` on bench.py's three
    auto patterns at 100,000, ``power_method`` on each pick and on the
    hand-picked layout, on ``SparseGELL`` at 1M x 33 (budget and a planted
    variant against scipy), on a planted shuffled band through the
    ``PermutedOperator`` (residual in the caller's indexing), on
    ``data/B.txt`` as complex128 ``to_gell()``, and on the complex operator
    through the planes entry.

The banded kernels' launch counts are zeroed just before phases 4-5 and
read just after, the QR kernels' just before and after phases 7, 10, 14 and
each run of phase 11, the banded ones again around phase 16, and B6's and
the banded ones around phase 18; each kernel must have run on its path. The script then
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
AUTO_N = 100_000   # bench.py's auto leg (BENCH_R05_SET.jsonl:8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}  # H100 SXM data sheet, outside the tensor cores


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
    # path's n = 512 in its dtypes, B8 for 3 sweeps and B10 for 7, which B10
    # enqueues as two chunks (5 and 2 sweeps) with a host read of `done` between.
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
            ep, sp, hip, tp, _ = qk.qr_eig_plain(h, b8_sweeps, 0.0, accumulate_q=True)
            torch.cuda.synchronize()
            err, res = rel(t, tp, scale), rel(q @ t @ q.conj().T, h, scale)
            print(f"check B8 {dt} n={n}, {b8_sweeps} sweeps: T vs plain {err:.3e} "
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
        Hp, itp, cp, mp = qk.qr_parity_plain(h, b10_sweeps, 0.0)
        torch.cuda.synchronize()
        err = rel(H, Hp, scale)
        print(f"check B10 {dt} n={n}, {b10_sweeps} sweeps: H vs plain {err:.3e} "
              f"(limit {10 * unit:.1e}), it {int(it)}/{int(itp)}, maxsub {float(m):.6e}/"
              f"{float(mp):.6e}")
        check(int(it) == int(itp) == b10_sweeps and not bool(c) and not bool(cp),
              f"B10 {dt} n={n}: counts differ")
        check(err <= 10 * unit, f"B10 {dt} n={n}: off its plain version")
        if timed:
            if dt == torch.float32:
                errors["B10"] = float((H - Hp).abs().max())
            k_ms, p_ms = timed_pair(lambda: qk.qr_parity_kernel(h, sweeps, 0.0),
                                    lambda: qk.qr_parity_plain(h, sweeps, 0.0),
                                    lambda fn: time_events_ms(fn, reps=2))
            timings[("B10", dt)] = (k_ms / sweeps, p_ms / sweeps, "sweep")
    # per-sweep kernel times at the path's size (the plain versions, held
    # against the kernels above, are timed at n = 128 only)
    h512 = qk.hessenberg_kernel(operand(QR_N, torch.complex64))
    print(f"time B8 complex64 n={QR_N}: kernel "
          f"{time_events_ms(lambda: qk.qr_eig_kernel(h512, sweeps, 0.0)) / sweeps:.3f} ms/sweep "
          f"(full window) [{card_name}, {card_limit}]")
    h512r = qk.hessenberg_kernel(operand(QR_N, torch.float32))
    print(f"time B10 float32 n={QR_N}: kernel "
          f"{time_events_ms(lambda: qk.qr_parity_kernel(h512r, sweeps, 0.0), 1) / sweeps:.3f}"
          f" ms/sweep [{card_name}, {card_limit}]")
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
    5000-entry row, the 700 x 40000 rectangle). Times per call from a
    CUDA-graph replay for every route, plain versions (which read the device
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
    for name in ("gell_kernel", "gell_planes_kernel", "dia_il_kernel"):
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
    spmv_kernels = (ds.dia_il_kernel, ds.dia_kernel, ds.dia_complex_kernel)  # B1-B3
    for kernel in spmv_kernels:
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
    launches = {kernel.__name__: kernel.launches for kernel in spmv_kernels}

    print(f"main-path launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the main path")
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
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gell_launches = general_sparse_path_phase(ctx, uniform_coo)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

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
    # B7/B9 per call at 512 float32; B8 (complex64) and B10 (float32) per sweep
    # at 128 (a call of 10 sweeps reads H once and writes it once)
    n, m = QR_N, QR_SWEEP_N
    for kernel, tag, line, dt, nbytes, flops in (
            (qk.hessenberg_kernel, "B7", 55, torch.float32, 2 * 4 * n * n, 10 / 3 * n ** 3),
            (qk.qr_eig_kernel, "B8", 293, torch.complex64, 2 * 8 * m * m / 10, 32 * m * m),
            (qk.qr_decompose_kernel, "B9", 756, torch.float32, 3 * 4 * n * n, 8 / 3 * n ** 3),
            (qk.qr_parity_kernel, "B10", 797, torch.float32, 2 * 4 * m * m / 10,
             14 / 3 * m ** 3)):
        k_ms, p_ms, _ = qr_timings[(tag, dt)]
        add_row(kernel.__name__, B7_SOURCE if tag == "B7" else QR_SOURCE,
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
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--b6-host"] and len(sys.argv) == 3:
        b6_host_compare(sys.argv[2])
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
    else:
        main()
    sys.stdout.flush()
