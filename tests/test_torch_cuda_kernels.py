"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. On a machine
with an H100 (no JAX needed there):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

``--noconftest`` skips the suite's conftest, which imports JAX. The first
test builds the kernels with nvcc. SpMV errors are measured relative to
``max|y|``: 1e-5 for float32, bfloat16 (both sides read the same bf16
values and accumulate in float32) and complex64; 1e-12 for float64 and
complex128. The sums differ from the plain versions only in FMA rounding.

The QR kernels (B7-B10) are held against their plain versions relative to
max|A|, in units of ``QR_TOL`` per row (single and double precision). The
residuals ``||A - Q H Q^H||``, ``||A - Q R||`` and ``||Q^H Q - I||``, and B8's
and B10's iterates after a fixed budget, differ only in rounding and are
held to one unit (ten for the iterates). B7 and B9 run on a well-conditioned
operand (cond <= 2), whose H, R and Q are held entry by entry to one unit
once the diagonal unitary D that they are unique up to is divided out: each
entry of D is the phase of a pivot, which moves by about eps / |pivot|, so
by up to ~1e-2 at a small pivot in single-precision complex. D itself is
held to 1 within ``PHASE_TOL``, which a wrong phase convention still fails.

B7 as one cluster kernel is held the same way in four dtypes from n = 1 to
1023, with D read from Q's columns (q = qp D) and the entries to three units
in single precision (its sums run in another order, as B11's against B7);
the residuals to one unit; H and Q bitwise equal call after call; one
device kernel a call.

The blocked Hessenberg kernel B11 (B12 on complex data) is held to its plain
version the same way, and to the unblocked B7 at three units (the blocked
and unblocked sums differ in order, as tests/test_torch_hessenberg_blocked.py
measures on the CPU). The triangular-eigenvector kernel B14 is held to its
plain version on normalised columns, to 1e-4 in complex64 (the recurrence
grows Y by up to ~1e18 on a random triangle, which amplifies the summation
order; 6.7e-6 measured between the plain version and the Pallas kernel) and
to 1e-10 in complex128, and both to the residual ``|T y - lambda y|`` of
tests/test_trisolve.py (5e-3 in complex64).

The blocked sweeps B13 are held to their plain version like B8: after a fixed
budget with deflation off, T and Q to ten units (the products sum in another
order than torch.matmul), the sweep count and window exactly, and
``||H - Q T Q^H||`` to one unit; to convergence, the spectrum as B8's. Its
cooperative launch repeats bit for bit whatever the grid's size, runs one
device kernel a launch, keeps the plain version's sweep count while hi
shrinks inside a launch and across launches, and raises on a grid larger
than the card holds. B14 repeats bit for bit, and is held at n = -+ 1 of one
and two blocks of BLOCK_ROWS on the repeated eigenvalue, where every column
rescales.

The split-plane SpMV (B4 interleaved, B3's planes entry row-major) and the
block SpMM B5 (row-major and interleaved, nvec 1, 3, 8 and 13, so one full
chunk of 8 and a ragged one) are held to their plain versions as the SpMV
kernels are, relative to ``max|y|`` (``TOL``), at a ragged n and at offsets
(-130, 0, 129) that cross the lane seams of the interleaved layout. Its
staged route is held the same way at the route's edges (consecutive and
non-consecutive offsets, one-sided bands, ragged n, 1, 7, 8, 9 and 17
vectors, a band too wide for the tile, halo rows carrying values) and on the
(n, nvec) entry of the block solvers.

The general sparse SpMV B6 (``gell_kernel`` on real and native complex
vectors, ``gell_planes_kernel`` on re/im planes) is held to its plain version
the same way, relative to ``max|y|`` (``TOL`` of the vector dtype), for every
value type, at mean row lengths that give each group width, on rows of 0 to
5000 entries, duplicates, a rectangle and planes x whose planes lie apart.
"""

import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs
from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk
from pcsc_eigenvalue_solver_project_tpu_torch.ops import trisolve_vec as tv
from pcsc_eigenvalue_solver_project_tpu_torch.ops._common import COMPLEX_CODES
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import hessenberg as hs
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as qe

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5, torch.complex64: 1e-5,
       torch.float64: 1e-12, torch.complex128: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def band(n, offsets, dtype, seed, device):
    """(k, n) diagonals with zeros outside the matrix, and an (n,) vector of
    the accumulation dtype, from numpy."""
    rng = np.random.default_rng(seed)
    k = len(offsets)
    vals = rng.uniform(-1, 1, (k, n))
    x = rng.uniform(-1, 1, n)
    if dtype.is_complex:
        vals = vals + 1j * rng.uniform(-1, 1, (k, n))
        x = x + 1j * rng.uniform(-1, 1, n)
    for d, off in enumerate(offsets):
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    vals_t = torch.from_numpy(vals).to(device=device, dtype=dtype)
    x_t = torch.from_numpy(x).to(device=device, dtype=ds.acc_dtype(dtype))
    return vals_t, x_t


def rel_err(y, y_ref):
    scale = y_ref.abs().max().clamp_min(1e-30)
    return float((y - y_ref).abs().max() / scale)


ROWMAJOR_CASES = [
    (16384, (-1, 0, 1)),
    (16500, (-16, -3, 0, 7, 16)),
    (20000, tuple(range(-16, 17))),
    (16384, (-130, 0, 129)),
    (1_000_003, (-130, 0, 129)),          # ragged n at full size
    (1_000_000, tuple(range(-16, 17))),   # the 1M x 33 bench operator
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,offsets", ROWMAJOR_CASES)
def test_rowmajor_kernel_matches_plain(cuda, n, offsets, dtype):
    vals, x = band(n, offsets, dtype, seed=42, device=cuda)
    kernel = ds.dia_complex_kernel if dtype.is_complex else ds.dia_kernel
    before = kernel.launches
    y = ds.dia_matvec(vals, offsets, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y_ref = ds.dia_matvec_plain(vals, offsets, x)
    assert y.dtype == y_ref.dtype == ds.acc_dtype(dtype)
    assert rel_err(y, y_ref) <= TOL[dtype]


IL_CASES = [
    (20000, tuple(range(-16, 17)), 64),
    (16500, (-16, -3, 0, 7, 16), 64),
    (20000, (-100, -3, 0, 5, 99), 64),
    (9000, (-1, 0, 1), 8),
    (1_000_000, tuple(range(-16, 17)), 64),
    (1_000_000, tuple(range(-16, 17)), 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64,
                                   torch.complex64])
@pytest.mark.parametrize("n,offsets,tile_s", IL_CASES)
def test_il_kernel_matches_plain(cuda, n, offsets, tile_s, dtype):
    vals, x = band(n, offsets, dtype, seed=7, device=cuda)
    R = ds.il_rows(n, tile_s)
    vals_il = ds.interleave_dia_vals(vals, R)
    x_il = ds.interleave_vec(x, R)
    before = ds.dia_il_kernel.launches
    y = ds.dia_matvec_il(vals_il, offsets, x_il)
    torch.cuda.synchronize()
    assert ds.dia_il_kernel.launches == before + 1
    y_ref = ds.dia_matvec_il_plain(vals_il, offsets, x_il)
    assert rel_err(y, y_ref) <= TOL[dtype]
    # and against the row-major plain version through the codec
    y_nat = ds.dia_matvec_plain(vals, offsets, x)
    assert rel_err(ds.deinterleave_vec(y, n), y_nat) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offsets", [(20000, (-9, 0, 3, 9)),
                                       (1_000_000, tuple(range(-16, 17)))])
def test_il_window_kernel_with_halo_values(cuda, n, offsets, dtype):
    # halo rows carry arbitrary values (a neighbouring shard's entries)
    vals, _ = band(n, offsets, dtype, seed=3, device=cuda)
    R = ds.il_rows(n, 64)
    pr = ds.il_window_halo(offsets)
    vals_il = ds.interleave_dia_vals(vals, R)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.rand((R + 2 * pr, ds.LANES), generator=gen, device=cuda) * 2 - 1
    assert w[:pr].abs().sum() > 0
    y = ds.dia_matvec_il_window(vals_il, offsets, w)
    y_ref = ds.dia_matvec_il_window_plain(vals_il, offsets, w)
    assert rel_err(y, y_ref) <= TOL[dtype]


def test_kernels_reject_what_they_do_not_take(cuda):
    vals, x = band(1000, (-1, 0, 1), torch.float32, seed=0, device=cuda)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        ds.dia_kernel(vals, (-1, 0, 1), x.cpu())
    with pytest.raises(TypeError, match="does not match"):
        ds.dia_kernel(vals, (-1, 0, 1), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ds.dia_kernel(vals.T.contiguous().T, (-1, 0, 1), x)
    with pytest.raises(ValueError, match="3 offsets for 2 diagonals"):
        ds.dia_kernel(vals[:2].contiguous(), (-1, 0, 1), x)
    with pytest.raises(TypeError, match="dia_complex_kernel"):
        ds.dia_kernel(vals.to(torch.complex64), (-1, 0, 1), x.to(torch.complex64))


# --------------------------------------------------------------------------
# Dense QR kernels B7-B10
# --------------------------------------------------------------------------

QR_DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
# per unit of n: single precision, double precision
QR_TOL = {False: 1e-6, True: 1e-14}
PHASE_TOL = {False: 0.2, True: 1e-6}


def is_double(dtype):
    return dtype in (torch.float64, torch.complex128)


def qr_tol(dtype, n):
    return QR_TOL[is_double(dtype)] * max(n, 8)


def gaussian(rng, n, dtype):
    a = rng.standard_normal((n, n))
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal((n, n))
    return a


def dense(n, dtype, seed, device):
    return torch.from_numpy(gaussian(np.random.default_rng(seed), n, dtype)).to(
        device=device, dtype=dtype)


def well_conditioned(n, dtype, seed, device):
    """U diag(uniform[1, 2]) V^H with random unitary U and V: cond <= 2."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(gaussian(rng, n, dtype))
    v, _ = np.linalg.qr(gaussian(rng, n, dtype))
    a = (u * rng.uniform(1, 2, n)) @ v.conj().T
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def unit_phase(z):
    m = z.abs()
    return torch.where(m > 0, z / torch.where(m > 0, m, 1), 1)


def hessenberg_phases(h, hp):
    """D with h = D^H hp D and D[0] = 1, from the subdiagonals."""
    r = (unit_phase(hp.diagonal(-1)) / unit_phase(h.diagonal(-1))).cpu().numpy()
    return torch.from_numpy(np.concatenate([[1], np.cumprod(r)])).to(h.device, h.dtype)


def rel_to(x, y, scale):
    return float((x - y).abs().max()) / scale


def matched_err(got, want):
    """Max distance between two spectra under a one-to-one matching."""
    from scipy.optimize import linear_sum_assignment
    cost = np.abs(np.asarray(got)[:, None] - np.asarray(want)[None, :])
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].max())


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [1, 2, 5, 33, 128, 512])
def test_hessenberg_and_qr_kernels_match_plain(cuda, n, dtype):
    a = well_conditioned(n, dtype, seed=n, device=cuda)
    scale = float(a.abs().max())
    eye = torch.eye(n, dtype=dtype, device=cuda)
    before = (qk.hessenberg_kernel.launches, qk.qr_decompose_kernel.launches)
    h, q = qk.hessenberg_reduce(a, accumulate_q=True)
    r, qq = qk.householder_qr(a)
    torch.cuda.synchronize()
    assert (qk.hessenberg_kernel.launches, qk.qr_decompose_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    hp, qp = qk.hessenberg_plain(a, accumulate_q=True)
    rp, qqp = qk.qr_decompose_plain(a)
    tol, phase_tol = qr_tol(dtype, n), PHASE_TOL[is_double(dtype)]
    # entries up to the diagonal unitary D: see the module docstring
    d = hessenberg_phases(h, hp)
    assert float((d - 1).abs().max()) <= phase_tol
    assert rel_to(h, d.conj()[:, None] * hp * d, scale) <= tol
    assert rel_to(q, qp * d, 1.0) <= tol
    assert rel_to(q @ h @ q.conj().T, a, scale) <= tol
    assert rel_to(q.conj().T @ q, eye, 1.0) <= tol
    if n > 2:
        assert float(torch.tril(h, -2).abs().max()) <= tol * scale
    d = unit_phase(r.diagonal()) / unit_phase(rp.diagonal())
    assert float((d - 1).abs().max()) <= phase_tol
    assert rel_to(r, d[:, None] * rp, scale) <= tol
    assert rel_to(qq, qqp * d.conj(), 1.0) <= tol
    assert rel_to(qq @ r, a, scale) <= tol
    assert rel_to(qq.conj().T @ qq, eye, 1.0) <= tol
    if n > 1:
        assert float(torch.tril(r, -1).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [1, 2, 5, 33, 128, 512])
def test_qr_eig_kernel_matches_plain(cuda, n, dtype):
    h = qk.hessenberg_plain(dense(n, dtype, seed=100 + n, device=cuda))
    scale = float(h.abs().max())
    tol = qr_tol(dtype, n)
    # a fixed budget of 10 sweeps with deflation off (n <= 2 converges at
    # once, and deflating at exact zero would race the rounding): the same iterates
    budget_tol = 0.0 if n > 2 else 1e-6
    e, s, hi, t, q = qk.qr_eig_kernel(h, 10, budget_tol, accumulate_q=True)
    ep, sp, hip, tp, qp = qk.qr_eig_plain(h, 10, budget_tol, accumulate_q=True)
    torch.cuda.synchronize()
    assert (int(s), int(hi)) == (int(sp), int(hip))
    assert rel_to(e, ep, scale) <= 10 * tol and rel_to(t, tp, scale) <= 10 * tol
    assert rel_to(q @ t @ q.conj().T, h, scale) <= tol
    # to convergence: the same spectrum
    e, s, hi = qk.qr_eig_kernel(h, 60 * max(n, 1), 1e-6 if dtype == torch.complex64 else 1e-12)
    assert int(hi) <= 1
    ev = np.linalg.eigvals(h.cpu().numpy().astype(np.complex128))
    limit = 1e-9 if dtype == torch.complex128 else 1e-3  # eigenvalue conditioning
    assert matched_err(e.cpu().numpy(), ev) <= limit * scale


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [1, 2, 5, 33, 64, 512])
def test_qr_parity_kernel_matches_plain(cuda, n, dtype):
    h = qk.hessenberg_plain(dense(n, dtype, seed=200 + n, device=cuda))
    scale = float(h.abs().max())
    before = qk.qr_parity_kernel.launches
    # 7 sweeps: at n = 512 two chunks (5 and 2) between host reads of `done`
    H, it, c, m = qk.parity_sweeps(h, 7, 0.0)
    torch.cuda.synchronize()
    assert qk.qr_parity_kernel.launches == before + 1
    Hp, itp, cp, mp = qk.qr_parity_plain(h, 7, 0.0)
    assert int(it) == int(itp) and bool(c) == bool(cp)
    assert rel_to(H, Hp, scale) <= 10 * qr_tol(dtype, n)
    assert abs(float(m) - float(mp)) <= 10 * qr_tol(dtype, n) * scale


def test_qr_parity_kernel_converges_with_the_reference_count(cuda):
    rng = np.random.default_rng(0)
    Qo, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    d = 0.8 ** np.arange(64)
    a = torch.from_numpy((Qo * d) @ Qo.T).to(cuda)
    eig, iterations, conv, _ = qk.parity_eigenvalues(a, 2000, 1e-10)
    _, iterations_p, conv_p, _ = qk.parity_eigenvalues(a.cpu(), 2000, 1e-10)
    assert conv and conv_p and iterations == iterations_p
    np.testing.assert_allclose(np.sort(eig.cpu().numpy()), np.sort(d), atol=1e-8)
    _, it3, conv3, _ = qk.parity_eigenvalues(a, 3, 1e-10)
    assert not conv3 and it3 == 4  # max_iterations + 1


def test_qr_kernels_reject_what_they_do_not_take(cuda):
    a = dense(8, torch.float32, seed=0, device=cuda)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        qk.hessenberg_kernel(a.cpu())
    with pytest.raises(TypeError, match="unsupported dtype"):
        qk.qr_eig_kernel(a, 10, 1e-6)  # B8 takes complex only
    with pytest.raises(TypeError, match="unsupported dtype"):
        qk.qr_decompose_kernel(a.half())
    with pytest.raises(ValueError, match="square"):
        qk.qr_parity_kernel(a[:, :4].contiguous(), 10, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        qk.hessenberg_kernel(a.T)


@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_public_qr_functions_on_the_card(cuda, dtype):
    # the public entry points on a CUDA tensor: kernels only, every dtype
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    n = 24
    a = dense(n, dtype, seed=7, device=cuda)
    M = eigsol.DenseMatrix(a)
    double = dtype in (torch.float64, torch.complex128)
    qk.reset_launch_counts()
    h = eigsol.to_hessenberg(M)
    q, r = eigsol.qr_decompose(M)
    accel = eigsol.qr_eigenvalues(M, eigsol.QROptions(
        mode="accelerated", tolerance=1e-12 if double else 1e-6, max_iterations=60 * n))
    parity = eigsol.qr_eigenvalues(M, eigsol.QROptions(mode="parity", max_iterations=5))
    torch.cuda.synchronize()
    assert [k.launches for k in qk.KERNELS] == [3, 1, 1, 1, 0, 0, 0]
    assert h.device.type == q.device.type == accel.eigenvalues.device.type == "cuda"
    assert accel.eigenvalues.dtype == (dtype if dtype.is_complex else dtype.to_complex())
    assert parity.eigenvalues.dtype == dtype
    assert not bool(parity.converged) and int(parity.iterations) == 6
    scale = float(a.abs().max())
    assert rel_to(q @ r, a, scale) <= qr_tol(dtype, n)
    assert bool(accel.converged)
    ev = np.linalg.eigvals(a.cpu().numpy().astype(np.complex128))
    limit = 1e-9 if double else 1e-4  # deflation at tol * |h_ii|, times conditioning
    assert matched_err(accel.eigenvalues.cpu().numpy(), ev) <= limit * scale


# --------------------------------------------------------------------------
# Blocked Hessenberg B11 (B12 on complex data) and eigenvectors B14
# --------------------------------------------------------------------------

def assert_same_reduction(a, h, q, hp, qp, units=1.0):
    """h, q against hp, qp with the diagonal unitary D divided out, plus the
    residuals and the exact zeros below the subdiagonal."""
    n = a.shape[0]
    dtype = a.dtype
    scale = float(a.abs().max())
    tol, phase_tol = qr_tol(dtype, n), PHASE_TOL[is_double(dtype)]
    eye = torch.eye(n, dtype=dtype, device=a.device)
    d = hessenberg_phases(h, hp)
    assert float((d - 1).abs().max()) <= phase_tol
    assert rel_to(h, d.conj()[:, None] * hp * d, scale) <= units * tol
    assert rel_to(q, qp * d, 1.0) <= units * tol
    assert rel_to(q @ h @ q.conj().T, a, scale) <= tol
    assert rel_to(q.conj().T @ q, eye, 1.0) <= tol
    if n > 2:
        assert float(torch.tril(h, -2).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n,nb", [(1, 32), (3, 32), (5, 32), (33, 32), (100, 7), (129, 64),
                                  (257, 32), (512, 32), (1030, 32)])
def test_blocked_hessenberg_kernel_matches_plain(cuda, n, nb, dtype):
    a = well_conditioned(n, dtype, seed=300 + n, device=cuda)
    before = hb.hessenberg_blocked_kernel.launches
    h, q = hb.hessenberg_blocked(a, accumulate_q=True, nb=nb)
    torch.cuda.synchronize()
    assert hb.hessenberg_blocked_kernel.launches == before + 1
    assert torch.equal(hb.hessenberg_blocked(a, nb=nb), h)
    hp, qp = hb.hessenberg_blocked_plain(a, accumulate_q=True, nb=nb)
    assert_same_reduction(a, h, q, hp, qp)
    if n <= 512:  # and the unblocked kernel B7
        h7, q7 = qk.hessenberg_kernel(a, accumulate_q=True)
        assert_same_reduction(a, h, q, h7, q7, units=3.0)


@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_blocked_hessenberg_kernel_skips_inside_a_panel(cuda, dtype):
    # A[6:, :6] = 0: columns 4 and 5 take the tail-zero skip (tau = 0) in
    # the middle of the first panel (nb = 8); the columns after them reflect
    a = well_conditioned(300, dtype, seed=7, device=cuda)
    a[6:, :6] = 0
    h, q = hb.hessenberg_blocked_kernel(a, accumulate_q=True, nb=8)
    torch.cuda.synchronize()
    assert float(h[6, 5].abs()) == 0.0 and float(h[7:, :6].abs().max()) == 0.0
    hp, qp = hb.hessenberg_blocked_plain(a, accumulate_q=True, nb=8)
    assert_same_reduction(a, h, q, hp, qp)


@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_blocked_hessenberg_kernel_is_deterministic(cuda, dtype):
    # no atomics: the same input gives the same bits, with Q and without
    a = dense(300, dtype, seed=9, device=cuda)
    h1, q1 = hb.hessenberg_blocked_kernel(a, accumulate_q=True)
    h2, q2 = hb.hessenberg_blocked_kernel(a, accumulate_q=True)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2) and torch.equal(q1, q2)
    assert torch.equal(hb.hessenberg_blocked_kernel(a), h1)


@pytest.mark.parametrize("accumulate_q", [False, True])
@pytest.mark.parametrize("n,nb", [(1, 32), (2, 32), (3, 32), (100, 7), (300, 32), (1030, 32)])
def test_blocked_hessenberg_device_launches(cuda, n, nb, accumulate_q):
    # three kernels a column; a panel's trailing update is eight GEMMs, two
    # of them split-K (two kernels each), and the zeroing; with Q three
    # GEMMs more, one split-K; Q starts as an identity kernel
    a = dense(n, torch.float32, seed=n, device=cuda)
    hb.hessenberg_blocked_kernel(a, accumulate_q=accumulate_q, nb=nb)
    torch.cuda.synchronize()
    columns = max(n - 2, 0)
    panels = -(-columns // nb)
    expected = int(accumulate_q) + 3 * columns + panels * (11 + 4 * int(accumulate_q))
    assert hb.hessenberg_blocked_kernel.device_launches == expected


def test_hessenberg_reduce_picks_the_blocked_kernel(cuda, monkeypatch):
    monkeypatch.setattr(hs, "HESSENBERG_BLOCKED_MIN_N", 64)
    for dt in (torch.float32, torch.complex64):
        counts = (qk.hessenberg_kernel.launches, hb.hessenberg_blocked_kernel.launches)
        qk.hessenberg_reduce(dense(63, dt, seed=1, device=cuda))
        assert (qk.hessenberg_kernel.launches, hb.hessenberg_blocked_kernel.launches) == \
            (counts[0] + 1, counts[1])
        qk.hessenberg_reduce(dense(64, dt, seed=1, device=cuda), accumulate_q=True)
        assert (qk.hessenberg_kernel.launches, hb.hessenberg_blocked_kernel.launches) == \
            (counts[0] + 1, counts[1] + 1)


B7_SIZES = [1, 2, 3, 31, 32, 33, 127, 129, 255, 512, 767, 1023]


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def q_phases(q, qp):
    """D with q = qp D, from the columns (q_j^H qp_j over |.|): the
    diagonal unitary that H and Q are unique up to, read where it is
    defined (the subdiagonals' phase ratios multiply their rounding along
    the n pivots)."""
    d = (qp.conj() * q).sum(dim=0)
    return d / d.abs()


def assert_matches_plain(a, h, q, hp, qp):
    """h and q against the plain version's with D divided out, to three
    units in single precision and one in double (every sum of the cluster
    kernel runs in another order than the plain version's, as B11's do
    against B7; 2.6 units measured in complex64 at n = 127 and 129); D near
    1; the residuals and the zeros below the subdiagonal to one unit."""
    n, dtype = a.shape[0], a.dtype
    scale, tol = float(a.abs().max()), qr_tol(dtype, n)
    units = 1.0 if is_double(dtype) else 3.0
    eye = torch.eye(n, dtype=dtype, device=a.device)
    d = q_phases(q, qp)
    assert float((d - 1).abs().max()) <= PHASE_TOL[is_double(dtype)]
    assert rel_to(h, d.conj()[:, None] * hp * d, scale) <= units * tol
    assert rel_to(q, qp * d, 1.0) <= units * tol
    assert rel_to(q @ h @ q.conj().T, a, scale) <= tol
    assert rel_to(q.conj().T @ q, eye, 1.0) <= tol
    if n > 2:
        assert float(torch.tril(h, -2).abs().max()) <= tol * scale


@pytest.mark.parametrize("accumulate_q", [False, True])
@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", B7_SIZES)
def test_cluster_hessenberg_kernel_matches_plain(cuda, n, dtype, accumulate_q):
    # sizes that do and do not divide over 16 blocks, on both sides of the
    # shared-memory capacity (H in shared memory to 912 rows in float32, 628
    # in float64 and complex64, 432 in complex128); D is read from Q, and the
    # H of a call without Q is the same H, bit for bit
    a = well_conditioned(n, dtype, seed=500 + n, device=cuda)
    out = qk.hessenberg_kernel(a, accumulate_q=accumulate_q)
    torch.cuda.synchronize()
    plan = qk.hessenberg_kernel.last_plan
    assert plan == qk.hessenberg_route(n, dtype, accumulate_q, a.device)
    assert plan.cluster in qk.HESSENBERG_CLUSTERS
    assert plan == qk.hessenberg_cluster_plan(n, dtype, accumulate_q, plan.cluster)
    h, q = qk.hessenberg_kernel(a, accumulate_q=True)
    assert torch.equal(out[0] if accumulate_q else out, h)
    hp, qp = qk.hessenberg_plain(a, accumulate_q=True)
    assert_matches_plain(a, h, q, hp, qp)


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [5, 40, 300])
def test_cluster_hessenberg_kernel_skips(cuda, n, dtype):
    # column 0 zero from its pivot down (the degenerate skip) and column 1
    # zero below its pivot (the tail-zero skip): both keep factor 0, so H
    # keeps those zeros exactly
    a = well_conditioned(n, dtype, seed=600 + n, device=cuda)
    a[1:, 0] = 0
    a[3:, 1] = 0
    h, q = qk.hessenberg_kernel(a, accumulate_q=True)
    torch.cuda.synchronize()
    assert float(h[1:, 0].abs().max()) == 0.0 and float(h[3:, 1].abs().max()) == 0.0
    hp, qp = qk.hessenberg_plain(a, accumulate_q=True)
    assert_matches_plain(a, h, q, hp, qp)


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [129, 512, 1023])
def test_cluster_hessenberg_kernel_is_one_deterministic_launch(cuda, n, dtype):
    # one device kernel a call (the copy of A and Q's identity included),
    # and no atomics: the same bits call after call
    a = dense(n, dtype, seed=n, device=cuda)
    h1, q1 = qk.hessenberg_kernel(a, accumulate_q=True)
    names = device_kernels(lambda: qk.hessenberg_kernel(a, accumulate_q=True))
    assert len(names) == 1 and "hessenberg_cluster_kernel" in names[0]
    assert len(device_kernels(lambda: qk.hessenberg_kernel(a))) == 1
    h2, q2 = qk.hessenberg_kernel(a, accumulate_q=True)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2) and torch.equal(q1, q2)


def test_cluster_hessenberg_capacity(cuda):
    # the card holds a cluster of 16 (or 8) blocks at the plan's shared
    # memory; beyond the budget it holds none and the route raises
    plan = qk.hessenberg_route(512, torch.float32, True, cuda)
    assert plan.h_smem and plan.q_smem and plan.width == -(-512 // plan.cluster)
    assert qk.hessenberg_route(512, torch.complex128, True, cuda).h_smem is False
    with pytest.raises(ValueError, match="no cluster"):
        qk.hessenberg_route(8000, torch.complex128, False, cuda)


def random_triangular(n, dtype, seed, device, repeated=False):
    """tests/test_trisolve.py's operands: a random upper triangle with the
    spectrum over [1, 3], or (repeated) a small one over a single eigenvalue."""
    rng = np.random.default_rng(seed)
    if repeated:
        T = np.triu(0.3 * rng.standard_normal((n, n)), 1) + 2.0 * np.eye(n)
    else:
        T = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        T = T + np.diag(np.linspace(1.0, 3.0, n))
    return torch.from_numpy(T.astype(np.complex128)).to(device=device, dtype=dtype)


def normalised(Y):
    return Y / (Y.abs().square().sum(0).sqrt().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,repeated", [(1, False), (5, False), (33, False), (130, False),
                                        (512, False), (150, True), (512, True)])
def test_triangular_eigenvectors_kernel_matches_plain(cuda, n, repeated, dtype):
    T = random_triangular(n, dtype, seed=n, device=cuda, repeated=repeated)
    eps = torch.finfo(dtype.to_real()).eps * max(float(T.abs().max()), 1.0)
    before = tv.triangular_eigenvectors_kernel.launches
    Y = tv.triangular_eigenvectors_device(T, eps)
    torch.cuda.synchronize()
    assert tv.triangular_eigenvectors_kernel.launches == before + 1
    Yp = tv.triangular_eigenvectors_plain(T, eps)
    assert bool(torch.isfinite(Y).all())
    assert float(torch.tril(Y, -1).abs().max()) == 0.0
    limit = 1e-10 if dtype == torch.complex128 else 1e-4
    assert float((normalised(Y) - normalised(Yp)).abs().max()) <= limit
    if not repeated:
        Yn = normalised(Y.to(torch.complex128))
        Tc = T.to(torch.complex128)
        assert float((Tc @ Yn - Yn * Tc.diagonal()[None, :]).abs().max()) <= 5e-3


B14_EDGES = [(blocks, offset, dtype) for dtype in (torch.complex64, torch.complex128)
             for blocks in (1, 2) for offset in (-1, 1)]


@pytest.mark.parametrize("blocks,offset,dtype", B14_EDGES)
def test_triangular_eigenvectors_kernel_at_block_edges(cuda, blocks, offset, dtype):
    # n = -+ 1 of whole blocks on the repeated eigenvalue: every pivot clamped
    # and the 1e18 rescale in every column; at + 1 one more block, whose
    # event counts enter the product of the block above
    assert _build.load().trisolve_block_rows(COMPLEX_CODES[dtype]) == tv.BLOCK_ROWS[dtype]
    n = blocks * tv.BLOCK_ROWS[dtype] + offset
    T = random_triangular(n, dtype, seed=n, device=cuda, repeated=True)
    eps = torch.finfo(dtype.to_real()).eps * max(float(T.abs().max()), 1.0)
    Y = tv.triangular_eigenvectors_kernel(T, eps)
    Yp = tv.triangular_eigenvectors_plain(T, eps)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Y).all()) and float(Y.abs().max()) > 1e15  # rescaled
    limit = 1e-10 if dtype == torch.complex128 else 1e-4
    assert float((normalised(Y) - normalised(Yp)).abs().max()) <= limit


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_triangular_eigenvectors_kernel_repeats_bitwise(cuda, dtype):
    # split depth in a fixed order, no atomics: the same bits call after call
    for T in (random_triangular(300, dtype, seed=3, device=cuda),
              random_triangular(300, dtype, seed=4, device=cuda, repeated=True)):
        eps = torch.finfo(dtype.to_real()).eps * max(float(T.abs().max()), 1.0)
        Y = tv.triangular_eigenvectors_kernel(T, eps)
        for _ in range(2):
            assert torch.equal(tv.triangular_eigenvectors_kernel(T, eps), Y)


def test_eigenvector_kernel_rejects_real_input(cuda):
    with pytest.raises(TypeError, match="unsupported dtype"):
        tv.triangular_eigenvectors_kernel(dense(8, torch.float32, seed=0, device=cuda), 1e-6)


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [24, 200])
def test_public_eigenpairs_on_the_card(cuda, n, dtype):
    # qr_eigenvalues(compute_vectors=True) on a CUDA tensor: B7 + B8 (B13
    # beyond UNBLOCKED_MAX_N) + B14
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    a = dense(n, dtype, seed=11, device=cuda)
    double = is_double(dtype)
    qk.reset_launch_counts()
    r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), eigsol.QROptions(
        mode="accelerated", compute_vectors=True, tolerance=1e-12 if double else 1e-6,
        max_iterations=60 * n))
    torch.cuda.synchronize()
    blocked = qe.qr_dispatch(n, a.device) == "cuda_blocked"
    assert [k.launches for k in qk.KERNELS] == [1, int(not blocked), 0, 0, 0, 1, int(blocked)]
    assert bool(r.converged)
    cdt = dtype if dtype.is_complex else dtype.to_complex()
    V, lam = r.eigenvectors, r.eigenvalues
    assert V.dtype == lam.dtype == cdt and V.device.type == "cuda" and V.shape == (n, n)
    ac = a.to(cdt)
    res = float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max())
    # ten units (1e-5 n, 1e-13 n) of ||A||_2: the Schur form is backward
    # stable, and the back-substitution's rounding grows with ||T|| / gap
    # (2.4 units measured in float64 at n = 24 on the H100)
    assert res <= 10 * qr_tol(dtype, n) * float(torch.linalg.matrix_norm(ac, 2))
    ev = np.linalg.eigvals(a.cpu().numpy().astype(np.complex128))
    assert matched_err(lam.cpu().numpy(), ev) <= (1e-9 if double else 1e-3) * float(a.abs().max())


# --------------------------------------------------------------------------
# Blocked shifted sweeps B13
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,block", [(2, 32), (5, 3), (31, 32), (33, 32), (65, 32), (100, 7),
                                     (129, 64), (512, 32)])
def test_blocked_sweeps_kernel_matches_plain(cuda, n, block, dtype):
    h = qk.hessenberg_plain(dense(n, dtype, seed=400 + n, device=cuda))
    scale = float(h.abs().max())
    tol = qr_tol(dtype, n)
    # a fixed budget with deflation off (n <= 2 converges at once, and
    # deflating at exact zero would race the rounding): the same iterates
    budget_tol = 0.0 if n > 2 else 1e-6
    before = qb.qr_eig_blocked_kernel.launches
    e, s, hi, t, q = qb.qr_eig_blocked_kernel(h, 6, budget_tol, accumulate_q=True, block=block)
    e_only, s_only, hi_only = qb.qr_eig_blocked_kernel(h, 6, budget_tol, block=block)
    torch.cuda.synchronize()
    assert qb.qr_eig_blocked_kernel.launches == before + 2
    ep, sp, hip, tp, qp = qb.qr_eig_blocked_plain(h, 6, budget_tol, accumulate_q=True,
                                                  block=block)
    assert (int(s), int(hi)) == (int(s_only), int(hi_only)) == (int(sp), int(hip))
    assert rel_to(t, tp, scale) <= 10 * tol and rel_to(q, qp, 1.0) <= 10 * tol
    assert rel_to(e_only, ep, scale) <= 10 * tol
    assert rel_to(q @ t @ q.conj().T, h, scale) <= tol
    # to convergence: the same spectrum as B8's test
    e, s, hi = qb.qr_eig_blocked_kernel(h, 60 * n, 1e-6 if dtype == torch.complex64 else 1e-12,
                                        block=block)
    assert int(hi) <= 1
    ev = np.linalg.eigvals(h.cpu().numpy().astype(np.complex128))
    limit = 1e-9 if dtype == torch.complex128 else 1e-3
    assert matched_err(e.cpu().numpy(), ev) <= limit * scale


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_blocked_sweeps_schedule_and_resumed_q(cuda, dtype):
    # a 3-shift schedule, resumed in Schur mode from a unitary q, at block
    # edges (65 = 2 * 32 + 1)
    n = 65
    h = qk.hessenberg_plain(dense(n, dtype, seed=7, device=cuda))
    q0, _ = torch.linalg.qr(dense(n, dtype, seed=8, device=cuda))
    shifts = torch.tensor([0.3 + 0.1j, -0.2, 0.5 - 0.4j], dtype=dtype, device=cuda)
    scale, tol = float(h.abs().max()), qr_tol(dtype, n)
    t, q, e, s, hi = qb.qr_eig_blocked_step_q(h, q0, 4, 0.0, shifts)
    tp, qp, ep, sp, hip = qb.qr_eig_blocked_step_q(h.cpu(), q0.cpu(), 4, 0.0, shifts.cpu())
    assert (int(s), int(hi)) == (int(sp), int(hip)) == (4, n)
    assert rel_to(t.cpu(), tp, scale) <= 10 * tol and rel_to(q.cpu(), qp, 1.0) <= 10 * tol
    assert rel_to(q @ t @ q.conj().T, q0 @ h @ q0.conj().T, scale) <= tol
    h1, e1, s1, _ = qb.qr_eig_blocked_step(h, 4, 0.0, shifts)
    assert rel_to(h1, t, scale) <= 10 * tol  # the same sweeps without Q


def test_accelerated_solves_take_the_blocked_sweeps_beyond_the_boundary(cuda, monkeypatch):
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    monkeypatch.setattr(qe, "UNBLOCKED_MAX_N", 16)
    for n, dtype in ((16, torch.float32), (40, torch.float32), (40, torch.complex128)):
        a = dense(n, dtype, seed=n, device=cuda)
        blocked = n > 16
        for vectors in (False, True):
            qk.reset_launch_counts()
            r = eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), eigsol.QROptions(
                mode="accelerated", compute_vectors=vectors, max_iterations=60 * n,
                tolerance=1e-12 if is_double(dtype) else 1e-6))
            torch.cuda.synchronize()
            assert [k.launches for k in qk.KERNELS] == \
                [1, int(not blocked), 0, 0, 0, int(vectors), int(blocked)]
            assert bool(r.converged)
            ev = np.linalg.eigvals(a.cpu().numpy().astype(np.complex128))
            limit = 1e-9 if is_double(dtype) else 1e-3
            assert matched_err(r.eigenvalues.cpu().numpy(), ev) <= limit * float(a.abs().max())
            if vectors:
                ac, V, lam = a.to(r.eigenvalues.dtype), r.eigenvectors, r.eigenvalues
                res = float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max())
                assert res <= 10 * qr_tol(dtype, n) * float(torch.linalg.matrix_norm(ac, 2))
        # parity mode stays on B10 beyond the boundary
        qk.reset_launch_counts()
        eigsol.qr_eigenvalues(eigsol.DenseMatrix(a), eigsol.QROptions(mode="parity",
                                                                      max_iterations=3))
        assert [k.launches for k in qk.KERNELS] == [1, 0, 0, 1, 0, 0, 0]


def test_blocked_sweeps_kernel_rejects_what_it_does_not_take(cuda):
    a = dense(8, torch.float32, seed=0, device=cuda)
    with pytest.raises(TypeError, match="unsupported dtype"):
        qb.qr_eig_blocked_kernel(a, 10, 1e-6)  # complex only, as B8
    c = a.to(torch.complex64)
    with pytest.raises(ValueError, match="q must match"):
        qb.qr_eig_blocked_kernel(c, 10, 1e-6, accumulate_q=True, q=c[:4, :4].contiguous())
    with pytest.raises(ValueError, match="shifts"):
        qb.qr_eig_blocked_kernel(c, 10, 1e-6, shifts=c[:2, :2].contiguous())
    # an empty schedule is no schedule: Wilkinson shifts (JAX n_shifts = 0)
    h = qk.hessenberg_kernel(c)
    e0, s0, hi0 = qb.qr_eig_blocked_kernel(h, 10, 0.0, shifts=c[:0, 0])
    e1, s1, hi1 = qb.qr_eig_blocked_kernel(h, 10, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(e0, e1) and int(s0) == int(s1) == 10 and int(hi0) == int(hi1)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_blocked_sweeps_kernel_repeats_bitwise(cuda, dtype):
    # every entry written by one thread in a fixed order: T, Q and the
    # eigenvalues repeat bit for bit, and do not depend on the grid's size
    h = qk.hessenberg_plain(dense(300, dtype, seed=31, device=cuda))
    cap, _ = qb.blocked_capacity(dtype, cuda, qb.BLOCK)
    for schur in (False, True):
        first = qb.qr_eig_blocked_kernel(h, 8, 0.0, accumulate_q=schur)
        for grid in (0, 0, 3, cap):  # the private hook sets the launch's size
            again = qb._sweeps_kernel(h, 8, 0.0, None, schur, None, qb.BLOCK, grid=grid)
            assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_blocked_sweeps_window_shrinks_inside_one_launch(cuda):
    # deflation on (complex128): hi shrinks sweep by sweep inside each
    # launch; the solve takes more sweeps than one launch runs, so a second
    # launch resumes where the first stopped; the sweep count and hi are the
    # plain version's
    dtype, n = torch.complex128, 150
    h = qk.hessenberg_plain(dense(n, dtype, seed=17, device=cuda))
    tol = 1e-12
    e, s, hi, t, q = qb.qr_eig_blocked_kernel(h, 60 * n, tol, accumulate_q=True, block=7)
    ep, sp, hip, tp, qp = qb.qr_eig_blocked_plain(h, 60 * n, tol, accumulate_q=True, block=7)
    assert int(hi) <= 1 and (int(s), int(hi)) == (int(sp), int(hip))
    assert int(s) > qb.SWEEPS_PER_LAUNCH
    assert qb.qr_eig_blocked_kernel.device_launches == -(-int(s) // qb.SWEEPS_PER_LAUNCH)
    scale = float(h.abs().max())
    ev = np.linalg.eigvals(h.cpu().numpy())
    assert matched_err(e.cpu().numpy(), ev) <= 1e-9 * scale
    assert rel_to(q @ t @ q.conj().T, h, scale) <= qr_tol(dtype, n)
    assert all(torch.equal(x, y) for x, y in zip(
        qb.qr_eig_blocked_kernel(h, 60 * n, tol, accumulate_q=True, block=7), (e, s, hi, t, q)))
    # part way, inside the first launch and inside the second: the same
    # window as the plain version
    for part in (int(s) // 3, qb.SWEEPS_PER_LAUNCH + 20):
        _, s5, hi5 = qb.qr_eig_blocked_kernel(h, part, tol, block=7)
        _, sp5, hip5 = qb.qr_eig_blocked_plain(h, part, tol, block=7)
        assert (int(s5), int(hi5)) == (int(sp5), int(hip5)) == (part, int(hip5))
        assert 1 < int(hi5) < n


def test_blocked_sweeps_one_device_kernel_a_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    h = qk.hessenberg_plain(dense(200, torch.complex64, seed=5, device=cuda))
    budget = 3 * qb.SWEEPS_PER_LAUNCH + 10  # deflation off: four launches
    for schur in (False, True):
        qb.qr_eig_blocked_kernel(h, budget, 0.0, accumulate_q=schur)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            qb.qr_eig_blocked_kernel(h, budget, 0.0, accumulate_q=schur)
            torch.cuda.synchronize()
        # every device activity the profiler recorded, as kineto gave them
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        sweeps = [x for x in names if "sweeps_kernel" in x]
        assert qb.qr_eig_blocked_kernel.device_launches == 4
        # the profiler drops some cooperative launches (3 of 4 recorded in one
        # run on the H100), never adds one: at most one B13 kernel a launch,
        # and besides them only copies of h and the state, the zeroed state
        # and Q's identity
        assert 1 <= len(sweeps) <= 4
        others = [x for x in names if "sweeps_kernel" not in x
                  and not any(w in x for w in ("Memcpy", "Memset", "elementwise", "eye"))]
        assert others == []


def test_blocked_sweeps_over_capacity_grid_raises(cuda):
    h = qk.hessenberg_plain(dense(100, torch.complex64, seed=6, device=cuda))
    for dtype, block in ((torch.complex64, 32), (torch.complex128, 64)):
        cap, sms = qb.blocked_capacity(dtype, cuda, block)
        assert cap >= sms >= 3
        with pytest.raises(RuntimeError, match="qr_eig_blocked_kernel: CUDA launch failed"):
            qb._sweeps_kernel(h.to(dtype), 4, 0.0, None, False, None, block, grid=cap + 1)
    for grid in (-1, 1, 2):  # a grid needs the chain, a slab and a right-pass block
        with pytest.raises(ValueError, match="grid"):
            qb._sweeps_kernel(h, 4, 0.0, None, False, None, qb.BLOCK, grid=grid)


# --------------------------------------------------------------------------
# Split-plane complex SpMV (B4, B3's planes entry) and block SpMM (B5)
# --------------------------------------------------------------------------

PLANES_CASES = [
    (20000, (-7, -2, 0, 3, 7)),
    (100_003, (-130, 0, 129)),            # ragged n, lane-seam offsets
    (1_000_000, tuple(range(-16, 17))),   # the 1M x 33 bench operator
]


def planes_band(n, offsets, dtype, seed, device):
    """(2, k, n) planes with zeros outside the matrix and (2, n) planes of
    the accumulation dtype."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(-1, 1, (2, len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    x = rng.uniform(-1, 1, (2, n))
    return (torch.from_numpy(planes).to(device=device, dtype=dtype),
            torch.from_numpy(x).to(device=device, dtype=ds.acc_dtype(dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("n,offsets", PLANES_CASES)
def test_planes_kernels_match_plain(cuda, n, offsets, dtype):
    planes, x = planes_band(n, offsets, dtype, seed=21, device=cuda)
    before = (ds.dia_planes_kernel.launches, ds.dia_il_planes_kernel.launches)
    y = ds.dia_matvec_planes(planes, offsets, x)
    R = ds.il_rows(n)
    planes_il = torch.stack([ds.interleave_dia_vals(p, R) for p in planes])
    x_il = torch.stack([ds.interleave_vec(v, R) for v in x])
    y_il = ds.dia_matvec_il_planes(planes_il, offsets, x_il)
    torch.cuda.synchronize()
    assert (ds.dia_planes_kernel.launches, ds.dia_il_planes_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    y_ref = ds.dia_matvec_planes_plain(planes, offsets, x)
    assert y.dtype == y_ref.dtype == ds.acc_dtype(dtype) and y.shape == (2, n)
    assert rel_err(y, y_ref) <= TOL[dtype]
    assert rel_err(y_il, ds.dia_matvec_il_planes_plain(planes_il, offsets, x_il)) <= TOL[dtype]
    y_il_nat = torch.stack([ds.deinterleave_vec(v, n) for v in y_il])
    assert rel_err(y_il_nat, y_ref) <= TOL[dtype]
    # the planes product is the complex product of B3
    if dtype != torch.bfloat16:
        cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
        yc = ds.dia_matvec(torch.complex(planes[0], planes[1]).to(cdt), offsets,
                           torch.complex(x[0], x[1]).to(cdt))
        assert rel_err(torch.complex(y[0], y[1]), yc) <= TOL[dtype]


# nvec 1, 3, 8 (one full chunk) and 13 (a ragged second chunk) in every
# dtype; the 1M operator in the wide dtypes at the path's nvec = 8 only
BLOCK_CASES = [(n, offsets, nvec, dtype)
               for n, offsets in PLANES_CASES for nvec in (1, 3, 8, 13)
               for dtype in (torch.float32, torch.bfloat16, torch.float64,
                             torch.complex64, torch.complex128)
               if n < 1_000_000 or nvec == 8 or dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("n,offsets,nvec,dtype", BLOCK_CASES)
def test_block_kernels_match_plain(cuda, n, offsets, nvec, dtype):
    rng = np.random.default_rng(nvec)
    vals, _ = band(n, offsets, dtype, seed=22, device=cuda)
    xs = rng.uniform(-1, 1, (nvec, n))
    if dtype.is_complex:
        xs = xs + 1j * rng.uniform(-1, 1, (nvec, n))
    xs = torch.from_numpy(xs).to(device=cuda, dtype=ds.acc_dtype(dtype))
    before = (ds.dia_block_kernel.launches, ds.dia_il_block_kernel.launches)
    ys = ds.dia_matmat(vals, offsets, xs)
    R = ds.il_rows(n)
    vals_il = ds.interleave_dia_vals(vals, R)
    xs_il = torch.stack([ds.interleave_vec(v, R) for v in xs])
    ys_il = ds.dia_matmat_il(vals_il, offsets, xs_il)
    torch.cuda.synchronize()
    assert (ds.dia_block_kernel.launches, ds.dia_il_block_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = ds.dia_matmat_plain(vals, offsets, xs)
    assert ys.dtype == ref.dtype == ds.acc_dtype(dtype) and ys.shape == (nvec, n)
    assert rel_err(ys, ref) <= TOL[dtype]
    assert rel_err(ys_il, ds.dia_matmat_il_plain(vals_il, offsets, xs_il)) <= TOL[dtype]
    # every vector of the block is the single-vector SpMV
    for v in range(nvec):
        assert rel_err(ys[v], ds.dia_matvec_plain(vals, offsets, xs[v])) <= TOL[dtype]


@pytest.mark.parametrize("nvec", [3, 8])
def test_block_window_kernel_with_halo_values(cuda, nvec):
    n, offsets = 100_003, (-9, 0, 3, 9)
    vals, _ = band(n, offsets, torch.float32, seed=23, device=cuda)
    R = ds.il_rows(n)
    pr = ds.il_window_halo(offsets)
    vals_il = ds.interleave_dia_vals(vals, R)
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = torch.rand((nvec, R + 2 * pr, ds.LANES), generator=gen, device=cuda) * 2 - 1
    ys = ds.dia_matmat_il_window(vals_il, offsets, w)
    assert rel_err(ys, ds.dia_matmat_il_window_plain(vals_il, offsets, w)) <= 1e-5


# B5's staged route at its edges: consecutive and non-consecutive offsets,
# a one-sided band on each side, ragged n (not a multiple of the rows a
# thread takes), chunks of 1, 7, 8, 9 and 17 vectors; and a row-major band
# whose span sends the tile past the shared memory (the direct route)
STAGED_BANDS = [(10_001, tuple(range(-16, 17))), (5003, (-9, -4, -3, 0, 5, 6, 7)),
                (4099, (0, 1, 2, 3, 11)), (3001, (-20, -19, -1)), (30_011, (-5000, 0, 4999))]
STAGED_CASES = [(n, offsets, nvec, dtype) for n, offsets in STAGED_BANDS
                for nvec in (1, 7, 8, 9, 17)
                for dtype in (torch.float32, torch.bfloat16, torch.float64, torch.complex64,
                              torch.complex128)]


@pytest.mark.parametrize("n,offsets,nvec,dtype", STAGED_CASES)
def test_block_kernels_staged_route(cuda, n, offsets, nvec, dtype):
    rng = np.random.default_rng(nvec + 100)
    vals, _ = band(n, offsets, dtype, seed=24, device=cuda)
    xs = rng.uniform(-1, 1, (nvec, n))
    if dtype.is_complex:
        xs = xs + 1j * rng.uniform(-1, 1, (nvec, n))
    acc = ds.acc_dtype(dtype)
    xs = torch.from_numpy(xs).to(device=cuda, dtype=acc)
    ref = ds.dia_matmat_plain(vals, offsets, xs)
    fits = {w: ds.block_stage_smem(w, offsets, dtype, nvec) <= ds.BLOCK_STAGED_SMEM
            for w in (False, True)}
    # both routes where the tile fits, on both row-major entries: the (nvec, n)
    # block and the (n, nvec) block, read and written by strides
    for route in ("staged", "direct") if fits[False] else ("direct",):
        ys = ds.dia_block_kernel(vals, offsets, xs, route=route)
        ys_cols = ds.dia_block_kernel(vals, offsets, xs.T.contiguous(), vectors_last=True,
                                      route=route)
        torch.cuda.synchronize()
        assert ds.dia_block_kernel.last_route == route
        assert ys.shape == (nvec, n) and ys_cols.shape == (n, nvec) and ys_cols.is_contiguous()
        assert rel_err(ys, ref) <= TOL[dtype]
        assert rel_err(ys_cols.T, ref) <= TOL[dtype]
    ds.dia_block_kernel(vals, offsets, xs.T.contiguous(), vectors_last=True)
    assert ds.dia_block_kernel.last_route == \
        ds.block_route(False, offsets, dtype, nvec, vectors_last=True)
    R = ds.il_rows(n)
    if ds.il_window_halo(offsets) <= R:  # the interleaved layout holds the band
        vals_il = ds.interleave_dia_vals(vals, R)
        xs_il = torch.stack([ds.interleave_vec(v, R) for v in xs])
        ref_il = ds.dia_matmat_il_plain(vals_il, offsets, xs_il)
        w = ds._il_window(xs_il, ds.il_window_halo(offsets))
        for route in ("staged", "direct") if fits[True] else ("direct",):
            ys_il = ds.dia_il_block_kernel(vals_il, offsets, w, route=route)
            torch.cuda.synchronize()
            assert ds.dia_il_block_kernel.last_route == route
            assert rel_err(ys_il, ref_il) <= TOL[dtype]
        ds.dia_matmat_il(vals_il, offsets, xs_il)
        assert ds.dia_il_block_kernel.last_route == ds.block_route(True, offsets, dtype, nvec)


def test_block_routes_at_the_bench_band(cuda):
    # the 1M x 33 band of the block solvers takes the staged route on their
    # (n, 8) block in every dtype, and interleaved with 4-byte vectors;
    # (-130, 0, 129) interleaved does not fit a tile
    band33 = tuple(range(-16, 17))
    for dt in (torch.float32, torch.bfloat16, torch.float64, torch.complex64, torch.complex128):
        assert ds.block_route(False, band33, dt, 8, vectors_last=True) == "staged"
        assert ds.block_route(True, band33, dt, 8) == \
            ("staged" if dt in (torch.float32, torch.bfloat16) else "direct")
    assert ds.block_route(True, (-130, 0, 129), torch.float32, 8) == "direct"


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("nvec", [1, 9, 17])
def test_block_window_kernel_with_halo_values_staged(cuda, nvec, dtype):
    # halo rows carrying values, as in test_block_window_kernel_with_halo_values,
    # on the staged route, and one chunk of 8 plus a ragged one
    n, offsets = 100_003, (-9, 0, 3, 9)
    vals, _ = band(n, offsets, dtype, seed=25, device=cuda)
    R = ds.il_rows(n)
    pr = ds.il_window_halo(offsets)
    vals_il = ds.interleave_dia_vals(vals, R)
    gen = torch.Generator(device=cuda).manual_seed(8)
    w = (torch.rand((nvec, R + 2 * pr, ds.LANES), generator=gen, device=cuda) * 2 - 1).to(dtype)
    ref = ds.dia_matmat_il_window_plain(vals_il, offsets, w)
    ys = ds.dia_il_block_kernel(vals_il, offsets, w, route="staged")
    assert ds.dia_il_block_kernel.last_route == "staged"
    assert rel_err(ys, ref) <= TOL[dtype]
    assert rel_err(ds.dia_matmat_il_window(vals_il, offsets, w), ref) <= TOL[dtype]


def test_new_kernels_reject_what_they_do_not_take(cuda):
    planes, x = planes_band(1000, (-1, 0, 1), torch.float32, seed=0, device=cuda)
    with pytest.raises(TypeError, match="planes must be real"):
        ds.dia_planes_kernel(planes.to(torch.complex64), (-1, 0, 1), x)
    with pytest.raises(TypeError, match="does not match"):
        ds.dia_planes_kernel(planes, (-1, 0, 1), x.double())
    with pytest.raises(ValueError, match="expected \\(2, k, n\\) planes"):
        ds.dia_planes_kernel(planes[0], (-1, 0, 1), x)
    vals, _ = band(1000, (-1, 0, 1), torch.float32, seed=0, device=cuda)
    xs = torch.zeros((4, 1000), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ds.dia_block_kernel(vals, (-1, 0, 1), xs.T.contiguous().T)
    with pytest.raises(ValueError, match="expected \\(k, n\\) diagonals"):
        ds.dia_block_kernel(vals, (-1, 0, 1), xs[:, :999].contiguous())
    with pytest.raises(ValueError, match="window shape"):
        ds.dia_il_block_kernel(ds.interleave_dia_vals(vals, 64), (-1, 0, 1),
                               torch.zeros((4, 64, ds.LANES), device=cuda))


def test_block_solvers_launch_the_block_kernels(cuda):
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full
    op = banded_full(20000, bandwidth=4, dtype=np.float32, seed=9, diag_boost=1.0, device=cuda)
    X0 = np.random.default_rng(2).uniform(-1, 1, (20000, 8))
    opts = eigsol.SolverOptions(max_iterations=30, tolerance=1e-7)
    ds.reset_launch_counts()
    r = eigsol.subspace_iteration(op, k=4, opts=opts, X0=X0)
    r_il = eigsol.subspace_iteration(op.interleaved(), k=4, opts=opts, X0=X0)
    torch.cuda.synchronize()
    assert ds.dia_block_kernel.launches > 0 and ds.dia_il_block_kernel.launches > 0
    cpu = eigsol.subspace_iteration(
        eigsol.SparseDIA(data=op.data.cpu(), offsets=op.offsets, shape=op.shape), k=4,
        opts=opts, X0=X0)
    for res in (r, r_il):
        assert int(res.iterations) == int(cpu.iterations)
        got, want = res.eigenvalues.cpu().numpy(), cpu.eigenvalues.numpy()
        assert matched_err(got, want) <= 1e-4 * np.abs(want).max()



# --------------------------------------------------------------------------
# General sparse SpMV (B6)
# --------------------------------------------------------------------------

# (value dtype of the pack, complex): f32, bf16 and f64 values, real and as
# the halves of complex pairs (c64, c64 with bf16 pairs, c128)
GELL_TYPES = [(torch.float32, False), (torch.bfloat16, False), (torch.float64, False),
              (torch.float32, True), (torch.bfloat16, True), (torch.float64, True)]


def gell_operands(rows, n_cols, vtype, is_complex, seed, device):
    """A pack with the given row lengths (uniform random columns) and an x of
    its vector dtype, from numpy."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(rows)
    r = np.repeat(np.arange(len(lengths)), lengths)
    c = rng.integers(0, n_cols, len(r))
    v = rng.uniform(-1, 1, len(r))
    x = rng.uniform(-1, 1, n_cols)
    if is_complex:
        v = v + 1j * rng.uniform(-1, 1, len(r))
        x = x + 1j * rng.uniform(-1, 1, n_cols)
    v = v.astype(np.complex128 if vtype == torch.float64 else np.complex64) if is_complex \
        else v.astype(np.float64 if vtype == torch.float64 else np.float32)
    pack = gs.pack_gell(r, c, v, (len(lengths), n_cols), device=device)
    pack = pack.with_values_dtype(vtype)
    return pack, torch.from_numpy(x).to(device=device, dtype=pack.vector_dtype)


def check_gell(pack, x):
    """Native (and, for a complex pack, planes) kernel against the plain
    version; one launch each."""
    before = [k.launches for k in gs.KERNELS]
    y = gs.gell_matvec(pack, x)
    torch.cuda.synchronize()
    ref = gs.gell_matvec_plain(pack, x)
    assert y.dtype == ref.dtype == pack.vector_dtype and y.shape == (pack.shape[0],)
    assert rel_err(y, ref) <= TOL[pack.vector_dtype]
    launched = [1, 0]
    if pack.is_complex:
        planes = torch.stack([x.real, x.imag])
        yp = gs.gell_matvec_planes(pack, planes)
        torch.cuda.synchronize()
        assert rel_err(yp, gs.gell_matvec_planes_plain(pack, planes)) <= TOL[pack.vector_dtype]
        assert rel_err(torch.complex(yp[0], yp[1]), y) <= TOL[pack.vector_dtype]
        launched = [1, 1]
    assert [k.launches - b for k, b in zip(gs.KERNELS, before)] == launched


@pytest.mark.parametrize("mean,group", [(1, 4), (6, 8), (33, 32), (200, 32)])
@pytest.mark.parametrize("vtype,is_complex", GELL_TYPES)
def test_gell_kernels_match_plain(cuda, vtype, is_complex, mean, group):
    n_rows = 400_000 // mean
    pack, x = gell_operands([mean] * n_rows, n_rows + 77, vtype, is_complex, seed=mean,
                            device=cuda)
    assert pack.group == group
    check_gell(pack, x)


@pytest.mark.parametrize("filler", [1, 6, 33])
@pytest.mark.parametrize("vtype,is_complex", [(torch.float32, False), (torch.float32, True),
                                              (torch.float64, True)])
def test_gell_kernels_on_rows_of_every_length(cuda, vtype, is_complex, filler):
    # rows of 0, 1, 31, 32, 33 and 5000 entries among rows of `filler`
    # entries, which set the group width (4, 8, 32)
    rows = [0, 1, 31, 32, 33, 5000] * 3 + [filler] * 20_000 + [0, 33, 5000]
    pack, x = gell_operands(rows, 3001, vtype, is_complex, seed=filler, device=cuda)
    check_gell(pack, x)


def test_gell_kernel_edge_cases(cuda):
    gs.reset_launch_counts()
    none = np.zeros(0, int)
    empty = gs.pack_gell(none, none, np.zeros(0, np.float32), (64, 64), device=cuda)
    y = gs.gell_matvec(empty, torch.ones(64, device=cuda))
    assert torch.equal(y, torch.zeros(64, device=cuda))
    no_rows = gs.pack_gell(none, none, np.zeros(0, np.complex64), (0, 5), device=cuda)
    assert gs.gell_matvec(no_rows, torch.ones(5, dtype=torch.complex64, device=cuda)).shape == (0,)
    assert [k.launches for k in gs.KERNELS] == [0, 0]  # no work, no launch
    # duplicates sum (tests/test_gell.py:62-73)
    dup = gs.pack_gell([3, 3, 3, 3, 7, 7], [5] * 6, np.float32([1, 2, 3, 4, 10, 20]), (10, 10),
                       device=cuda)
    x = torch.zeros(10, device=cuda)
    x[5] = 2.0
    y = gs.gell_matvec(dup, x)
    assert y[3].item() == 20.0 and y[7].item() == 60.0 and gs.gell_kernel.launches == 1
    # the 700 x 40000 rectangle (tests/test_gell.py:94-105)
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, 700, 15_000), rng.integers(0, 40_000, 15_000)
    for dt in (np.float32, np.complex128):
        v = rng.standard_normal(15_000).astype(dt)
        pack = gs.pack_gell(r, c, v, (700, 40_000), tile_rows=256, device=cuda)
        x = torch.from_numpy(rng.standard_normal(40_000)).to(cuda, pack.vector_dtype)
        check_gell(pack, x)


@pytest.mark.parametrize("n_cols", [1000, 40_003])
def test_gell_planes_kernel_reads_planes_apart(cuda, n_cols):
    pack, x = gell_operands([9] * 3000, n_cols, torch.float32, True, seed=3, device=cuda)
    buf = torch.zeros((2, n_cols + 77), device=cuda)
    buf[:, :n_cols] = torch.stack([x.real, x.imag])
    planes = buf[:, :n_cols]
    assert planes.stride(0) == n_cols + 77
    y = gs.gell_matvec_planes(pack, planes)
    assert rel_err(y, gs.gell_matvec_planes_plain(pack, planes.contiguous())) <= 1e-5


def test_gell_kernels_reject_what_they_do_not_take(cuda):
    pack, x = gell_operands([4] * 100, 100, torch.float32, False, seed=0, device=cuda)
    with pytest.raises(TypeError, match="does not match"):
        gs.gell_kernel(pack, x.double())
    with pytest.raises(ValueError, match="expected a CUDA device"):
        gs.gell_kernel(pack, x.cpu())
    with pytest.raises(ValueError, match=r"expected an \(100,\) vector"):
        gs.gell_kernel(pack, x[:99])
    with pytest.raises(ValueError, match="contiguous"):
        gs.gell_kernel(pack, torch.zeros(200, device=cuda)[::2])
    with pytest.raises(TypeError, match="not complex"):
        gs.gell_planes_kernel(pack, torch.zeros((2, 100), device=cuda))
    cpack, cx = gell_operands([4] * 100, 100, torch.float32, True, seed=0, device=cuda)
    with pytest.raises(TypeError, match="does not match"):
        gs.gell_kernel(cpack, cx.to(torch.complex128))
    with pytest.raises(TypeError, match="does not match"):
        gs.gell_planes_kernel(cpack, torch.zeros((2, 100), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="unit stride"):
        gs.gell_planes_kernel(cpack, torch.zeros((100, 2), device=cuda).T)


def test_gell_and_auto_paths_on_the_card(cuda):
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol
    rng = np.random.default_rng(4)
    n = 3000
    a_r, a_c = np.repeat(np.arange(n), 8), rng.integers(0, n, 8 * n)
    a_v = rng.standard_normal(8 * n) / np.sqrt(8)
    a_r, a_c = np.concatenate([a_r, [0, 1]]), np.concatenate([a_c, [0, 1]])
    a_v = np.concatenate([a_v, [9.0, 6.0]])
    x0 = rng.uniform(-1, 1, n)
    opts = eigsol.SolverOptions(max_iterations=500, tolerance=1e-10)
    gs.reset_launch_counts()
    for dt in (np.float64, np.complex128):
        m = eigsol.SparseGELL.from_coo(a_r, a_c, a_v.astype(dt), (n, n), device=cuda)
        cpu = eigsol.SparseGELL.from_coo(a_r, a_c, a_v.astype(dt), (n, n), device="cpu")
        r, rc = eigsol.power_method(m, opts, x0=x0), eigsol.power_method(cpu, opts, x0=x0)
        assert bool(r.converged) and int(r.iterations) == int(rc.iterations)
        assert abs(complex(r.eigenvalue) - complex(rc.eigenvalue)) <= 1e-10 * abs(
            complex(rc.eigenvalue))
    assert gs.gell_kernel.launches > 0
    # auto: a shuffled band becomes a permuted interleaved DIA on the card
    shuffle = rng.permutation(n)
    i = np.repeat(np.arange(n), 5)
    j = np.clip(i + np.tile(np.arange(-2, 3), n), 0, n - 1)
    m = eigsol.from_coo(shuffle[i], shuffle[j], np.float32(rng.standard_normal(5 * n)), (n, n),
                        device=cuda)
    assert isinstance(m, eigsol.PermutedOperator) and m.perm.is_cuda
    assert isinstance(m.inner, eigsol.InterleavedDIA) and m.inner.device.type == "cuda"
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, torch.float32)
    y = m.decode_vec(m.matvec(m.encode_vec(x)))
    dense = m.to_dense()
    assert rel_err(y, dense @ x) <= 1e-5


# --------------------------------------------------------------------------
# The blocked B9 (panels, compact-WY trailing updates, Q backward)
# --------------------------------------------------------------------------

def b9_checks(a, r, q, rp, qp, n, dtype):
    """R and Q against a plain version up to the pivot phases, and the
    residuals, with the limits of test_hessenberg_and_qr_kernels_match_plain."""
    scale = float(a.abs().max())
    eye = torch.eye(n, dtype=dtype, device=a.device)
    tol, phase_tol = qr_tol(dtype, n), PHASE_TOL[is_double(dtype)]
    d = unit_phase(r.diagonal()) / unit_phase(rp.diagonal())
    assert float((d - 1).abs().max()) <= phase_tol
    assert rel_to(r, d[:, None] * rp, scale) <= tol
    assert rel_to(q, qp * d.conj(), 1.0) <= tol
    assert rel_to(q @ r, a, scale) <= tol
    assert rel_to(q.conj().T @ q, eye, 1.0) <= tol


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 100, 512, 2048])
def test_blocked_qr_kernel_matches_plain(cuda, n, dtype):
    # c128 at 512 and f32/f64/c64/c128 at 2048: the panel does not fit in
    # shared memory and is read and written through L2
    a = well_conditioned(n, dtype, seed=500 + n, device=cuda)
    r, q = qk.qr_decompose_kernel(a)
    torch.cuda.synchronize()
    nb = qk.qr_panel_width(n, dtype)
    panels = -(-n // nb)
    # eye; a panel kernel, its Gram product and its WY factors a panel; two
    # products a panel for the trailing columns (none after the last) and
    # two for Q
    assert qk.qr_decompose_kernel.device_launches == 1 + 3 * panels + 2 * (panels - 1) + 2 * panels
    rp, qp = qk.qr_decompose_plain(a)
    b9_checks(a, r, q, rp, qp, n, dtype)
    assert float(torch.tril(r, -1).abs().max()) == 0  # exact zeros below the diagonal


@pytest.mark.parametrize("dtype", QR_DTYPES)
@pytest.mark.parametrize("nb", [8, 32, 64])
def test_blocked_qr_kernel_kmax_inside_a_panel(cuda, nb, dtype):
    n, kmax = 100, 45
    a = well_conditioned(n, dtype, seed=45, device=cuda)
    r, q = qk.qr_decompose_kernel(a, kmax=kmax, nb=nb)
    rp, qp = qk.qr_decompose_plain(a, kmax=kmax)
    torch.cuda.synchronize()
    scale, tol = float(a.abs().max()), qr_tol(dtype, n)
    d = unit_phase(r.diagonal()[:kmax]) / unit_phase(rp.diagonal()[:kmax])
    assert float((d - 1).abs().max()) <= PHASE_TOL[is_double(dtype)]
    # the first kmax rows and columns are unique up to D; Q's last columns
    # and R's trailing block up to a unitary of their own, so they are held
    # through the products
    assert rel_to(r[:kmax], d[:, None] * rp[:kmax], scale) <= tol
    assert rel_to(q[:, :kmax], qp[:, :kmax] * d.conj(), 1.0) <= tol
    assert rel_to(q @ r, a, scale) <= tol
    assert rel_to(q.conj().T @ q, torch.eye(n, dtype=dtype, device=cuda), 1.0) <= tol
    assert float(torch.tril(r[:, :kmax], -1).abs().max()) == 0
    assert rel_to(q[:, kmax:] @ r[kmax:, kmax:], qp[:, kmax:] @ rp[kmax:, kmax:], scale) <= tol


@pytest.mark.parametrize("dtype", QR_DTYPES)
def test_blocked_qr_kernel_exact_skips(cuda, dtype):
    # an upper-triangular input: every column takes the tail-zero skip, so R
    # is A and Q is I exactly; a zero column and a column zero from its pivot
    # down (the degenerate skip) inside a panel
    a = torch.triu(dense(70, dtype, seed=3, device=cuda))
    r, q = qk.qr_decompose_kernel(a, nb=32)
    torch.cuda.synchronize()
    assert torch.equal(r, a) and torch.equal(q, torch.eye(70, dtype=dtype, device=cuda))
    a = well_conditioned(70, dtype, seed=4, device=cuda)
    a[:, 40] = 0
    a[:, 0] = 0
    r, q = qk.qr_decompose_kernel(a, nb=32)
    rp, qp = qk.qr_decompose_plain(a)
    torch.cuda.synchronize()
    assert float(r[0, 0].abs()) == 0
    scale, tol = float(a.abs().max()), qr_tol(dtype, 70)
    assert rel_to(q @ r, a, scale) <= tol
    assert rel_to(q.conj().T @ q, torch.eye(70, dtype=dtype, device=cuda), 1.0) <= tol
    assert rel_to(r.abs(), rp.abs(), scale) <= tol


def test_blocked_qr_kernel_rejects_what_it_does_not_take(cuda):
    a = dense(8, torch.float32, seed=0, device=cuda)
    with pytest.raises(ValueError, match="panel width 65"):
        qk.qr_decompose_kernel(a, nb=65)
    with pytest.raises(ValueError, match="kmax 9"):
        qk.qr_decompose_kernel(a, kmax=9)


# --------------------------------------------------------------------------
# B6's windowed route (x windows staged in shared memory)
# --------------------------------------------------------------------------

def check_windows(pack, x, cluster, **shape):
    """The windowed route at `cluster`, native and (complex) on planes,
    against the CSR plain version; one launch of that route each."""
    pw = gs.with_windows(pack, cluster, **shape)
    before = dict(gs.ROUTE_LAUNCHES)
    y = gs.gell_kernel(pw, x, route="windows")
    torch.cuda.synchronize()
    tol = TOL[pack.vector_dtype]
    assert rel_err(y, gs.gell_matvec_plain(pack, x)) <= tol
    if pack.is_complex:
        planes = torch.stack([x.real, x.imag])
        yp = gs.gell_planes_kernel(pw, planes, route="windows")
        torch.cuda.synchronize()
        assert rel_err(yp, gs.gell_matvec_planes_plain(pack, planes)) <= tol
    assert gs.ROUTE_LAUNCHES["windows"] - before["windows"] == (2 if pack.is_complex else 1)
    assert gs.ROUTE_LAUNCHES["csr"] == before["csr"]
    return y


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("vtype,is_complex", GELL_TYPES)
def test_window_route_on_rows_of_every_length(cuda, vtype, is_complex, cluster):
    rows = [0, 1, 31, 32, 33, 5000] * 3 + [6] * 20_000 + [0, 33, 5000]
    pack, x = gell_operands(rows, 3001, vtype, is_complex, seed=cluster, device=cuda)
    check_windows(pack, x, cluster)  # the pack's own R and W
    check_windows(pack, x, cluster, rows=64, cols=128)  # many ranges and windows


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_window_route_edge_cases(cuda, cluster):
    rng = np.random.default_rng(cluster)
    # duplicates sum
    dup = gs.pack_gell([3, 3, 3, 3, 7, 7], [5] * 6, np.float32([1, 2, 3, 4, 10, 20]), (10, 10),
                       device=cuda)
    x = torch.zeros(10, device=cuda)
    x[5] = 2.0
    y = check_windows(dup, x, cluster)
    assert y[3].item() == 20.0 and y[7].item() == 60.0
    # the 700 x 40000 rectangle; columns past the last full window (1061 =
    # 8 windows of 128 and 37 columns, and 40000 = 2 of 16384 and 7232)
    for shape, nnz in (((700, 40_000), 15_000), ((200, 1061), 3000)):
        r, c = rng.integers(0, shape[0], nnz), rng.integers(0, shape[1], nnz)
        for dt in (np.float32, np.complex128):
            pack = gs.pack_gell(r, c, rng.standard_normal(nnz).astype(dt), shape, device=cuda)
            x = torch.from_numpy(rng.standard_normal(shape[1])).to(cuda, pack.vector_dtype)
            check_windows(pack, x, cluster)
            check_windows(pack, x, cluster, rows=64, cols=128)
    # one range touching one window and one touching every window
    r = np.concatenate([rng.integers(0, 64, 500), rng.integers(64, 128, 3000)])
    c = np.concatenate([rng.integers(256, 384, 500), np.arange(3000) % 1280])
    pack = gs.pack_gell(r, c, rng.standard_normal(3500).astype(np.float32), (128, 1280),
                        device=cuda)
    x = torch.from_numpy(rng.standard_normal(1280)).to(cuda, torch.float32)
    check_windows(pack, x, cluster, rows=64, cols=128)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("n_cols", [1000, 16_385, 40_003])
def test_window_route_reads_planes_apart(cuda, n_cols, cluster):
    # the im plane n_cols + 77 floats after the re plane: its windows start
    # off 16-byte alignment, so their edges go by plain loads
    pack, x = gell_operands([9] * 3000, n_cols, torch.float32, True, seed=3, device=cuda)
    buf = torch.zeros((2, n_cols + 77), device=cuda)
    buf[:, :n_cols] = torch.stack([x.real, x.imag])
    planes = buf[:, :n_cols]
    for shape in ({}, {"rows": 64, "cols": 128}):
        pw = gs.with_windows(pack, cluster, **shape)
        y = gs.gell_planes_kernel(pw, planes, route="windows")
        assert rel_err(y, gs.gell_matvec_planes_plain(pack, planes.contiguous())) <= 1e-5


def test_dispatch_picks_windows_at_1m_uniform_and_csr_when_wide(cuda):
    rng = np.random.default_rng(0)
    n = 1_000_000
    r = np.repeat(np.arange(n), 33)
    c = np.sort(rng.integers(0, n, (n, 33)), axis=1).reshape(-1)  # a sorted COO: no sort
    pack = gs.pack_gell(r, c, rng.standard_normal(33 * n).astype(np.float32), (n, n),
                        device=cuda)
    assert gs.pick_route(pack) == "windows" and pack.windows.cols == 16384
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, torch.float32)
    gs.reset_launch_counts()
    y = gs.gell_matvec(pack, x)
    torch.cuda.synchronize()
    assert gs.ROUTE_LAUNCHES == {"csr": 0, "windows": 1} and gs.gell_kernel.launches == 1
    assert rel_err(y, gs.gell_matvec_plain(pack, x)) <= 1e-5
    del pack
    wide = gs.pack_gell(np.arange(n), np.sort(rng.integers(0, 50_000_000, n)),
                        np.ones(n, np.float32), (n, 50_000_000), device=cuda)
    assert wide.windows is None and gs.pick_route(wide) == "csr"
    assert not gs.window_rule(wide, gs.window_layout(wide))
    x = torch.ones(50_000_000, device=cuda)
    gs.reset_launch_counts()
    y = gs.gell_matvec(wide, x)
    torch.cuda.synchronize()
    assert gs.ROUTE_LAUNCHES == {"csr": 1, "windows": 0}
    assert torch.equal(y, torch.ones(n, device=cuda))


def test_window_route_is_refused_without_a_layout(cuda):
    pack = gs.pack_gell([0], [1], np.float32([1.0]), (2, 2), device=cuda)
    assert pack.windows is None
    with pytest.raises(ValueError, match="no windowed layout"):
        gs.gell_kernel(pack, torch.ones(2, device=cuda), route="windows")
    with pytest.raises(ValueError, match="neither 'csr' nor 'windows'"):
        gs.gell_kernel(pack, torch.ones(2, device=cuda), route="ell")


def test_gell_launch_is_resolved_once_per_pack(cuda):
    # the route, the pack's checks and the C call's struct are built on the
    # first call of each entry and route, then reused; a replaced pack builds
    # its own
    pack, x = gell_operands([33] * 3000, 20_000, torch.float32, True, seed=5, device=cuda)
    planes = torch.stack([x.real, x.imag])
    y = gs.gell_kernel(pack, x)
    first = pack._launchers[(False, None)]
    assert first.route == gs.pick_route(pack)
    assert torch.equal(gs.gell_kernel(pack, x), y) and pack._launchers[(False, None)] is first
    yp = gs.gell_planes_kernel(pack, planes)
    assert pack._launchers[(True, None)].route == gs.pick_route(pack, planes=True)
    yc = gs.gell_kernel(pack, x, route="csr")
    assert pack._launchers[(False, "csr")].route == "csr" and len(pack._launchers) == 3
    pw = gs.with_windows(pack, 1, rows=64, cols=128)
    assert pw._launchers == {}
    yw = gs.gell_kernel(pw, x, route="windows")
    torch.cuda.synchronize()
    ref = gs.gell_matvec_plain(pack, x)
    for out in (y, yc, yw, torch.complex(yp[0], yp[1])):
        assert rel_err(out, ref) <= 1e-5
