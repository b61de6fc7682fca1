"""The port's AED driver and shifted solves on the card, against their CPU
routes.

Every test here needs a CUDA device and skips without one. On a machine
with an H100 (no JAX needed there):

    python -m pytest --noconftest tests/test_torch_cuda_solvers.py -q

- AED (``ops/qr_aed.py``) at n = 1024 through ``qr_eigenvalues`` with
  ``AED_MIN_N`` at 1024 and eigenpairs with ``SCHUR_AED_MIN_N`` at 1024:
  eigenvalues within 1e-4 of the planted spectrum (phase 14's limit), AED
  rounds run, B7 or B8 and B13 launched; the Schur form ``H = Q T Q^H`` to
  one unit (1e-6 n) and the residual within 1e-6 n. One round on the card
  against the same round on the CPU (the plain versions) in complex128: the
  deflation count within one (a spike entry at the threshold may tip either
  way) and spectra within 1e-10.
- ``solve_shifted`` and ``shifted_inverse_power_method`` on ``SparseDIA``,
  ``InterleavedDIA``, ``SparseGELL`` and the split-plane operators, each
  against the same call on the CPU copy of the operator: solutions to 1e-8
  (float64) and eigenvalues to 1e-8 (float64) or 1e-5 (float32), and the
  SpMV kernel of the operator launched.
- C4: ``qr_eigenvalues`` (accelerated) on ``chip_smoke.py --aed-table``'s 4096
  uniform-[1, 2] draw runs the AED driver and is within 1e-4.
- Arnoldi, Krylov-Schur, Lanczos (values, eigenpairs, thick restart), LOBPCG
  and ``power_method_ds64`` on the card against their CPU routes (values to
  1e-4 / 1e-5 in float32, ds64 to 1e-12 with the same count), with the
  launches of the kernels their paths name (B1/B2/B6 a matvec, B8 or B13 a
  projection, B5, B2's float64 instance); the writer and the demo on the
  card.
- The distributed layer on an NCCL process group of one rank (a ``file://``
  store in the test's temporary directory) at 100,000 rows: the six
  distributed power paths at a budget against the single-device solver on
  the same operator and ``x0`` (1e-5 relative), B1 and B6 launched; the
  checkpointed distributed and single-device power methods stopped after a
  chunk and resumed, bit for bit equal to the uninterrupted runs; Arnoldi
  (B1, B8), block iteration (B5) and Lanczos against the single-device
  solvers (1e-4).
"""

import os

import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as gs
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as qk

pytestmark = pytest.mark.cuda

TOL = 3e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def planted(n, dtype, seed, device):
    """Q diag(uniform[1, 2]) Q^H (complex: with random phases) and its
    spectrum."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 2.0, n)
    g = rng.standard_normal((n, n))
    if dtype.is_complex:
        d = d * np.exp(1j * rng.uniform(0, 2 * np.pi, n))
        g = g + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(g)
    return torch.from_numpy((q * d) @ q.conj().T).to(device, dtype), d


def nearest_err(got, want):
    d = np.abs(np.asarray(got)[:, None] - np.asarray(want)[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_aed_eigenvalues_through_qr_eigenvalues(cuda, monkeypatch, dtype):
    n = 1024
    monkeypatch.setattr(qb, "AED_MIN_N", n)
    a, d = planted(n, dtype, 1, cuda)
    qk.reset_launch_counts()
    qr_aed.last_run.update(rounds=0, deflated=0)
    r = T.qr_eigenvalues(T.DenseMatrix(a), T.QROptions(mode="accelerated",
                                                       max_iterations=20 * n, tolerance=TOL))
    assert bool(r.converged)
    assert qr_aed.last_run["rounds"] > 0
    assert qk.qr_eig_blocked_kernel.launches > 0
    assert qk.hessenberg_kernel.launches + qk.qr_eig_kernel.launches > 0
    assert nearest_err(r.eigenvalues.cpu().numpy(), d) <= 1e-4


def test_aed_schur_mode_through_qr_eigenvalues(cuda, monkeypatch):
    n = 1024
    monkeypatch.setattr(qb, "SCHUR_AED_MIN_N", n)
    a, d = planted(n, torch.float32, 2, cuda)
    qr_aed.last_run.update(rounds=0, deflated=0)
    r = T.qr_eigenvalues(T.DenseMatrix(a), T.QROptions(
        mode="accelerated", compute_vectors=True, max_iterations=20 * n, tolerance=TOL))
    assert bool(r.converged) and qr_aed.last_run["rounds"] > 0
    lam, V = r.eigenvalues, r.eigenvectors
    assert nearest_err(lam.cpu().numpy(), d) <= 1e-4
    ac = a.to(lam.dtype)
    res = float((ac @ V - V * lam[None, :]).abs().square().sum(0).sqrt().max()) / \
        float(torch.linalg.matrix_norm(ac, 2))
    assert res <= 1e-6 * n
    # the Schur driver's invariant on the Hessenberg form
    h = qk.hessenberg_reduce(a).to(torch.complex64)
    eig, sweeps, hi, t, q = qr_aed.qr_eig_blocked_aed_schur(h, 20 * n, TOL)
    assert hi <= 1
    err = float((q @ t @ q.conj().T - h).abs().max()) / float(h.abs().max())
    assert err <= 1e-6 * n
    assert float((q.conj().T @ q - torch.eye(n, device=cuda)).abs().max()) <= 1e-6 * n


@pytest.mark.parametrize("w", [64, 136])
def test_aed_round_matches_the_cpu_route(cuda, w):
    # complex128: B8 (w = 64) or B13 (w = 136) for the window, B7 with Q,
    # against the plain versions on the CPU
    n = 300
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((n, n)) / np.sqrt(n)).to(cuda, torch.complex128)
    # a converged tail (B13 sweeps on the card), so that the round deflates;
    # the sweeps' rounding fill below the subdiagonal is masked off
    h = qb.qr_eig_blocked_step(torch.triu(qk.hessenberg_kernel(a), -1), 90, 1e-12)[0]
    h = torch.triu(h, -1).cpu()
    hc, dc, _, sc = qr_aed.aed_round(h, n, 1e-12, w)
    hg, dg, _, sg = qr_aed.aed_round(h.to(cuda), n, 1e-12, w)
    assert dc > 0 and abs(dg - dc) <= 1  # a spike entry at the threshold may tip either way
    ec = np.linalg.eigvals(hc.numpy())
    eg = np.linalg.eigvals(hg.cpu().numpy())
    assert nearest_err(eg, ec) <= 1e-10
    assert float(torch.tril(hg, -2).abs().max()) == 0.0


def planted_band(n, dtype, seed):
    """Seven uniform(-1, 1) diagonals with 14, 10, 8 planted on the first
    three diagonal entries (a real eigenvalue near 14, the next near 10),
    as numpy data (k, n) and offsets."""
    rng = np.random.default_rng(seed)
    offs = tuple(range(-3, 4))
    data = rng.uniform(-1, 1, (len(offs), n))
    data[3, :3] = (14.0, 10.0, 8.0)
    for k, off in enumerate(offs):
        if off > 0:
            data[k, n - off:] = 0
        elif off < 0:
            data[k, :-off] = 0
    return data.astype(dtype), offs


def operator(kind, data, offs, device):
    """The band as ``SparseDIA``, ``InterleavedDIA`` or ``SparseGELL`` on
    ``device``."""
    n = data.shape[1]
    dia = T.SparseDIA(data=torch.from_numpy(data).to(device), offsets=offs, shape=(n, n))
    if kind == "interleaved":
        return dia.interleaved()
    if kind == "gell":
        r, c = np.nonzero(dia.to_dense().cpu().numpy())
        v = dia.to_dense().cpu().numpy()[r, c]
        return T.SparseGELL.from_coo(r, c, v, (n, n), device=device)
    return dia


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("kind", ["dia", "gell"])
def test_solve_shifted_on_the_card(cuda, kind, method):
    n = 2000
    data, offs = planted_band(n, np.float64, 4)
    data[3] += 6.0  # diagonally dominant: the shifted system is well posed
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    b = np.random.default_rng(4).uniform(-1, 1, n)
    ds.reset_launch_counts()
    gs.reset_launch_counts()
    x_card = T.solve_shifted(card, 0.5, b, method=method, tol=1e-12)
    x_host = T.solve_shifted(host, 0.5, b, method=method, tol=1e-12)
    assert x_card.device.type == "cuda"
    np.testing.assert_allclose(x_card.cpu().numpy(), x_host.numpy(), rtol=1e-8, atol=1e-10)
    launched = gs.gell_kernel.launches if kind == "gell" else ds.dia_kernel.launches
    assert launched > 0


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("kind", ["dia", "interleaved", "gell"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inverse_power_on_the_card(cuda, kind, method, dtype):
    n = 2000
    data, offs = planted_band(n, dtype, 5)
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    tol = 1e-10 if dtype == np.float64 else 1e-5  # float32 cannot stop below its eps
    opts = T.ShiftedSolverOptions(shift=14.3, max_iterations=60, tolerance=tol,
                                  inner_method=method, inner_tolerance=tol,
                                  inner_max_iterations=200)
    x0 = np.random.default_rng(6).uniform(-1, 1, n)
    ds.reset_launch_counts()
    gs.reset_launch_counts()
    rc = T.shifted_inverse_power_method(card, opts, x0=x0)
    rh = T.shifted_inverse_power_method(host, opts, x0=x0)
    assert bool(rc.converged) and bool(rh.converged)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(complex(rc.eigenvalue), complex(rh.eigenvalue), rtol=rtol)
    assert abs(complex(rc.eigenvalue) - 14.0) < 1.0  # the planted eigenvalue
    assert rc.eigenvector.shape == (n,) and bool(torch.isfinite(rc.eigenvector).all())
    kernel = {"dia": ds.dia_kernel, "interleaved": ds.dia_il_kernel, "gell": gs.gell_kernel}[kind]
    assert kernel.launches > 0


@pytest.mark.parametrize("method", ["dense_lu", "bicgstab", "gmres"])
@pytest.mark.parametrize("interleaved", [False, True])
def test_split_inverse_power_on_the_card(cuda, method, interleaved):
    n = 600
    rng = np.random.default_rng(7)
    offs = (-3, -1, 0, 2)
    planes = 0.3 * rng.standard_normal((2, len(offs), n))
    planes[0, offs.index(0)] += 4.0 + rng.uniform(-2, 2, n)
    for k, off in enumerate(offs):
        if off > 0:
            planes[:, k, n - off:] = 0
        elif off < 0:
            planes[:, k, :-off] = 0
    host = T.SplitComplexDIA(planes=torch.from_numpy(planes), offsets=offs, shape=(n, n))
    card = T.SplitComplexDIA(planes=torch.from_numpy(planes).to(cuda), offsets=offs,
                             shape=(n, n))
    if interleaved:
        host, card = host.interleaved(), card.interleaved()
    ev = np.linalg.eigvals(host.to_complex_dense())
    shift = complex(ev[np.argmin(np.abs(ev - 4.0))] + 0.001 * (1 + 1j))
    opts = T.ShiftedSolverOptions(shift=shift, max_iterations=60, tolerance=1e-10,
                                  inner_method=method, inner_tolerance=1e-10,
                                  inner_max_iterations=300)
    x0 = rng.uniform(-1, 1, (2, n))
    ds.reset_launch_counts()
    rc = T.shifted_inverse_power_method(card, opts, x0=x0)
    rh = T.shifted_inverse_power_method(host, opts, x0=x0)
    assert bool(rc.converged) and bool(rh.converged)
    lc = complex(*rc.eigenvalue.cpu().numpy())
    np.testing.assert_allclose(lc, complex(*rh.eigenvalue.numpy()), rtol=1e-8)
    np.testing.assert_allclose(lc, ev[np.argmin(np.abs(ev - shift))], rtol=1e-8)
    if method != "dense_lu":
        kernel = ds.dia_il_planes_kernel if interleaved else ds.dia_planes_kernel
        assert kernel.launches > 0


# --------------------------------------------------------------------------
# C4: the public eigenvalues-only route at 4096 on the uniform-[1, 2] operand
# --------------------------------------------------------------------------

def aed_table_uniform_4096(device):
    """The uniform-[1, 2] float32 operand at n = 4096 that ``chip_smoke.py
    --aed-table`` draws from ``default_rng(191)`` (its twelfth operand after
    the 512 warm-up one; ``chip_smoke.py::aed_table_uniform``): the earlier
    draws are replayed, then ``U diag(d) U^T`` with U the Q of a standard
    normal matrix on the card. Returns (matrix, planted spectrum)."""
    rng = np.random.default_rng(191)
    rng.uniform(-1, 1, (512, 512))                      # the warm-up operand
    for n in (1024, 2048, 4096):
        rng.standard_normal((n, n))                     # bench
        rng.standard_normal((n, n))                     # c64: real, imaginary,
        rng.standard_normal((n, n))
        rng.uniform(0, 2 * np.pi, n)                    # and the phases
        rng.uniform(-1, 1, (n, n))                      # nonsym
        g = torch.from_numpy(rng.standard_normal((n, n))).to(device)
        d = np.sort(rng.uniform(1.0, 2.0, n))[::-1].copy()
        if n < 4096:
            continue
        u, _ = torch.linalg.qr(g)
        return ((u * torch.from_numpy(d).to(device)) @ u.T).to(torch.float32), d


def test_c4_uniform_4096_takes_aed_within_the_limit(cuda):
    """C4 closed: ``qr_eigenvalues`` (accelerated) on the draw where plain
    B13 misses 1e-4 runs the AED driver (``AED_MIN_N``) and is within it."""
    assert qb.AED_MIN_N is not None and qb.AED_MIN_N <= 4096
    a, d = aed_table_uniform_4096(cuda)
    qk.reset_launch_counts()
    qr_aed.last_run.clear()
    r = T.qr_eigenvalues(T.DenseMatrix(a), T.QROptions(mode="accelerated",
                                                       max_iterations=20 * 4096, tolerance=TOL))
    assert bool(r.converged)
    assert qr_aed.last_run.get("rounds", 0) > 0
    assert qk.qr_eig_blocked_kernel.launches > 0
    assert nearest_err(r.eigenvalues.cpu().numpy(), d) <= 1e-4


# --------------------------------------------------------------------------
# The Krylov and block solvers, power_method_ds64, the writer and the demo
# --------------------------------------------------------------------------

def symmetric_band(n, seed, boost=(8.0, 7.0, 6.5, 6.0), bw=3):
    """A symmetric band, uniform(-0.5, 0.5) entries, ``boost`` added to the
    head of the diagonal, as float32 numpy data (k, n) and offsets."""
    rng = np.random.default_rng(seed)
    offs = tuple(range(-bw, bw + 1))
    data = np.zeros((len(offs), n), np.float32)
    for k, off in enumerate(offs):
        if off < 0:
            continue
        v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        if off > 0:
            v[n - off:] = 0
            data[offs.index(-off), off:] = v[:n - off]
        data[k] = v
    data[bw, :len(boost)] += np.asarray(boost, np.float32)
    return data, offs


def spmv_kernel(kind):
    return {"dia": ds.dia_kernel, "interleaved": ds.dia_il_kernel, "gell": gs.gell_kernel}[kind]


def reset_all():
    ds.reset_launch_counts()
    gs.reset_launch_counts()
    qk.reset_launch_counts()


def close_sets(got, want, tol):
    assert nearest_err(np.asarray(got), np.asarray(want)) <= tol * np.abs(want).max()


@pytest.mark.parametrize("kind", ["dia", "interleaved"])
@pytest.mark.parametrize("m", [30, 150])
def test_arnoldi_on_the_card(cuda, kind, m):
    """The basis on B2/B1, the m x m projection on B8 (m = 30) or B13
    (m = 150, beyond ``UNBLOCKED_MAX_N``), against the CPU route."""
    n = 3000
    data, offs = planted_band(n, np.float32, 11)
    x0 = np.random.default_rng(11).uniform(-1, 1, n)
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    reset_all()
    rc = T.arnoldi_eigenvalues(card, k=3, m=m, x0=x0)
    rh = T.arnoldi_eigenvalues(host, k=3, m=m, x0=x0)
    assert rc.eigenvalues.device.type == "cuda" and bool(rc.converged)
    close_sets(rc.eigenvalues.cpu().numpy(), rh.eigenvalues.numpy(), 1e-4)
    assert spmv_kernel(kind).launches == m
    sweep_kernel = qk.qr_eig_kernel if m <= 128 else qk.qr_eig_blocked_kernel
    assert sweep_kernel.launches == 1


@pytest.mark.parametrize("kind", ["dia", "interleaved", "gell"])
def test_krylov_schur_on_the_card(cuda, kind):
    n = 3000
    data, offs = planted_band(n, np.float32, 12)
    x0 = np.random.default_rng(12).uniform(-1, 1, n)
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    opts = T.SolverOptions(tolerance=1e-6)
    reset_all()
    rc = T.krylov_schur_eigenvalues(card, k=3, opts=opts, x0=x0)
    rh = T.krylov_schur_eigenvalues(host, k=3, opts=opts, x0=x0)
    assert bool(rc.converged) and bool(rh.converged)
    close_sets(rc.eigenvalues.cpu().numpy(), rh.eigenvalues.numpy(), 1e-5)
    assert spmv_kernel(kind).launches == int(rc.iterations)


@pytest.mark.parametrize("kind", ["dia", "interleaved"])
def test_lanczos_family_on_the_card(cuda, kind):
    n = 3000
    data, offs = symmetric_band(n, 13)
    x0 = np.random.default_rng(13).uniform(-1, 1, n)
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    opts = T.SolverOptions(tolerance=1e-5)
    for which in ("LM", "LA"):
        reset_all()
        rc = T.lanczos_eigenvalues(card, k=4, which=which, opts=opts, x0=x0)
        rh = T.lanczos_eigenvalues(host, k=4, which=which, opts=opts, x0=x0)
        np.testing.assert_allclose(rc.eigenvalues.cpu().numpy(), rh.eigenvalues.numpy(),
                                   rtol=1e-5)
        assert spmv_kernel(kind).launches == int(rc.iterations)
    res, Y = T.lanczos_eigenpairs(card, k=4, which="LA", opts=opts, x0=x0)
    assert Y.device.type == "cuda" and Y.shape == (n, 4)
    A = host.to_dense().double()
    for i in range(4):
        y = Y[:, i].cpu().double()
        assert float(torch.linalg.vector_norm(A @ y - float(res.eigenvalues[i]) * y)) <= 1e-4
    rc = T.lanczos_thick_restart(card, k=4, opts=opts, x0=x0)
    rh = T.lanczos_thick_restart(host, k=4, opts=opts, x0=x0)
    assert bool(rc.converged) and bool(rh.converged)
    np.testing.assert_allclose(rc.eigenvalues.cpu().numpy(), rh.eigenvalues.numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind", ["dia", "interleaved"])
def test_lobpcg_on_the_card(cuda, kind):
    """The block apply on B5 (row-major on the (n, b) block, interleaved on
    its rows), the small eigh/qr on the card."""
    n = 3000
    data, offs = symmetric_band(n, 14)
    X0 = np.random.default_rng(14).standard_normal((n, 4))
    card, host = operator(kind, data, offs, cuda), operator(kind, data, offs, "cpu")
    opts = T.SolverOptions(max_iterations=60, tolerance=1e-4)
    reset_all()
    rc = T.lobpcg_eigenvalues(card, k=4, which="LA", opts=opts, X0=X0)
    rh = T.lobpcg_eigenvalues(host, k=4, which="LA", opts=opts, X0=X0)
    np.testing.assert_allclose(rc.eigenvalues.cpu().numpy(), rh.eigenvalues.numpy(), rtol=1e-4)
    block = ds.dia_il_block_kernel if kind == "interleaved" else ds.dia_block_kernel
    assert block.launches > 0
    assert ds.dia_kernel.launches == 0 and ds.dia_il_kernel.launches == 0


def test_power_method_ds64_on_the_card(cuda):
    """B2's float64 instance against the CPU route: within 1e-12, the same
    count."""
    n = 20000
    data, offs = planted_band(n, np.float32, 15)
    x0 = np.random.default_rng(15).uniform(-1, 1, n)
    opts = T.SolverOptions(max_iterations=400, tolerance=1e-12)
    card = T.SparseDIA(data=torch.from_numpy(data).to(cuda), offsets=offs, shape=(n, n))
    host = T.SparseDIA(data=torch.from_numpy(data), offsets=offs, shape=(n, n))
    reset_all()
    rc = T.power_method_ds64(card, opts, x0=x0)
    rh = T.power_method_ds64(host, opts, x0=x0)
    assert ds.dia_kernel.launches > 0
    assert abs(rc.eigenvalue - rh.eigenvalue) <= 1e-12 * abs(rh.eigenvalue)
    assert int(rc.iterations) == int(rh.iterations) and bool(rc.converged) == bool(rh.converged)
    np.testing.assert_allclose(rc.eigenvector, rh.eigenvector, atol=1e-10)


def test_writer_from_the_card(cuda, tmp_path):
    rng = np.random.default_rng(16)
    a = rng.standard_normal((40, 30)) + 1j * rng.standard_normal((40, 30))
    for m in (T.DenseMatrix.from_array(a, device=cuda),
              T.SparseCSR.from_dense(a * (rng.random((40, 30)) < 0.2), device=cuda)):
        p = str(tmp_path / "m.txt")
        T.write_matrix_to_file(p, m)
        back = T.read_matrix_from_file(p, np.complex128, device=cuda)
        assert torch.equal(back.to_dense(), m.to_dense())


def test_demo_on_the_card(cuda, capsys):
    from pcsc_eigenvalue_solver_project_tpu_torch import demo
    assert demo.main(["--data-dir", "data"]) == 0
    out = capsys.readouterr().out
    assert "qr_eigenvalues(A): [(1+3i), (2+4i), (5-1i)]" in out
    assert "raised as expected" in out


# --------------------------------------------------------------------------
# The distributed layer on an NCCL process group of one rank (one card hosts
# one NCCL rank; more ranks run on gloo CPU ranks in tests/test_torch_parallel*.py)
# --------------------------------------------------------------------------

DIST_N = 100_000


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import mesh as pm
    store = tmp_path_factory.mktemp("nccl") / "store"
    pm.initialize_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        yield pm.make_row_mesh(1)
    finally:
        dist.destroy_process_group()


def band_ell(data, offs):
    """The band (k, n) as a CPU ``SparseELL`` (entries outside the matrix 0)."""
    k, n = data.shape
    cols = np.arange(n)[:, None] + np.asarray(offs)[None, :]
    inside = (cols >= 0) & (cols < n)
    return T.SparseELL(data=torch.from_numpy(np.ascontiguousarray(data.T)),
                       indices=torch.from_numpy(np.where(inside, cols, 0).astype(np.int32)),
                       shape=(n, n))


@pytest.mark.parametrize("kind", ["interleaved", "dia", "ell", "splitc", "gell", "pruned"])
def test_distributed_power_paths_on_the_card(nccl_mesh, kind):
    from pcsc_eigenvalue_solver_project_tpu_torch.ops.split_complex import from_planes
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell as pg
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import gell_pruned as pp
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import split_complex as psc
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.power import distributed_power_method
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.sharded import partition_ell

    mesh, dev = nccl_mesh, nccl_mesh.device
    data, offs = planted_band(DIST_N, np.float32, 30)
    dia = T.SparseDIA(data=torch.from_numpy(data).to(dev), offsets=offs, shape=(DIST_N,) * 2)
    budget = T.SolverOptions(max_iterations=100, tolerance=0.0)
    x0 = np.random.default_rng(31).uniform(-1, 1, DIST_N)
    reset_all()
    if kind == "splitc":
        cdata = (data + 1j * np.roll(data, 1, axis=1)).astype(np.complex64)
        sc = T.SplitComplexDIA.from_complex_dia(T.SparseDIA(
            data=torch.from_numpy(cdata).to(dev), offsets=offs, shape=(DIST_N,) * 2))
        x0 = np.stack([x0, x0[::-1]])
        r = psc.distributed_splitc_power_method(psc.partition_splitc_dia(sc, mesh), mesh,
                                                budget, x0=x0)
        ref = T.power_method(sc, budget, x0=x0)
        lam, lam_ref = complex(from_planes(r.eigenvalue)), complex(from_planes(ref.eigenvalue))
    else:
        if kind in ("gell", "pruned"):
            rows = np.repeat(np.arange(DIST_N), len(offs))
            cols = rows + np.tile(offs, DIST_N)
            keep = (cols >= 0) & (cols < DIST_N)
            coo = (rows[keep], cols[keep], data.T.reshape(-1)[keep], (DIST_N, DIST_N))
            csr = T.SparseCSR.from_coo(*coo, device="cpu")
            part = (pg.partition_gell if kind == "gell" else pp.partition_gell_pruned)(csr, mesh)
            r = (pg.distributed_gell_power_method if kind == "gell"
                 else pp.distributed_gell_power_pruned)(part, mesh, budget, x0=x0)
            ref = T.power_method(T.SparseGELL.from_coo(*coo, device=dev), budget, x0=x0)
            assert gs.gell_kernel.launches > 0
        elif kind == "interleaved":
            r = pd.distributed_dia_il_power_method(pd.partition_dia_il(dia, mesh), mesh, budget,
                                                   x0=x0)
            ref = T.power_method(dia.interleaved(), budget, x0=x0)
            assert ds.dia_il_kernel.launches > 0
        elif kind == "dia":
            r = pd.distributed_dia_power_method(pd.partition_dia(dia, mesh), mesh, budget,
                                                x0=x0)
            ref = T.power_method(dia, budget, x0=x0)
        else:
            r = distributed_power_method(partition_ell(band_ell(data, offs), mesh), mesh,
                                         budget, x0=x0)
            ref = T.power_method(dia, budget, x0=x0)
        lam, lam_ref = complex(r.eigenvalue), complex(ref.eigenvalue)
    assert r.eigenvector.device.type == "cuda"
    assert abs(lam - lam_ref) <= 1e-5 * abs(lam_ref)


def test_distributed_checkpoint_resume_on_the_card(nccl_mesh, tmp_path):
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.utils.checkpoint import (
        distributed_dia_il_power_checkpointed, power_method_checkpointed)

    mesh, dev = nccl_mesh, nccl_mesh.device
    data, offs = planted_band(DIST_N, np.float32, 32)
    dia = T.SparseDIA(data=torch.from_numpy(data).to(dev), offsets=offs, shape=(DIST_N,) * 2)
    A = pd.partition_dia_il(dia, mesh)
    x0 = np.random.default_rng(33).uniform(-1, 1, DIST_N)
    budget = T.SolverOptions(max_iterations=120, tolerance=0.0)
    stop = T.SolverOptions(max_iterations=20, tolerance=0.0)
    plain = pd.distributed_dia_il_power_method(A, mesh, budget, x0=x0)
    for run in (lambda o, d: distributed_dia_il_power_checkpointed(A, mesh, o, checkpoint_dir=d,
                                                                   chunk=10, x0=x0),
                lambda o, d: power_method_checkpointed(dia, o, checkpoint_dir=d, chunk=10,
                                                       x0=x0)):
        whole = run(budget, str(tmp_path / "whole"))
        run(stop, str(tmp_path / "split"))
        resumed = run(budget, str(tmp_path / "split"))
        assert torch.equal(whole.eigenvector, resumed.eigenvector)
        assert torch.equal(whole.eigenvalue, resumed.eigenvalue)
        assert int(whole.iterations) == int(resumed.iterations) > 20
        for d in ("whole", "split"):
            for f in os.listdir(tmp_path / d):
                os.remove(tmp_path / d / f)
    assert torch.equal(whole.eigenvalue.cpu(), torch.as_tensor(
        T.power_method(dia, budget, x0=x0).eigenvalue).cpu())
    assert torch.isfinite(plain.eigenvector).all()


def test_distributed_krylov_on_the_card(nccl_mesh):
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel import dia as pd
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.arnoldi import (
        distributed_arnoldi_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.lanczos import (
        distributed_lanczos_eigenvalues)
    from pcsc_eigenvalue_solver_project_tpu_torch.parallel.subspace import (
        distributed_subspace_iteration)

    mesh, dev = nccl_mesh, nccl_mesh.device
    data, offs = planted_band(DIST_N, np.float32, 34)
    dia = T.SparseDIA(data=torch.from_numpy(data).to(dev), offsets=offs, shape=(DIST_N,) * 2)
    x0 = np.random.default_rng(35).uniform(-1, 1, DIST_N)
    reset_all()
    arn = distributed_arnoldi_eigenvalues(pd.partition_dia_il(dia, mesh), mesh, k=3, m=30,
                                          x0=x0)
    assert qk.qr_eig_kernel.launches > 0 and ds.dia_il_kernel.launches > 0
    close_sets(arn.eigenvalues.cpu().numpy(),
               T.arnoldi_eigenvalues(dia, k=3, m=30, x0=x0).eigenvalues.cpu().numpy(), 1e-4)
    sub = distributed_subspace_iteration(pd.partition_dia_il(dia, mesh), mesh, k=2,
                                         opts=T.SolverOptions(max_iterations=300,
                                                              tolerance=1e-6))
    assert ds.dia_il_block_kernel.launches > 0 and bool(sub.converged)
    close_sets(np.abs(sub.eigenvalues.cpu().numpy()), np.abs(arn.eigenvalues.cpu().numpy())[:2],
               1e-4)
    sdata, soffs = symmetric_band(DIST_N, 36)
    sym = T.SparseDIA(data=torch.from_numpy(sdata).to(dev), offsets=soffs, shape=(DIST_N,) * 2)
    lz = distributed_lanczos_eigenvalues(pd.partition_dia_il(sym, mesh), mesh, k=3, m=40,
                                         which="LA", x0=x0)
    close_sets(lz.eigenvalues.cpu().numpy(), T.lanczos_eigenvalues(
        sym, k=3, m=40, which="LA", x0=x0).eigenvalues.cpu().numpy(), 1e-4)
