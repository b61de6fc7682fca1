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
"""

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
