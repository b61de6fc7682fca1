"""The port's dense QR stack against the JAX package, on the CPU.

``to_hessenberg``, ``qr_decompose`` and ``qr_eigenvalues`` (both modes) run
on CPU tensors through the port and on the JAX package's CPU route (x64, as
tests/conftest.py sets it), in float32, float64, complex64 and complex128,
on the same numpy inputs. Mirrors the cases of tests/test_qr.py that apply.

Tolerances: ``H``, ``Q`` and ``R`` elementwise to 1e-12 * n relative to
max|A| in float64/complex128 and 5e-6 * n in float32/complex64 (the same
algorithm; a single entry of ``H`` moves by up to ~n * eps * ||A|| with the
summation order). Eigenvalues are matched by nearest neighbour (conjugate
pairs come out in either order); float64/complex128 agree to 1e-10 with
equal iteration counts and ``converged``; float32/complex64 to 1e-4, with
iteration counts that may differ where a deflation test falls on the f32
rounding level.

Eigenpairs (``compute_vectors=True``): the eigenvalues as above; each
eigenvector is unique up to a phase, so a port column is paired with the
JAX column of the nearest eigenvalue and its phase aligned before the
entries are compared: 1e-10 in float64/complex128 and 1e-4 in
float32/complex64 (measured up to 6.3e-15 and 1.1e-6: both sides run the
same algorithm, and the eigenvalue gaps of these small random matrices are
~0.1). Both are held to the backward-stable residual
``max_k ||A v_k - lambda_k v_k|| / ||A||``, 1e-12 resp. 1e-5 (measured up
to 2.7e-13 and 9.2e-7), and to unit columns.
"""

import os

import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.hessenberg import hessenberg_host

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def exact(dtype):
    return np.dtype(dtype) in (np.float64, np.complex128)


def random_matrix(n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.random((n, n))
    return a.astype(dtype)


def geometric_symmetric(n, ratio, dtype, seed):
    rng = np.random.default_rng(seed)
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Qo * ratio ** np.arange(n)) @ Qo.T).astype(dtype)


def both(a, dtype=None):
    dtype = dtype or a.dtype
    return (J.DenseMatrix.from_array(a, dtype=dtype),
            T.DenseMatrix.from_array(a, dtype=dtype, device="cpu"))


def spectrum_distance(got, expected):
    """Max distance under greedy nearest matching (conjugate-pair-order safe)."""
    got, expected = list(np.asarray(got)), list(np.asarray(expected))
    worst = 0.0
    for e in expected:
        j = int(np.argmin([abs(g - e) for g in got]))
        worst = max(worst, abs(got[j] - e))
        got.pop(j)
    return worst


def elementwise_tol(dtype, n):
    return (1e-12 if exact(dtype) else 5e-6) * max(n, 1)


def assert_same_solve(rj, rt, dtype, ftol=1e-4):
    ej, et = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert et.dtype == ej.dtype and et.shape == ej.shape
    assert bool(rt.converged) == bool(rj.converged)
    if exact(dtype):
        assert int(rt.iterations) == int(rj.iterations)
        assert spectrum_distance(et, ej) <= 1e-10
    else:
        assert spectrum_distance(et, ej) <= ftol


class TestOptions:
    @pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
    def test_messages(self, pkg):
        with pytest.raises(ValueError, match="unknown QR mode: 'fast'"):
            pkg.QROptions(mode="fast")
        with pytest.raises(ValueError, match="compute_vectors requires mode='accelerated'"):
            pkg.QROptions(mode="parity", compute_vectors=True)
        with pytest.raises(ValueError, match="max_iterations must be non-negative"):
            pkg.QROptions(max_iterations=-1)

    def test_same_fields_and_defaults(self):
        import dataclasses
        fj = {f.name: f.default for f in dataclasses.fields(J.QROptions)}
        ft = {f.name: f.default for f in dataclasses.fields(T.QROptions)}
        assert fj == ft


class TestHessenberg:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n", [1, 2, 7])
    def test_matches_jax(self, n, dtype):
        a = random_matrix(n, dtype, seed=n)
        Mj, Mt = both(a)
        hj, ht = np.asarray(J.to_hessenberg(Mj)), T.to_hessenberg(Mt).numpy()
        assert ht.dtype == hj.dtype
        assert np.abs(ht - hj).max() <= elementwise_tol(dtype, n) * np.abs(a).max()
        assert np.abs(np.tril(ht, -2)).max(initial=0) <= elementwise_tol(dtype, n)

    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_host_oracle_matches_jax(self, dtype):
        a = random_matrix(7, dtype, seed=2)
        from pcsc_eigenvalue_solver_project_tpu.solvers.hessenberg import hessenberg_host as jh
        np.testing.assert_array_equal(hessenberg_host(a), jh(a))
        _, Mt = both(a)
        np.testing.assert_allclose(T.to_hessenberg(Mt).numpy(), hessenberg_host(a), atol=1e-13)

    def test_spectrum_preserved(self):
        # qr_algorithms_test.cpp:94-136
        a = random_matrix(7, np.float64, seed=2)
        H = T.to_hessenberg(T.DenseMatrix.from_array(a, device="cpu")).numpy()
        assert spectrum_distance(np.linalg.eigvals(H), np.linalg.eigvals(a)) < 1e-8


class TestQRDecompose:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("shape", [(1, 1), (6, 6), (3, 2), (2, 3), (7, 4)])
    def test_matches_jax(self, shape, dtype):
        rng = np.random.default_rng(sum(shape))
        a = rng.random(shape)
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.random(shape)
        a = a.astype(dtype)
        Mj, Mt = both(a)
        (qj, rj), (qt, rt) = J.qr_decompose(Mj), T.qr_decompose(Mt)
        tol = elementwise_tol(dtype, max(shape)) * np.abs(a).max()
        assert qt.shape == (shape[0], shape[0]) and rt.shape == shape
        assert np.abs(qt.numpy() - np.asarray(qj)).max() <= tol
        assert np.abs(rt.numpy() - np.asarray(rj)).max() <= tol
        assert np.abs(qt.numpy() @ rt.numpy() - a).max() <= tol
        assert np.abs(qt.numpy().conj().T @ qt.numpy() - np.eye(shape[0])).max() <= tol


class TestQREigenvalues:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_parity_matches_jax(self, dtype):
        a = geometric_symmetric(6, 0.7, dtype, seed=1)
        Mj, Mt = both(a)
        opts = dict(mode="parity", tolerance=1e-7, max_iterations=2000)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert bool(rt.converged)
        assert_same_solve(rj, rt, dtype)
        assert spectrum_distance(rt.eigenvalues.numpy(), 0.7 ** np.arange(6)) <= 1e-5

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n,seed", [(8, 3), (12, 4)])
    def test_accelerated_matches_jax(self, n, seed, dtype):
        # real inputs carry conjugate pairs: the real Francis route on the CPU
        a = random_matrix(n, dtype, seed)
        Mj, Mt = both(a)
        opts = dict(mode="accelerated", tolerance=1e-12 if exact(dtype) else 1e-6,
                    max_iterations=3000)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert bool(rt.converged)
        assert_same_solve(rj, rt, dtype)
        oracle = np.linalg.eigvals(a.astype(np.complex128))
        assert spectrum_distance(rt.eigenvalues.numpy(), oracle) <= (1e-9 if exact(dtype) else 1e-4)

    @pytest.mark.parametrize("mode", ["parity", "accelerated"])
    def test_symmetric_2x2(self, mode):
        # qr_algorithms_test.cpp:237-333: eigenvalues {3, 1}, real and complex scalars
        for dtype in (np.float64, np.complex128):
            a = np.array([[2.0, 1.0], [1.0, 2.0]], dtype=dtype)
            Mj, Mt = both(a)
            rj = J.qr_eigenvalues(Mj, J.QROptions(mode=mode))
            rt = T.qr_eigenvalues(Mt, T.QROptions(mode=mode))
            np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy().real), [1.0, 3.0], atol=1e-8)
            assert_same_solve(rj, rt, dtype)
            assert 0 <= int(rt.iterations) <= 1000

    def test_complex_triangular(self):
        a = np.array([[1 + 3j, 3 + 5j, 1 + 4j], [0, 2 + 4j, 3 + 2j], [0, 0, 5 - 1j]])
        r = T.qr_eigenvalues(T.DenseMatrix.from_array(a, dtype=np.complex128, device="cpu"))
        assert spectrum_distance(r.eigenvalues.numpy(), [1 + 3j, 2 + 4j, 5 - 1j]) < 1e-8

    def test_nonconvergence_iteration_count(self):
        # real unshifted QR cannot converge on a rotation: max_iterations + 1
        th = 1.0
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        Mj, Mt = both(rot)
        rj = J.qr_eigenvalues(Mj, J.SolverOptions(max_iterations=20))
        rt = T.qr_eigenvalues(Mt, T.SolverOptions(max_iterations=20))
        assert not bool(rt.converged) and int(rt.iterations) == int(rj.iterations) == 21
        np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-12)

    @pytest.mark.parametrize("mode", ["parity", "accelerated"])
    def test_max_iterations_zero(self, mode):
        a = np.array([[2.0, 1.0, 0.5], [1.0, 2.0, 0.3], [0.2, 0.1, 1.0]])
        Mj, Mt = both(a)
        rj = J.qr_eigenvalues(Mj, J.QROptions(mode=mode, max_iterations=0))
        rt = T.qr_eigenvalues(Mt, T.QROptions(mode=mode, max_iterations=0))
        assert int(rt.iterations) == int(rj.iterations)
        assert bool(rt.converged) == bool(rj.converged) is False
        if mode == "parity":
            assert int(rt.iterations) == 1  # for-loop quirk: iter stays 0 -> 0+1

    @pytest.mark.parametrize("mode", ["parity", "accelerated"])
    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_zero_size(self, mode, dtype):
        # qr_eigenvalues.hpp:55-57: n == 0 -> empty, converged, 0 iterations
        Mj, Mt = both(np.zeros((0, 0), dtype))
        rj = J.qr_eigenvalues(Mj, J.QROptions(mode=mode))
        rt = T.qr_eigenvalues(Mt, T.QROptions(mode=mode))
        assert rt.eigenvalues.shape == (0,) and rt.eigenvalues.numpy().dtype == np.asarray(rj.eigenvalues).dtype
        assert bool(rt.converged) and int(rt.iterations) == 0

    @pytest.mark.parametrize("mode", ["parity", "accelerated"])
    def test_reference_data_a(self, mode):
        # the reference demo's dense matrix, complex128 (upper triangular)
        Mj = J.read_matrix_from_file(os.path.join(DATA, "A.txt"), dtype=np.complex128)
        Mt = T.read_matrix_from_file(os.path.join(DATA, "A.txt"), torch.complex128, device="cpu")
        opts = dict(mode=mode, tolerance=1e-10)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert_same_solve(rj, rt, np.complex128)
        oracle = np.linalg.eigvals(Mt.to_dense().numpy())
        assert spectrum_distance(rt.eigenvalues.numpy(), oracle) <= 1e-8
        hj, ht = np.asarray(J.to_hessenberg(Mj)), T.to_hessenberg(Mt).numpy()
        np.testing.assert_allclose(ht, hj, atol=1e-13)
        q, r = T.qr_decompose(Mt)
        assert np.abs(q.numpy() @ r.numpy() - Mt.to_dense().numpy()).max() <= 1e-13


class TestProbes:
    @pytest.mark.parametrize("fn,name", [(T.to_hessenberg, "to_hessenberg_dense"),
                                         (T.qr_eigenvalues, "qr_eigenvalues_dense")])
    def test_non_square(self, fn, name):
        # qr_algorithms_test.cpp:83-92, :335-348
        with pytest.raises(ValueError, match=f"{name}: A must be square"):
            fn(T.DenseMatrix.from_array(np.ones((2, 3)), device="cpu"))

    @pytest.mark.parametrize("fn,name", [(T.to_hessenberg, "to_hessenberg"),
                                         (T.qr_decompose, "qr_decompose"),
                                         (T.qr_eigenvalues, "qr_eigenvalues")])
    def test_sparse_rejected(self, fn, name):
        m = T.SparseCSR.from_coo([0], [0], [1.0], (2, 2), device="cpu")
        with pytest.raises(ValueError, match=f"{name}: only dense matrices are supported"):
            fn(m)

    @pytest.mark.parametrize("fn,name", [(T.to_hessenberg, "to_hessenberg"),
                                         (T.qr_decompose, "qr_decompose"),
                                         (T.qr_eigenvalues, "qr_eigenvalues")])
    def test_scalar_type_mismatch(self, fn, name):
        with pytest.raises(TypeError, match=f"{name}: scalar type mismatch"):
            fn(T.DenseMatrix.from_array(np.eye(2), device="cpu"), dtype=np.complex128)

    def test_reference_data_b_is_sparse(self):
        # data/B.txt is CSR: every QR entry point raises like the reference
        Mt = T.read_matrix_from_file(os.path.join(DATA, "B.txt"), torch.complex128, device="cpu")
        Mj = J.read_matrix_from_file(os.path.join(DATA, "B.txt"), dtype=np.complex128)
        for fn_j, fn_t in ((J.qr_eigenvalues, T.qr_eigenvalues),
                           (J.to_hessenberg, T.to_hessenberg),
                           (J.qr_decompose, T.qr_decompose)):
            with pytest.raises(ValueError) as ej:
                fn_j(Mj)
            with pytest.raises(ValueError) as et:
                fn_t(Mt)
            assert str(et.value) == str(ej.value)

    def test_empty_qr_decompose_raises(self):
        # qr_decompose.hpp:38-40
        with pytest.raises(ValueError, match="qr_decompose_dense: empty matrix"):
            T.qr_decompose(T.DenseMatrix.from_array(np.zeros((0, 0)), device="cpu"))


def eig_residual(a, lam, V):
    """max_k ||A v_k - lambda_k v_k|| / ||A||_2."""
    a = a.astype(np.complex128)
    R = a @ V.astype(np.complex128) - V * lam[None, :]
    return np.linalg.norm(R, axis=0).max() / np.linalg.norm(a, 2)


def aligned_vector_err(lam, V, lam_ref, V_ref):
    """Max entry difference after pairing each column with the reference
    column of the nearest eigenvalue and aligning its phase."""
    worst = 0.0
    for k in range(len(lam)):
        j = int(np.argmin(np.abs(lam_ref - lam[k])))
        v, w = V[:, k].astype(np.complex128), V_ref[:, j].astype(np.complex128)
        p = np.vdot(v, w)
        v = v * (p / abs(p) if abs(p) > 0 else 1.0)
        worst = max(worst, np.abs(v - w).max())
    return worst


class TestEigenpairs:
    """``qr_eigenvalues(compute_vectors=True)`` on CPU tensors against the
    JAX package's CPU route (``_qr_eigenvectors_xla``)."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n,seed", [(8, 3), (12, 4)])
    def test_matches_jax(self, n, seed, dtype):
        a = random_matrix(n, dtype, seed)
        Mj, Mt = both(a)
        opts = dict(mode="accelerated", compute_vectors=True,
                    tolerance=1e-12 if exact(dtype) else 1e-6, max_iterations=3000)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert bool(rt.converged)
        assert_same_solve(rj, rt, dtype)
        lam, V = rt.eigenvalues.numpy(), rt.eigenvectors.numpy()
        lam_j, V_j = np.asarray(rj.eigenvalues), np.asarray(rj.eigenvectors)
        assert V.dtype == V_j.dtype == lam.dtype and V.shape == (n, n)
        np.testing.assert_allclose(np.linalg.norm(V, axis=0), 1.0,
                                   atol=1e-12 if exact(dtype) else 1e-6)
        assert aligned_vector_err(lam, V, lam_j, V_j) <= (1e-10 if exact(dtype) else 1e-4)
        assert eig_residual(a, lam, V) <= (1e-12 if exact(dtype) else 1e-5)

    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_symmetric_geometric_spectrum(self, dtype):
        a = geometric_symmetric(10, 0.7, dtype, seed=5)
        Mj, Mt = both(a)
        opts = dict(mode="accelerated", compute_vectors=True, tolerance=1e-12)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert_same_solve(rj, rt, dtype)
        lam, V = rt.eigenvalues.numpy(), rt.eigenvectors.numpy()
        assert aligned_vector_err(lam, V, np.asarray(rj.eigenvalues),
                                  np.asarray(rj.eigenvectors)) <= 1e-10
        assert eig_residual(a, lam, V) <= 1e-12

    def test_reference_data_a(self):
        # upper triangular already: no sweep, eigenvectors by back-substitution
        Mj = J.read_matrix_from_file(os.path.join(DATA, "A.txt"), dtype=np.complex128)
        Mt = T.read_matrix_from_file(os.path.join(DATA, "A.txt"), torch.complex128, device="cpu")
        opts = dict(mode="accelerated", compute_vectors=True, tolerance=1e-10)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert_same_solve(rj, rt, np.complex128)
        np.testing.assert_allclose(rt.eigenvectors.numpy(), np.asarray(rj.eigenvectors), atol=1e-13)
        a = Mt.to_dense().numpy()
        assert eig_residual(a, rt.eigenvalues.numpy(), rt.eigenvectors.numpy()) <= 1e-13

    def test_budget_without_convergence(self):
        a = random_matrix(8, np.complex128, seed=6)
        Mj, Mt = both(a)
        opts = dict(mode="accelerated", compute_vectors=True, tolerance=1e-12, max_iterations=2)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert not bool(rt.converged) and not bool(rj.converged)
        assert int(rt.iterations) == int(rj.iterations) == 2
        np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-12)
        assert rt.eigenvectors.shape == (8, 8)

    def test_zero_size_has_no_vectors(self):
        Mj, Mt = both(np.zeros((0, 0), np.complex128))
        opts = dict(mode="accelerated", compute_vectors=True)
        rj, rt = J.qr_eigenvalues(Mj, J.QROptions(**opts)), T.qr_eigenvalues(Mt, T.QROptions(**opts))
        assert rt.eigenvalues.shape == (0,) and bool(rt.converged)
        assert rt.eigenvectors is None and rj.eigenvectors is None
