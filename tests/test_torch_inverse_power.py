"""The shifted solves of the PyTorch port against the JAX package, on the CPU.

``solve_shifted``, ``shifted_inverse_power_method`` (dense LU, BiCGStab and
GMRES inner solves, the split-plane paths), ``rayleigh_quotient_iteration``,
the generic Krylov solvers of ``parallel/krylov.py`` and the split-plane
solvers of ``ops/split_krylov.py``, on the cases of
``tests/test_inverse_power.py``, ``tests/test_solve_shifted.py`` and
``tests/test_gmres.py``. Both sides get the same numpy inputs and the same
explicit start vector x0. Tolerances:

- eigenvalues to the JAX tests' own (rtol 1e-8 on the planted cases, 1e-6
  on the interior one, 1e-10 for Rayleigh-quotient iteration, 1e-5 for the
  banded Krylov cases), and to JAX's value at rtol 1e-10 (1e-6 where an
  inner Krylov solve's summation order enters);
- iteration counts equal in float64 and complex128 on the dense-LU paths
  (the inner Krylov solves sum in another order than XLA);
- linear solves to the JAX tests' rtol (1e-12 dense LU, 1e-6 to 1e-7
  Krylov) and to JAX's solution at the same.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu.matrix.split_complex import SplitComplexDIA as JSplit
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full as j_banded_full
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random as j_banded_random
from pcsc_eigenvalue_solver_project_tpu.ops import split_krylov as jsk
from pcsc_eigenvalue_solver_project_tpu.parallel import krylov as jkr
from pcsc_eigenvalue_solver_project_tpu.solvers.arnoldi import \
    arnoldi_decomposition as j_arnoldi
from pcsc_eigenvalue_solver_project_tpu_torch.core import options as topts
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full as t_banded_full
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import \
    banded_random as t_banded_random
from pcsc_eigenvalue_solver_project_tpu_torch.ops import split_krylov as tsk
from pcsc_eigenvalue_solver_project_tpu_torch.parallel import krylov as tkr
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import inverse_power as tip
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.arnoldi import \
    arnoldi_decomposition as t_arnoldi
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import norm as t_norm
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import vdot as t_vdot
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def to_port(m):
    """The JAX operator's leaves as the port's operator on the CPU."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def dense_pair(a, dtype=None):
    return (J.DenseMatrix.from_array(a, dtype=dtype),
            T.DenseMatrix.from_array(a, dtype=dtype, device="cpu"))


def start(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-1, 1, n)
    return x.astype(dtype)


def run_both(jm, tm, opts_kw, x0, rqi=False):
    jf = J.rayleigh_quotient_iteration if rqi else J.shifted_inverse_power_method
    tf = T.rayleigh_quotient_iteration if rqi else T.shifted_inverse_power_method
    rj = jf(jm, J.ShiftedSolverOptions(**opts_kw), x0=x0)
    rt = tf(tm, T.ShiftedSolverOptions(**opts_kw), x0=x0)
    return rj, rt


def scalar(x):
    x = np.asarray(x)
    return complex(x[0], x[1]) if x.shape == (2,) else complex(x)


class TestOptions:
    def test_fields_defaults_and_messages_match_jax(self):
        jf = {f.name: f.default for f in dataclasses.fields(J.ShiftedSolverOptions)}
        tf = {f.name: f.default for f in dataclasses.fields(T.ShiftedSolverOptions)}
        assert jf == tf
        assert T.ShiftedSolverOptions is topts.ShiftedSolverOptions
        for bad in ({"max_iterations": -1}, {"tolerance": -1.0}):
            with pytest.raises(ValueError) as ej:
                J.ShiftedSolverOptions(**bad)
            with pytest.raises(ValueError, match=str(ej.value)):
                T.ShiftedSolverOptions(**bad)


class TestShiftSelectsNearest:
    @pytest.mark.parametrize("shift, want", [(1.9, 2.0), (4.9, 5.0)])
    def test_dense(self, shift, want):
        jm, tm = dense_pair(np.diag([2.0, 5.0]))
        rj, rt = run_both(jm, tm, {"shift": shift}, start(2, np.float64))
        assert bool(rt.converged)
        np.testing.assert_allclose(complex(rt.eigenvalue), want, rtol=1e-8)
        np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
        assert int(rt.iterations) == int(rj.iterations)
        np.testing.assert_allclose(rt.eigenvector.numpy(), np.asarray(rj.eigenvector),
                                   atol=1e-10)

    @pytest.mark.parametrize("method", ["auto", "dense_lu", "bicgstab", "gmres"])
    def test_sparse(self, method):
        coo = ([0, 1, 2], [0, 1, 2], [1.0, 3.0, 10.0], (3, 3))
        jm = J.SparseCSR.from_coo(*coo)
        tm = T.SparseCSR.from_coo(*coo, device="cpu")
        rj, rt = run_both(jm, tm, {"shift": 2.9, "inner_method": method},
                          start(3, np.float64, 1))
        assert bool(rt.converged)
        np.testing.assert_allclose(complex(rt.eigenvalue), 3.0, rtol=1e-8)
        np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
        if method in ("auto", "dense_lu"):
            assert int(rt.iterations) == int(rj.iterations)

    def test_complex_shift(self):
        jm, tm = dense_pair(np.diag([1 + 3j, 2 + 4j, 5 - 1j]), np.complex128)
        rj, rt = run_both(jm, tm, {"shift": 2.3 + 4j, "tolerance": 1e-12},
                          start(3, np.complex128, 2))
        assert bool(rt.converged)
        np.testing.assert_allclose(complex(rt.eigenvalue), 2 + 4j, rtol=1e-8)
        np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
        assert int(rt.iterations) == int(rj.iterations)

    def test_nonsymmetric_interior(self):
        rng = np.random.default_rng(7)
        a = rng.random((8, 8))
        eigs = np.linalg.eigvals(a)
        target = min(eigs, key=lambda z: abs(z.imag) * 1e6 + abs(z))
        assert abs(target.imag) < 1e-9  # the JAX test's case holds for this seed
        jm, tm = dense_pair(a)
        rj, rt = run_both(jm, tm, {"shift": float(target.real) + 0.05, "tolerance": 1e-12},
                          start(8, np.float64, 3))
        np.testing.assert_allclose(complex(rt.eigenvalue), target, rtol=1e-6)
        np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
        assert int(rt.iterations) == int(rj.iterations)

    @pytest.mark.parametrize("shift", [2.0, 5.0])
    def test_shift_on_an_eigenvalue(self, shift):
        # a singular A - shift I: the LU solve is non-finite, so the first
        # iteration breaks down, keeps x0 and reports converged=False
        jm, tm = dense_pair(np.diag([2.0, 5.0]))
        x0 = start(2, np.float64, 4)
        rj, rt = run_both(jm, tm, {"shift": shift}, x0)
        assert not bool(rt.converged) and not bool(rj.converged)
        assert int(rt.iterations) == int(rj.iterations) == 1
        assert complex(rt.eigenvalue) == complex(rj.eigenvalue)
        assert np.all(np.isfinite(rt.eigenvector.numpy()))
        np.testing.assert_allclose(rt.eigenvector.numpy(), x0 / np.linalg.norm(x0))

    def test_tiny_max_iterations(self):
        jm, tm = dense_pair(np.diag([2.0, 5.0]))
        rj, rt = run_both(jm, tm, {"shift": 1.9, "max_iterations": 1}, start(2, np.float64))
        assert int(rt.iterations) == int(rj.iterations) == 1
        assert not bool(rt.converged)


class TestDemo:
    """The reference demo's shifted section (demo.py:55-59)."""

    @pytest.mark.parametrize("name, shift", [("A", 3.1), ("B", 2.3)])
    def test_demo_shift(self, name, shift):
        path = os.path.join(DATA, f"{name}.txt")
        jm = J.read_matrix_from_file(path, np.complex128)
        tm = T.read_matrix_from_file(path, torch.complex128, device="cpu")
        n = tm.shape[0]
        rj, rt = run_both(jm, tm, {"shift": shift, "tolerance": 1e-12},
                          start(n, np.complex128, 5))
        ev = np.linalg.eigvals(np.asarray(jm.to_dense()))
        want = ev[np.argmin(np.abs(ev - shift))]
        assert bool(rt.converged)
        np.testing.assert_allclose(complex(rt.eigenvalue), want, rtol=1e-8)
        np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
        assert int(rt.iterations) == int(rj.iterations)


class TestErrorPaths:
    def test_non_square(self):
        with pytest.raises(ValueError, match="matrix must be square"):
            T.shifted_inverse_power_method(T.DenseMatrix.from_array(np.ones((2, 3)),
                                                                    device="cpu"))

    def test_zero_size(self):
        with pytest.raises(ValueError, match="zero size"):
            T.shifted_inverse_power_method(T.DenseMatrix.from_array(np.zeros((0, 0)),
                                                                    device="cpu"))

    def test_scalar_type_mismatch(self):
        with pytest.raises(TypeError, match="scalar type mismatch"):
            T.shifted_inverse_power_method(T.DenseMatrix.from_array(np.eye(2), device="cpu"),
                                           dtype=torch.complex128)

    def test_unknown_inner_method(self):
        dia = t_banded_full(100, bandwidth=2, dtype=np.float64, seed=0, device="cpu")
        with pytest.raises(ValueError, match="unknown inner method"):
            T.shifted_inverse_power_method(dia, T.ShiftedSolverOptions(shift=1.0,
                                                                       inner_method="qr"))

    def test_split_guards(self):
        sc = T.SplitComplexDIA.from_complex_dia(
            t_banded_full(16, bandwidth=1, dtype=np.complex64, seed=0, device="cpu"))
        with pytest.raises(ValueError, match="inner_method 'auto'"):
            T.shifted_inverse_power_method(sc, T.ShiftedSolverOptions(inner_method="qr"))
        with pytest.raises(ValueError, match=r"x0 must be \(2, n\) planes"):
            T.shifted_inverse_power_method(sc, x0=np.ones(16))

    def test_rqi_guards(self):
        with pytest.raises(ValueError, match="square"):
            T.rayleigh_quotient_iteration(T.DenseMatrix.from_array(np.ones((2, 3)),
                                                                   device="cpu"))
        with pytest.raises(TypeError, match="scalar type mismatch"):
            T.rayleigh_quotient_iteration(T.DenseMatrix.from_array(np.eye(2), device="cpu"),
                                          dtype=torch.float32)


class TestRayleighQuotientIteration:
    def test_cubic_convergence(self):
        rng = np.random.default_rng(0)
        a = rng.random((12, 12))
        a = a + a.T
        jm, tm = dense_pair(a)
        rj, rt = run_both(jm, tm, {"shift": 3.0, "tolerance": 1e-13}, start(12, np.float64, 6),
                          rqi=True)
        assert bool(rt.converged)
        assert int(rt.iterations) <= 10
        assert int(rt.iterations) == int(rj.iterations)
        lam = complex(rt.eigenvalue).real
        assert min(abs(np.linalg.eigvalsh(a) - lam)) < 1e-10
        np.testing.assert_allclose(lam, complex(rj.eigenvalue).real, rtol=1e-10)

    def test_sparse_is_densified(self):
        coo = ([0, 1, 2], [0, 1, 2], [1.0, 3.0, 10.0], (3, 3))
        jm = J.SparseCSR.from_coo(*coo)
        tm = T.SparseCSR.from_coo(*coo, device="cpu")
        rj, rt = run_both(jm, tm, {"shift": 9.0, "tolerance": 1e-13}, start(3, np.float64, 7),
                          rqi=True)
        np.testing.assert_allclose(complex(rt.eigenvalue), 10.0, rtol=1e-10)
        assert int(rt.iterations) == int(rj.iterations)


def sym_banded(n, bw, seed, boost_head):
    """tests/test_inverse_power.py's symmetric banded operator, as numpy data."""
    rng = np.random.default_rng(seed)
    offs = tuple(range(-bw, bw + 1))
    data = np.zeros((len(offs), n), np.float32)
    for d, off in enumerate(offs):
        if off < 0:
            continue
        v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        if off > 0:
            v[n - off:] = 0
        data[d] = v
        if off > 0:
            data[offs.index(-off), off:] = v[:n - off]
    data[bw, :len(boost_head)] += np.asarray(boost_head, np.float32)
    return data, offs


class TestKrylovInnerVariants:
    @pytest.fixture(scope="class")
    def band(self):
        data, offs = sym_banded(3000, 3, 0, [30, 25, 21, 18])
        jd = J.SparseDIA(data=jnp.asarray(data), offsets=offs, shape=(3000, 3000))
        ev = np.linalg.eigvalsh(np.asarray(jd.to_dense()))
        return jd, to_port(jd), ev

    @pytest.mark.parametrize("method", ["bicgstab", "gmres"])
    @pytest.mark.parametrize("shift", [24.0, 17.0])
    def test_symmetric_interior_shifts(self, band, method, shift):
        jd, td, ev = band
        target = ev[np.argmin(np.abs(ev - shift))]
        kw = {"shift": shift, "max_iterations": 100, "tolerance": 1e-6, "inner_method": method,
              "inner_tolerance": 1e-10}
        x0 = start(3000, np.float32, 8)
        rj, rt = run_both(jd, td, kw, x0)
        ri = T.shifted_inverse_power_method(td.interleaved(), T.ShiftedSolverOptions(**kw),
                                            x0=x0)
        for r in (rt, ri):
            assert bool(r.converged)
            np.testing.assert_allclose(complex(r.eigenvalue).real, target, rtol=1e-5)
            np.testing.assert_allclose(complex(r.eigenvalue), complex(rj.eigenvalue), rtol=1e-5)
        assert ri.eigenvector.shape == (3000,)

    @pytest.mark.parametrize("method", ["bicgstab", "gmres"])
    def test_never_returns_nan(self, method):
        dia = j_banded_full(3000, bandwidth=3, dtype=np.float32, seed=7, diag_boost=4.0)
        tdia = t_banded_full(3000, bandwidth=3, dtype=np.float32, seed=7, diag_boost=4.0,
                             device="cpu")
        assert np.array_equal(np.asarray(dia.data), tdia.data.numpy())
        r = T.shifted_inverse_power_method(
            tdia, T.ShiftedSolverOptions(shift=4.5, max_iterations=30, tolerance=1e-8,
                                         inner_method=method, inner_tolerance=1e-10),
            x0=start(3000, np.float32, 9))
        assert np.all(np.isfinite(r.eigenvalue.numpy()))
        assert np.all(np.isfinite(r.eigenvector.numpy()))


def solve_pair(m_j, m_t, shift, b, **kw):
    xj = np.asarray(J.solve_shifted(m_j, shift, b, **kw))
    xt = T.solve_shifted(m_t, shift, b, **kw).numpy()
    return xj, xt


class TestSolveShifted:
    def test_identity_analytic(self):
        b = np.array([1.0, 2.0, 3.0])
        xj, xt = solve_pair(*dense_pair(np.eye(3)), 0.5, b)
        np.testing.assert_allclose(xt, 2 * b, rtol=1e-12)
        np.testing.assert_allclose(xt, xj, rtol=1e-12)

    def test_2x2_vs_numpy_lu(self):
        a = np.array([[3.0, 1.0], [1.0, 2.0]])
        b = np.array([1.0, 0.0])
        xj, xt = solve_pair(*dense_pair(a), 0.7, b)
        np.testing.assert_allclose(xt, np.linalg.solve(a - 0.7 * np.eye(2), b), rtol=1e-12)
        np.testing.assert_allclose(xt, xj, rtol=1e-12)

    def test_complex(self):
        a = np.array([[2 + 1j, 1 - 1j], [0 + 2j, 3 + 0j]])
        b = np.array([1 + 0j, 2 - 1j])
        shift = 0.5 + 0.5j
        xj, xt = solve_pair(*dense_pair(a, np.complex128), shift, b)
        np.testing.assert_allclose(xt, np.linalg.solve(a - shift * np.eye(2), b), rtol=1e-12)
        np.testing.assert_allclose(xt, xj, rtol=1e-12)

    def test_sparse_identity(self):
        coo = ([0, 1, 2], [0, 1, 2], [1.0, 1.0, 1.0], (3, 3))
        b = np.array([4.0, 5.0, 6.0])
        xj, xt = solve_pair(J.SparseCSR.from_coo(*coo), T.SparseCSR.from_coo(*coo, device="cpu"),
                            0.5, b)
        np.testing.assert_allclose(xt, 2 * b, rtol=1e-10)
        np.testing.assert_allclose(xt, xj, rtol=1e-12)

    @pytest.mark.parametrize("method", ["bicgstab", "gmres", "dense_lu"])
    def test_sparse_methods_vs_dense(self, method):
        rng = np.random.default_rng(11)
        n = 20
        a = np.diag(rng.random(n) + 2.0)
        idx = rng.integers(0, n, size=(2, 30))
        a[idx[0], idx[1]] += 0.1 * rng.random(30)
        b = rng.random(n)
        xj, xt = solve_pair(J.SparseCSR.from_dense(a), T.SparseCSR.from_dense(a, device="cpu"),
                            0.3, b, method=method)
        expected = np.linalg.solve(a - 0.3 * np.eye(n), b)
        np.testing.assert_allclose(xt, expected, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-8)

    def test_inserts_missing_diagonal(self):
        coo = ([0, 1], [1, 0], [1.0, 1.0], (2, 2))
        b = np.array([1.0, 1.0])
        xj, xt = solve_pair(J.SparseCSR.from_coo(*coo), T.SparseCSR.from_coo(*coo, device="cpu"),
                            2.0, b)
        a = np.array([[0.0, 1.0], [1.0, 0.0]])
        np.testing.assert_allclose(xt, np.linalg.solve(a - 2.0 * np.eye(2), b), rtol=1e-10)
        np.testing.assert_allclose(xt, xj, rtol=1e-12)

    def test_gmres_on_banded_random(self):
        # tests/test_gmres.py::test_via_solve_shifted
        rng = np.random.default_rng(3)
        n = 30
        mj = j_banded_random(n, bandwidth=3, nnz_per_row=4, seed=7, diag_boost=5.0)
        mt = t_banded_random(n, bandwidth=3, nnz_per_row=4, seed=7, diag_boost=5.0,
                             device="cpu")
        b = rng.random(n)
        xj, xt = solve_pair(mj, mt, 0.4, b, method="gmres")
        a = np.asarray(mj.to_dense())
        np.testing.assert_allclose(xt, np.linalg.solve(a - 0.4 * np.eye(n), b), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-8)

    def test_singular_gives_non_finite(self):
        xj, xt = solve_pair(*dense_pair(np.diag([2.0, 5.0])), 2.0, np.ones(2))
        assert not np.all(np.isfinite(xt)) and not np.all(np.isfinite(xj))

    @pytest.mark.parametrize("case", ["dense", "sparse", "size", "dtype", "method"])
    def test_error_words(self, case):
        def both(fj, ft):
            with pytest.raises((ValueError, TypeError)) as ej:
                fj()
            with pytest.raises(type(ej.value), match=str(ej.value).split(" (stored")[0]
                               .replace("(", r"\(").replace(")", r"\)")):
                ft()

        if case == "dense":
            both(lambda: J.solve_shifted(J.DenseMatrix.from_array(np.ones((2, 3))), 0.0,
                                         np.ones(2)),
                 lambda: T.solve_shifted(T.DenseMatrix.from_array(np.ones((2, 3)), device="cpu"),
                                         0.0, np.ones(2)))
        elif case == "sparse":
            coo = ([0], [0], [1.0], (2, 3))
            both(lambda: J.solve_shifted(J.SparseCSR.from_coo(*coo), 0.0, np.ones(2)),
                 lambda: T.solve_shifted(T.SparseCSR.from_coo(*coo, device="cpu"), 0.0,
                                         np.ones(2)))
        elif case == "size":
            jm, tm = dense_pair(np.eye(3))
            both(lambda: J.solve_shifted(jm, 0.0, np.ones(2)),
                 lambda: T.solve_shifted(tm, 0.0, np.ones(2)))
        elif case == "dtype":
            jm, tm = dense_pair(np.eye(2))
            both(lambda: J.solve_shifted(jm, 0.0, np.ones(2), dtype=np.complex128),
                 lambda: T.solve_shifted(tm, 0.0, np.ones(2), dtype=torch.complex128))
        else:
            coo = ([0, 1], [0, 1], [1.0, 1.0], (2, 2))
            both(lambda: J.solve_shifted(J.SparseCSR.from_coo(*coo), 0.0, np.ones(2),
                                         method="lu"),
                 lambda: T.solve_shifted(T.SparseCSR.from_coo(*coo, device="cpu"), 0.0,
                                         np.ones(2), method="lu"))


def jax_mv(a):
    aj = jnp.asarray(a)
    return lambda v: aj @ v


def torch_mv(a):
    at = torch.from_numpy(a)
    return lambda v: at @ v


class TestGenericKrylov:
    """parallel/krylov.py against JAX's, on tests/test_gmres.py's systems."""

    @pytest.mark.parametrize("case", ["nonsymmetric", "preconditioned", "complex"])
    def test_gmres(self, case):
        rng = np.random.default_rng({"nonsymmetric": 0, "preconditioned": 1, "complex": 2}[case])
        precond_j = precond_t = None
        if case == "nonsymmetric":
            n, m = 60, 20
            a = np.diag(rng.random(n) + 2.0) + 0.3 * rng.random((n, n))
            b = rng.random(n)
        elif case == "preconditioned":
            n, m = 40, 10
            d = rng.random(n) * 50 + 1
            a = np.diag(d) + 0.05 * rng.random((n, n))
            b = rng.random(n)
            precond_j = lambda v: v / jnp.asarray(d)  # noqa: E731
            precond_t = lambda v: v / torch.from_numpy(d)  # noqa: E731
        else:
            n, m = 24, 24
            a = np.diag(rng.random(n) + 2 + 1j) + 0.05 * (
                rng.random((n, n)) + 1j * rng.random((n, n)))
            b = rng.random(n) + 1j * rng.random(n)
        xj, rnj, itj = jkr.gmres(jax_mv(a), jnp.asarray(b), vdot=jnp.vdot, norm=jnp.linalg.norm,
                                 m=m, tol=1e-12, precond=precond_j)
        xt, rnt, itt = tkr.gmres(torch_mv(a), torch.from_numpy(b), vdot=t_vdot, norm=t_norm,
                                 m=m, tol=1e-12, precond=precond_t)
        want = np.linalg.solve(a, b)
        np.testing.assert_allclose(xt.numpy(), want, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-8)
        assert int(itt) == int(itj)
        assert float(rnt) <= 1e-10 * np.linalg.norm(b) + 1e-12

    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_bicgstab(self, dtype):
        rng = np.random.default_rng(12)
        n = 50
        a = np.diag(rng.random(n) + 3.0) + 0.2 * rng.standard_normal((n, n))
        b = rng.random(n)
        if dtype == np.complex128:
            a = a + 0.2j * rng.standard_normal((n, n))
            b = b + 1j * rng.random(n)
        xj, rnj, kj = jkr.bicgstab(jax_mv(a), jnp.asarray(b), vdot=jnp.vdot,
                                   norm=jnp.linalg.norm, tol=1e-12)
        xt, rnt, kt = tkr.bicgstab(torch_mv(a), torch.from_numpy(b), vdot=t_vdot, norm=t_norm,
                                   tol=1e-12)
        np.testing.assert_allclose(xt.numpy(), np.linalg.solve(a, b), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)
        assert int(kt) == int(kj)

    def test_stop_returns_the_start(self):
        a = np.diag([2.0, 3.0])
        b = torch.ones(2, dtype=torch.float64)
        stop = torch.tensor(True)
        x, _, k = tkr.bicgstab(torch_mv(a), b, vdot=t_vdot, norm=t_norm, stop=stop)
        assert int(k) == 0 and torch.equal(x, torch.zeros(2, dtype=torch.float64))
        x, _, it = tkr.gmres(torch_mv(a), b, vdot=t_vdot, norm=t_norm, m=2, stop=stop)
        assert int(it) == 0 and torch.equal(x, torch.zeros(2, dtype=torch.float64))

    @pytest.mark.parametrize("breakdown", [False, True])
    def test_arnoldi_decomposition(self, breakdown):
        rng = np.random.default_rng(13)
        n, m = 12, 6
        a = rng.standard_normal((n, n))
        x0 = rng.standard_normal(n)
        if breakdown:  # e_0 is an eigenvector: the subspace is invariant at step 1
            a = np.diag(np.arange(1.0, n + 1))
            x0 = np.eye(n)[0]
        Vj, Hj, bj = j_arnoldi(jax_mv(a), jnp.asarray(x0), m)
        Vt, Ht, bt = t_arnoldi(torch_mv(a), torch.from_numpy(x0), m)
        assert int(bt) == int(bj) == (1 if breakdown else m)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-12)
        np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-12)


def plane_system(n, seed, shift=20.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + shift * np.eye(n)
    xstar = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = A @ xstar
    Ar = np.stack([A.real, A.imag])
    bp = np.stack([b.real, b.imag])

    def mv_j(v, Aj=jnp.asarray(Ar)):
        return jnp.stack([Aj[0] @ v[0] - Aj[1] @ v[1], Aj[0] @ v[1] + Aj[1] @ v[0]])

    def mv_t(v, At=torch.from_numpy(Ar)):
        return torch.stack([At[0] @ v[0] - At[1] @ v[1], At[0] @ v[1] + At[1] @ v[0]])

    return mv_j, mv_t, bp, xstar


class TestSplitKrylov:
    def test_dotu_and_div(self):
        rng = np.random.default_rng(14)
        a, b = rng.standard_normal((2, 7)), rng.standard_normal((2, 7))
        np.testing.assert_allclose(tsk.splitc_dotu(torch.from_numpy(a), torch.from_numpy(b))
                                   .numpy(), np.asarray(jsk.splitc_dotu(a, b)), rtol=1e-14)
        b[:, 3] = 0
        np.testing.assert_array_equal(tsk.splitc_div(torch.from_numpy(a), torch.from_numpy(b))
                                      .numpy(), np.asarray(jsk.splitc_div(a, b)))

    def test_qr_ls_matches_lstsq(self):
        rng = np.random.default_rng(0)
        G, rhs = rng.standard_normal((20, 12)), rng.standard_normal(20)
        y = tsk._qr_ls(torch.from_numpy(G), torch.from_numpy(rhs)).numpy()
        np.testing.assert_allclose(y, np.linalg.lstsq(G, rhs, rcond=None)[0], rtol=1e-10,
                                   atol=1e-12)
        G[:, 4] = 0  # a singular column gives 0 in its coordinate
        y = tsk._qr_ls(torch.from_numpy(G), torch.from_numpy(rhs)).numpy()
        assert y[4] == 0 and np.isfinite(y).all()

    @pytest.mark.parametrize("ls", ["qr", "householder"])
    def test_gmres(self, ls):
        # the port's one least squares (QR) against both of the JAX package's
        mv_j, mv_t, bp, xstar = plane_system(60, 1)
        xj = np.asarray(jsk.splitc_gmres(mv_j, jnp.asarray(bp), tol=1e-10, m=20, ls=ls))
        xt = tsk.splitc_gmres(mv_t, torch.from_numpy(bp), tol=1e-10, m=20).numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-10)
        xc = xt[0] + 1j * xt[1]
        assert np.abs(xc - xstar).max() / np.abs(xstar).max() < 1e-6

    def test_bicgstab(self):
        mv_j, mv_t, bp, xstar = plane_system(40, 2)
        xj = np.asarray(jsk.splitc_bicgstab(mv_j, jnp.asarray(bp), tol=1e-12, maxiter=200))
        xt = tsk.splitc_bicgstab(mv_t, torch.from_numpy(bp), tol=1e-12, maxiter=200).numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-10)
        xc = xt[0] + 1j * xt[1]
        assert np.abs(xc - xstar).max() / np.abs(xstar).max() < 1e-8

    @pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
    def test_shifted_solvers_with_jacobi(self, solver):
        mv_j, mv_t, bp, _ = plane_system(30, 3, shift=6.0)
        rng = np.random.default_rng(4)
        diag = rng.standard_normal((2, 30))
        diag[:, 5] = (1.5, -0.5)  # d - shift == 0 there: the guard replaces it by 1
        shift = np.array([1.5, -0.5])
        if solver == "bicgstab":
            xj = jsk.solve_shifted_splitc(mv_j, jnp.asarray(shift), jnp.asarray(bp),
                                          diag=jnp.asarray(diag), tol=1e-12, maxiter=300)
            xt = tsk.solve_shifted_splitc(mv_t, torch.from_numpy(shift), torch.from_numpy(bp),
                                          diag=torch.from_numpy(diag), tol=1e-12, maxiter=300)
        else:
            xj = jsk.solve_shifted_splitc_gmres(mv_j, jnp.asarray(shift), jnp.asarray(bp),
                                                diag=jnp.asarray(diag), tol=1e-12, m=15,
                                                unroll=False)
            xt = tsk.solve_shifted_splitc_gmres(mv_t, torch.from_numpy(shift),
                                                torch.from_numpy(bp),
                                                diag=torch.from_numpy(diag), tol=1e-12, m=15)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-7, atol=1e-9)


def split_operator(n, seed, precision=np.float64):
    """bench.py's interior-shift class (bench.py:579-670) at a small n: four
    complex diagonals, the main one around 4 with a spread."""
    rng = np.random.default_rng(seed)
    offs = (-3, -1, 0, 2)
    planes = np.zeros((2, len(offs), n))
    for d, off in enumerate(offs):
        amp = 1.0 if off == 0 else 0.3
        planes[:, d] = amp * rng.standard_normal((2, n))
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    planes[0, offs.index(0)] += 4.0 + rng.uniform(-2, 2, n)
    planes = planes.astype(precision)
    jm = JSplit(planes=jnp.asarray(planes), offsets=offs, shape=(n, n))
    return jm, to_port(jm)


class TestSplitInversePower:
    @pytest.mark.parametrize("method", ["dense_lu", "bicgstab", "gmres"])
    def test_split_paths_match_jax(self, method):
        n = 200
        jm, tm = split_operator(n, 5)
        dense = np.asarray(jm.to_complex_dense())
        ev = np.linalg.eigvals(dense)
        target = ev[np.argmin(np.abs(ev - (4.0 + 0.3j)))]
        shift = complex(target + 0.01 * (1 + 1j))
        kw = {"shift": shift, "max_iterations": 60, "tolerance": 1e-10, "inner_method": method,
              "inner_tolerance": 1e-10}
        x0 = np.stack([start(n, np.float64, 10), start(n, np.float64, 11)])
        rj, rt = run_both(jm, tm, kw, x0)
        want = ev[np.argmin(np.abs(ev - shift))]
        assert bool(rt.converged)
        assert rt.eigenvalue.shape == (2,) and rt.eigenvector.shape == (2, n)
        np.testing.assert_allclose(scalar(rt.eigenvalue), want, rtol=1e-8)
        np.testing.assert_allclose(scalar(rt.eigenvalue), scalar(rj.eigenvalue), rtol=1e-8)
        if method == "dense_lu":
            assert int(rt.iterations) == int(rj.iterations)
        ri = T.shifted_inverse_power_method(tm.interleaved(8), T.ShiftedSolverOptions(**kw),
                                            x0=x0)
        assert ri.eigenvector.shape == (2, n)
        np.testing.assert_allclose(scalar(ri.eigenvalue), want, rtol=1e-8)

    def test_split_float32_against_complex_route(self):
        n = 120
        _, tm32 = split_operator(n, 6, np.float32)
        dense = tm32.to_complex_dense()
        ev = np.linalg.eigvals(dense)
        shift = complex(ev[np.argmin(np.abs(ev - 4.0))] + 0.02)
        kw = {"shift": shift, "max_iterations": 60, "tolerance": 1e-6, "inner_method": "bicgstab",
              "inner_tolerance": 1e-6}
        x0 = np.stack([start(n, np.float64, 12), start(n, np.float64, 13)])
        rt = T.shifted_inverse_power_method(tm32, T.ShiftedSolverOptions(**kw), x0=x0)
        assert rt.eigenvalue.dtype == torch.float32
        rc = T.shifted_inverse_power_method(T.DenseMatrix.from_array(dense, device="cpu"),
                                            T.ShiftedSolverOptions(**kw), x0=x0[0] + 1j * x0[1])
        np.testing.assert_allclose(scalar(rt.eigenvalue), complex(rc.eigenvalue), rtol=1e-5)

    def test_loop_breakdown_keeps_the_iterate(self):
        # a solve that returns NaN on the second call: the iterate and the
        # eigenvalue of the first stay, converged=False, iterations = 2
        calls = []

        def solve(x, done):
            calls.append(1)
            return x * 2 if len(calls) == 1 else x * float("nan")

        x0 = torch.tensor([0.6, 0.8], dtype=torch.float64)
        r = tip.inverse_power_loop(lambda v: 3 * v, solve, t_vdot, t_norm, x0, 10, 1e-12)
        assert not bool(r.converged) and int(r.iterations) == 2
        assert float(r.eigenvalue) == pytest.approx(3.0)
        assert torch.equal(r.eigenvector, x0)
