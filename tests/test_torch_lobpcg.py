"""LOBPCG of the PyTorch port against the JAX package, on the CPU (the cases
of tests/test_lobpcg.py at n = 300, and the upstream core's pieces).

The same numpy operator and the same explicit start block ``X0`` go
through both packages (JAX's default block comes from ``jax.random``). The
port's copy of the upstream core (``jax/experimental/sparse/linalg.py``) is
held against the upstream functions on the same inputs. Tolerances: in
float64 the eigenvalues within 1e-10 relative with equal iteration counts
and flags; in float32 within 1e-4 (counts not compared: ROADMAP Queue C).
SVQB bases and reflector extensions are compared up to column signs where
an ``eigh`` picks them, projections by their spanned subspace, to 1e-10 in
float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse import linalg as upstream

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import laplacian_1d as j_lap
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.dia import SparseDIA as TSparseDIA
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import laplacian_1d as t_lap
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import lobpcg as tlob

N = 300


def sym_band(n, bw, seed, boost_head, dtype=np.float64):
    rng = np.random.default_rng(seed)
    offs = tuple(range(-bw, bw + 1))
    data = np.zeros((len(offs), n), dtype)
    for d, off in enumerate(offs):
        if off < 0:
            continue
        v = rng.uniform(-0.5, 0.5, n).astype(dtype)
        if off > 0:
            v[n - off:] = 0
        data[d] = v
        if off > 0:
            data[offs.index(-off), off:] = v[:n - off]
    data[bw, :len(boost_head)] += np.asarray(boost_head, dtype)
    return (JSparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n)),
            TSparseDIA(data=torch.from_numpy(data), offsets=offs, shape=(n, n)))


@pytest.fixture(scope="module")
def operator():
    return sym_band(N, 3, 0, [30, 25, 21, 18])


@pytest.fixture(scope="module")
def exact(operator):
    return np.linalg.eigvalsh(operator[1].to_dense().numpy())


@pytest.fixture(scope="module")
def X0():
    return np.random.default_rng(7).standard_normal((N, 4))


def run_both(ops, X0, tol=1e-10, counts=True, max_iterations=100, tolerance=1e-9, **kw):
    rj = J.lobpcg_eigenvalues(ops[0], X0=X0, opts=J.SolverOptions(
        max_iterations=max_iterations, tolerance=tolerance), **kw)
    rt = T.lobpcg_eigenvalues(ops[1], X0=X0, opts=T.SolverOptions(
        max_iterations=max_iterations, tolerance=tolerance), **kw)
    want = np.asarray(rj.eigenvalues)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    if counts:
        assert int(rt.iterations) == int(rj.iterations)
        assert bool(rt.converged) == bool(rj.converged)
    return rt


def signs(a, b):
    """Column signs that map ``a`` onto ``b`` (zero columns keep +1)."""
    s = np.sign(np.sum(a * b, axis=0))
    return np.where(s == 0, 1.0, s)


class TestLOBPCG:
    def test_largest_f64(self, operator, exact, X0):
        r = run_both(operator, X0, which="LA", k=4)
        assert bool(r.converged)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[::-1][:4], rtol=1e-6)

    def test_smallest_via_spectral_shift(self):
        ops = sym_band(N, 3, 1, [-30, -25, -21, -18])
        evB = np.linalg.eigvalsh(ops[1].to_dense().numpy())
        X0 = np.random.default_rng(8).standard_normal((N, 4))
        r = run_both(ops, X0, which="SA", k=4, max_iterations=200, tolerance=1e-8)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(evB)[:4], atol=1e-5)

    @pytest.mark.parametrize("interleaved", [False, True])
    def test_f32_noise_floor(self, operator, exact, X0, interleaved):
        """float32 storage, natural and interleaved (B5 on the block's rows
        on the card): converges to float32's floor (~1e-3 relative)."""
        data = np.asarray(operator[0].data, np.float32)
        j32 = JSparseDIA(data=jnp.asarray(data), offsets=operator[0].offsets, shape=(N, N))
        t32 = TSparseDIA(data=torch.from_numpy(data), offsets=operator[0].offsets, shape=(N, N))
        if interleaved:
            j32, t32 = j32.interleaved(), t32.interleaved()
        r = run_both((j32, t32), X0, tol=1e-4, counts=False, which="LA", k=4, tolerance=1e-5)
        assert r.eigenvalues.dtype == torch.float32
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[::-1][:4], rtol=5e-3)

    def test_dense_path(self, operator, X0):
        a = operator[1].to_dense().numpy()
        ops = (J.DenseMatrix.from_array(a), T.DenseMatrix.from_array(a, device="cpu"))
        r = run_both(ops, X0, which="LA", k=4)
        np.testing.assert_allclose(r.eigenvalues.numpy(),
                                   np.sort(np.linalg.eigvalsh(a))[::-1][:4], rtol=1e-6)

    def test_csr_operator_takes_the_power_overestimate(self, X0):
        """An operator without ``spectral_bound`` (CSR): ``which="SA"``
        shifts by the 30-step power overestimate, as in JAX."""
        ops = (j_lap(N), t_lap(N, device="cpu"))
        assert not hasattr(ops[1], "spectral_bound")
        r = run_both(ops, X0, which="SA", k=4, tolerance=1e-7)
        assert r.eigenvalues.shape == (4,)

    def test_clustered_bottom_reports_unconverged(self, X0):
        ops = (JSparseDIA.from_csr(j_lap(N)), TSparseDIA.from_csr(t_lap(N, device="cpu")))
        r = run_both(ops, X0, which="SA", k=4, tolerance=1e-7)
        assert not bool(r.converged)

    def test_errors(self, operator):
        small = sym_band(30, 1, 0, [5.0])
        for es, M, S in ((J, operator[0], small[0]), (T, operator[1], small[1])):
            dev = {} if es is J else {"device": "cpu"}
            with pytest.raises(ValueError, match="which"):
                es.lobpcg_eigenvalues(M, which="LM")
            with pytest.raises(ValueError, match="k must be >= 1"):
                es.lobpcg_eigenvalues(M, k=0)
            with pytest.raises(ValueError, match="must exceed 5k"):
                es.lobpcg_eigenvalues(S, k=8)
            with pytest.raises(ValueError, match="square"):
                es.lobpcg_eigenvalues(es.DenseMatrix.from_array(np.ones((2, 3)), **dev))
            with pytest.raises(TypeError, match="scalar type mismatch"):
                es.lobpcg_eigenvalues(M, dtype=np.float32)
            with pytest.raises(ValueError, match="X0 must be"):
                es.lobpcg_eigenvalues(M, k=4, X0=np.ones((5, 4)))
            with pytest.raises(ValueError, match="complex operators"):
                es.lobpcg_eigenvalues(es.DenseMatrix.from_array(np.eye(40) + 0j, **dev), k=2)


class TestUpstreamCore:
    """The port's copy of the upstream routine against the upstream
    functions on the same inputs."""

    def test_svqb_zeroes_the_same_columns(self):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((N, 6))
        X[:, 4] = X[:, 0] + X[:, 1]          # rank-deficient: a rounding-level direction
        X[:, 5] = 0.0                        # zero column: dropped
        got = tlob._svqb(torch.from_numpy(X)).numpy()
        want = np.asarray(upstream._svqb(jnp.asarray(X)))
        assert ((np.abs(got).sum(0) > 0) == (np.abs(want).sum(0) > 0)).all()
        assert not np.abs(got[:, 5]).any()
        # the columns of the four well-determined directions (the fifth is
        # rounding noise blown up to unit length in both packages)
        np.testing.assert_allclose(got[:, :4] * signs(got[:, :4], want[:, :4]), want[:, :4],
                                   atol=1e-10)

    def test_extend_basis(self):
        X = np.array(upstream._orthonormalize(jnp.asarray(
            np.random.default_rng(2).standard_normal((N, 4)))))
        got = tlob._extend_basis(torch.from_numpy(X), 4).numpy()
        want = np.asarray(upstream._extend_basis(jnp.asarray(X), 4))
        np.testing.assert_allclose(got, want, atol=1e-10)
        np.testing.assert_allclose(np.hstack([X, got]).T @ np.hstack([X, got]), np.eye(8),
                                   atol=1e-10)

    def test_project_out(self):
        rng = np.random.default_rng(3)
        basis = np.array(upstream._orthonormalize(jnp.asarray(rng.standard_normal((N, 8)))))
        U = rng.standard_normal((N, 4))
        got = tlob._project_out(torch.from_numpy(basis), torch.from_numpy(U)).numpy()
        want = np.asarray(upstream._project_out(jnp.asarray(basis), jnp.asarray(U)))
        assert ((np.abs(got).sum(0) > 0) == (np.abs(want).sum(0) > 0)).all()
        # the second SVQB pass sees a Gram matrix ~ I, whose eigenvectors
        # (so the columns) are any rotation: compare the spanned subspace
        np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-10)
        np.testing.assert_allclose(basis.T @ got, 0, atol=1e-12)

    def test_lobpcg_standard(self, operator, X0):
        a = operator[1].to_dense().numpy()
        theta_j, U_j, it_j = upstream.lobpcg_standard(jnp.asarray(a), jnp.asarray(X0), m=40)
        at = torch.from_numpy(a)
        theta_t, U_t, it_t = tlob._lobpcg_standard(lambda X: at @ X, torch.from_numpy(X0), 40)
        np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=1e-10)
        U_j, U_t = np.asarray(U_j), U_t.numpy()
        np.testing.assert_allclose(U_t * signs(U_t, U_j), U_j, atol=1e-7)
        assert int(it_t) == int(it_j)

    def test_check_inputs_messages(self):
        X = torch.zeros((10, 3), dtype=torch.float64)
        with pytest.raises(ValueError, match="expected search dim"):
            tlob._lobpcg_standard(lambda Z: Z, X, 5)
        with pytest.raises(ValueError, match="same dtypes"):
            tlob._lobpcg_standard(lambda Z: Z.float(), torch.zeros((40, 2), dtype=torch.float64),
                                  5)
