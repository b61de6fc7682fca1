"""Lanczos, Lanczos eigenpairs and thick-restart Lanczos of the PyTorch port
against the JAX package, on the CPU (the single-device cases of
tests/test_lanczos.py, at n <= 300, and the building blocks).

The same numpy operator and the same explicit start vector go through both
packages (JAX's default start vectors come from ``jax.random``).
Tolerances: Ritz values within 1e-10 relative in float64/complex128 with
equal step and matvec counts and equal ``converged``; within 1e-4 in
float32, counts not compared (ROADMAP Queue C). Ritz vectors are compared
up to sign (each is an eigenvector of the same tridiagonal's eigenvector
column), to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import laplacian_1d as j_lap
from pcsc_eigenvalue_solver_project_tpu.solvers import lanczos as jl
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.dia import SparseDIA as TSparseDIA
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import laplacian_1d as t_lap
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import lanczos as tl

N = 300


def sym_band(n, bw, seed, boost, dtype=np.float64):
    """Random symmetric band with a boosted (separated) diagonal head, as
    numpy data (tests/test_lanczos.py's construction)."""
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
    data[bw, :len(boost)] += np.asarray(boost, dtype)
    return data, offs


def pair(data, offs):
    n = data.shape[1]
    return (JSparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n)),
            TSparseDIA(data=torch.from_numpy(data), offsets=offs, shape=(n, n)))


@pytest.fixture(scope="module")
def operator():
    return pair(*sym_band(N, 3, 0, [30, 25, 21, 18, 16, 15]))


@pytest.fixture(scope="module")
def exact(operator):
    d = operator[1].to_dense().numpy()
    np.testing.assert_allclose(d, d.T)
    return np.linalg.eigvalsh(d)


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(42).uniform(-1, 1, N)


def laplacians(n=300):
    return (JSparseDIA.from_csr(j_lap(n)), TSparseDIA.from_csr(t_lap(n, device="cpu")))


def run_both(name, ops, x0, tol=1e-10, counts=True, **kw):
    """``name`` on both packages with the same x0; asserts the comparison and
    returns the port's result."""
    opts = kw.pop("tolerance", None)
    kj = dict(kw, x0=x0)
    kt = dict(kw, x0=x0)
    if opts is not None:
        kj["opts"], kt["opts"] = J.SolverOptions(tolerance=opts), T.SolverOptions(tolerance=opts)
    rj = getattr(J, name)(ops[0], **kj)
    rt = getattr(T, name)(ops[1], **kt)
    if name == "lanczos_eigenpairs":
        (rj, Yj), (rt, Yt) = rj, rt
    got, want = rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    assert rt.eigenvalues.dtype == torch.float64
    if counts:
        assert int(rt.iterations) == int(rj.iterations)
        assert bool(rt.converged) == bool(rj.converged)
    if name == "lanczos_eigenpairs":
        Yj, Yt = np.asarray(Yj), Yt.numpy()
        sign = np.sign(np.sum(Yj * Yt.conj(), axis=0).real)
        np.testing.assert_allclose(Yt * sign, Yj, atol=1e-8)
        return rt, Yt
    return rt


class TestLanczos:
    def test_largest_algebraic(self, operator, exact, x0):
        r = run_both("lanczos_eigenvalues", operator, x0, k=5, m=60, which="LA",
                     tolerance=1e-9)
        assert bool(r.converged)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[::-1][:5], rtol=1e-9)

    def test_smallest_algebraic_full_space(self, operator, exact, x0):
        r = run_both("lanczos_eigenvalues", operator, x0, k=3, m=N, which="SA", tolerance=1e-8)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[:3], atol=1e-7)

    def test_largest_magnitude_default(self, operator, exact, x0):
        r = run_both("lanczos_eigenvalues", operator, x0, k=2, m=60, tolerance=1e-8)
        np.testing.assert_allclose(r.eigenvalues.numpy(),
                                   exact[np.argsort(-np.abs(exact))][:2], rtol=1e-8)

    def test_clustered_spectrum_reports_unconverged(self, x0):
        r = run_both("lanczos_eigenvalues", laplacians(), x0, k=5, m=60, which="LA",
                     tolerance=1e-8)
        assert not bool(r.converged)

    def test_no_reorth_still_finds_extremes(self, operator, exact, x0):
        r = run_both("lanczos_eigenvalues", operator, x0, k=1, m=60, which="LA",
                     reorth=False, tolerance=1e-6)
        np.testing.assert_allclose(float(r.eigenvalues[0]), np.max(exact), rtol=1e-6)

    @pytest.mark.parametrize("interleaved", [False, True])
    def test_float32_operator(self, operator, exact, x0, interleaved):
        data = np.asarray(operator[0].data, np.float32)
        j32, t32 = pair(data, operator[0].offsets)
        if interleaved:
            j32, t32 = j32.interleaved(), t32.interleaved()
        r = run_both("lanczos_eigenvalues", (j32, t32), x0, tol=1e-4, counts=False, k=5,
                     m=60, which="LA", tolerance=1e-3)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[::-1][:5], rtol=1e-4)

    def test_breakdown_invariant_subspace(self):
        d = np.zeros(50)
        d[0], d[1] = 7.0, 3.0
        ops = (J.DenseMatrix.from_array(np.diag(d)),
               T.DenseMatrix.from_array(np.diag(d), device="cpu"))
        x0 = np.zeros(50)
        x0[:2] = 1.0
        r = run_both("lanczos_eigenvalues", ops, x0, k=2, m=20, which="LA", tolerance=1e-10)
        assert bool(r.converged)
        assert int(r.iterations) <= 3
        np.testing.assert_allclose(r.eigenvalues.numpy(), [7.0, 3.0], atol=1e-12)

    def test_hermitian_complex128(self):
        rng = np.random.default_rng(5)
        n = 120
        g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a = (g + g.conj().T) / 2
        a[0, 0] += 40.0
        ops = (J.DenseMatrix.from_array(a), T.DenseMatrix.from_array(a, device="cpu"))
        x0 = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        r = run_both("lanczos_eigenvalues", ops, x0, k=3, m=50, which="LA", tolerance=1e-8)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(np.linalg.eigvalsh(a))[::-1][:3],
                                   rtol=1e-8)

    def test_errors(self, operator):
        for es, M in ((J, operator[0]), (T, operator[1])):
            dev = {} if es is J else {"device": "cpu"}
            with pytest.raises(ValueError, match="square"):
                es.lanczos_eigenvalues(es.DenseMatrix.from_array(np.ones((2, 3)), **dev))
            with pytest.raises(ValueError, match="k must be >= 1"):
                es.lanczos_eigenvalues(M, k=0)
            with pytest.raises(ValueError, match="which"):
                es.lanczos_eigenvalues(M, which="XX")
            with pytest.raises(TypeError, match="scalar type mismatch"):
                es.lanczos_eigenvalues(M, dtype=np.float32)
            with pytest.raises(ValueError, match="must be <= m"):
                es.lanczos_eigenvalues(M, k=5, m=4)


class TestBuildingBlocks:
    def test_decomposition_matches_jax(self, operator, x0):
        Mj, Mt = operator
        Vj, aj, bj, kj = jl.lanczos_decomposition(Mj.matvec, jnp.asarray(x0), 30)
        Vt, at, bt, kt = tl.lanczos_decomposition(Mt.matvec, torch.from_numpy(x0), 30)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-10)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-10)
        np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-9)
        assert int(kt) == int(kj) == 30

    def test_extend_matches_jax(self, operator, x0):
        Mj, Mt = operator
        Vj, _, _, _ = jl.lanczos_decomposition(Mj.matvec, jnp.asarray(x0), 12)
        W0 = np.zeros((21, N))
        W0[:6] = np.asarray(Vj)[:6]
        Wj, aj, bj, kj = jl.lanczos_extend(Mj.matvec, jnp.asarray(W0), 5, 20)
        Wt, at, bt, kt = tl.lanczos_extend(Mt.matvec, torch.from_numpy(W0), 5, 20)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-10)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-10)
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-9)
        assert int(kt) == int(kj)

    def test_interleaved_projection_matches_natural(self, operator, x0):
        """The reorthogonalisation pass over the (R, 128) domain: the basis
        seen as (m + 1, -1) gives the natural layout's coefficients."""
        data = np.asarray(operator[0].data, np.float32)
        _, t32 = pair(data, operator[0].offsets)
        il = t32.interleaved()
        x = torch.from_numpy(x0.astype(np.float32))
        Vn, an, bn, _ = tl.lanczos_decomposition(t32.matvec, x, 20)
        Vi, ai, bi, _ = tl.lanczos_decomposition(il.matvec, il.encode_vec(x), 20)
        np.testing.assert_allclose(ai.numpy(), an.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bi.numpy(), bn.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(il.decode_vec(Vi[7]).numpy(), Vn[7].numpy(), atol=1e-4)


class TestLanczosEigenpairs:
    def test_ritz_vectors_satisfy_residual(self, operator, x0):
        res, Y = run_both("lanczos_eigenpairs", operator, x0, k=4, m=60, which="LA",
                          tolerance=1e-9)
        assert bool(res.converged)
        assert Y.shape == (N, 4)
        A = operator[1].to_dense().numpy()
        for i in range(4):
            y, th = Y[:, i], float(res.eigenvalues[i])
            assert np.linalg.norm(A @ y - th * y) < 1e-7 * (1 + abs(th))
            assert abs(np.linalg.norm(y) - 1) < 1e-8

    def test_interleaved_vectors_decode(self, operator, x0):
        data = np.asarray(operator[0].data, np.float32)
        _, t32 = pair(data, operator[0].offsets)
        il = t32.interleaved()
        res, Y = T.lanczos_eigenpairs(il, k=2, m=60, which="LA", x0=x0,
                                      opts=T.SolverOptions(tolerance=1e-4))
        assert Y.shape == (N, 2)  # decoded from the interleaved domain
        A = il.to_dense().numpy()
        y, th = Y[:, 0].numpy(), float(res.eigenvalues[0])
        assert np.linalg.norm(A @ y - th * y) < 1e-2 * (1 + abs(th))


class TestThickRestart:
    def test_clustered_top_converges_where_plain_fails(self, x0):
        ops = laplacians()
        exact = np.sort(2 - 2 * np.cos(np.arange(1, 301) * np.pi / 301))
        plain = run_both("lanczos_eigenvalues", ops, x0, k=5, m=60, which="LA",
                         tolerance=1e-8)
        assert not bool(plain.converged)
        r = run_both("lanczos_thick_restart", ops, x0, k=5, m=60, which="LA", tolerance=1e-8)
        assert bool(r.converged)
        np.testing.assert_allclose(r.eigenvalues.numpy(), exact[::-1][:5], atol=1e-8)

    def test_smallest_end(self, x0):
        exact = np.sort(2 - 2 * np.cos(np.arange(1, 301) * np.pi / 301))
        r = run_both("lanczos_thick_restart", laplacians(), x0, k=3, m=60, which="SA",
                     tolerance=1e-8)
        assert bool(r.converged)
        np.testing.assert_allclose(r.eigenvalues.numpy(), exact[:3], atol=1e-8)

    def test_separated_spectrum_single_cycle(self, operator, exact, x0):
        r = run_both("lanczos_thick_restart", operator, x0, k=4, m=60, which="LA",
                     tolerance=1e-9)
        assert bool(r.converged)
        np.testing.assert_allclose(r.eigenvalues.numpy(), np.sort(exact)[::-1][:4], rtol=1e-9)

    def test_errors(self, operator):
        for es, M in ((J, operator[0]), (T, operator[1])):
            with pytest.raises(ValueError, match="which"):
                es.lanczos_thick_restart(M, which="LM")
            with pytest.raises(ValueError, match="k must be >= 1"):
                es.lanczos_thick_restart(M, k=0)
            with pytest.raises(ValueError, match="too small"):
                es.lanczos_thick_restart(M, k=4, m=5)
