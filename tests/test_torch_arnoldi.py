"""Arnoldi and Krylov-Schur of the PyTorch port against the JAX package, on
the CPU (the cases of tests/test_arnoldi.py, and the port's operand kinds).

The same numpy inputs and the same explicit start vector go through the JAX
function and its counterpart in the port (JAX's default start vectors come
from ``jax.random``). On the CPU the port's m x m projection runs
``_qr_eigenvalues_accel``, the function JAX calls.

Tolerances: Ritz values within 1e-10 relative to max|lambda| in
float64/complex128, matched by nearest neighbour (conjugate pairs of equal
modulus come back in either order), with equal QR sweeps and matvec counts;
within 1e-4 in float32, counts not compared (ROADMAP Queue C: float32 sums
run in another order). ``_ks_contract`` is host numpy in both packages and
is compared to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random
from pcsc_eigenvalue_solver_project_tpu.solvers import arnoldi as ja
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.dia import SparseDIA as TSparseDIA
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import arnoldi as ta
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves


def to_port(m):
    """The port's counterpart of JAX matrix ``m``, on identical data."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def dense_pair(a):
    return J.DenseMatrix.from_array(a), T.DenseMatrix.from_array(a, device="cpu")


def assert_ritz(got, want, tol):
    """Nearest-neighbour match of two Ritz sets, relative to max|want|."""
    got, want = list(np.asarray(got)), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    for w in want:
        j = int(np.argmin(np.abs(np.asarray(got) - w)))
        assert abs(got[j] - w) <= tol * scale, (got, want)
        got.pop(j)


def assert_same(rj, rt, tol=1e-10, counts=True):
    assert_ritz(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues), tol)
    assert bool(rt.converged) == bool(rj.converged)
    if counts:
        assert int(rt.iterations) == int(rj.iterations)


class TestDecomposition:
    def test_arnoldi_relation_and_orthonormality(self):
        rng = np.random.default_rng(0)
        a = rng.random((40, 40))
        m = 15
        x0 = rng.random(40)
        Vj, Hj, bj = ja.arnoldi_decomposition(lambda v: jnp.asarray(a) @ v, jnp.asarray(x0), m)
        at = torch.from_numpy(a)
        V, H, brk = ta.arnoldi_decomposition(lambda v: at @ v, torch.from_numpy(x0), m)
        V, H = V.numpy(), H.numpy()
        np.testing.assert_allclose(a @ V[:m].T, V.T @ H, atol=1e-12)
        np.testing.assert_allclose(V @ V.conj().T, np.eye(m + 1), atol=1e-10)
        np.testing.assert_allclose(H, np.asarray(Hj), atol=1e-12)
        np.testing.assert_allclose(V, np.asarray(Vj), atol=1e-10)
        assert int(brk) == int(bj) == m

    def test_breakdown_detected(self):
        a = np.diag([3.0, 2.0, 1.0])
        x0 = np.array([1.0, 0.0, 0.0])
        _, Hj, bj = ja.arnoldi_decomposition(lambda v: jnp.asarray(a) @ v, jnp.asarray(x0), 3)
        at = torch.from_numpy(a)
        _, H, brk = ta.arnoldi_decomposition(lambda v: at @ v, torch.from_numpy(x0), 3)
        assert int(brk) == int(bj) == 1
        assert H[0, 0] == 3.0
        np.testing.assert_array_equal(H.numpy(), np.asarray(Hj))

    def test_complex(self):
        rng = np.random.default_rng(1)
        a = rng.random((20, 20)) + 1j * rng.random((20, 20))
        x0 = rng.random(20) + 1j * rng.random(20)
        _, Hj, _ = ja.arnoldi_decomposition(lambda v: jnp.asarray(a) @ v, jnp.asarray(x0), 10)
        at = torch.from_numpy(a)
        V, H, _ = ta.arnoldi_decomposition(lambda v: at @ v, torch.from_numpy(x0), 10)
        V, H = V.numpy(), H.numpy()
        np.testing.assert_allclose(a @ V[:10].T, V.T @ H, atol=1e-11)
        np.testing.assert_allclose(H, np.asarray(Hj), atol=1e-11)

    def test_extend_matches_jax(self):
        """``arnoldi_extend`` from the same retained basis: the same basis
        and projection coefficients."""
        rng = np.random.default_rng(6)
        a = rng.standard_normal((60, 60))
        V, _, _ = ja.arnoldi_decomposition(lambda v: jnp.asarray(a) @ v,
                                           jnp.asarray(rng.random(60)), 12)
        W0 = np.zeros((13, 60))
        W0[:5] = np.asarray(V)[:5]
        Wj, Hj, bj = ja.arnoldi_extend(lambda v: jnp.asarray(a) @ v, jnp.asarray(W0), 4, 12)
        at = torch.from_numpy(a)
        Wt, Ht, bt = ta.arnoldi_extend(lambda v: at @ v, torch.from_numpy(W0), 4, 12)
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-10)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-10)
        assert int(bt) == int(bj) == 12


class TestRitzValues:
    def test_well_separated_spectrum(self):
        d = np.concatenate([[100.0, 50.0, 25.0], np.linspace(0.1, 1.0, 37)])
        Mj, Mt = dense_pair(np.diag(d))
        x0 = np.random.default_rng(2).uniform(-1, 1, 40)
        rj = J.arnoldi_eigenvalues(Mj, k=3, m=25, x0=x0)
        rt = T.arnoldi_eigenvalues(Mt, k=3, m=25, x0=x0)
        assert_same(rj, rt)
        got = np.sort(rt.eigenvalues.numpy().real)[::-1]
        np.testing.assert_allclose(got, [100.0, 50.0, 25.0], rtol=1e-8)

    def test_nonsymmetric_sparse(self):
        ms = banded_random(300, bandwidth=5, nnz_per_row=6, seed=3)
        x0 = np.random.default_rng(3).uniform(-1, 1, 300)
        rj = J.arnoldi_eigenvalues(ms, k=3, m=60, x0=x0)
        rt = T.arnoldi_eigenvalues(to_port(ms), k=3, m=60, x0=x0)
        assert_same(rj, rt)
        exact = np.linalg.eigvals(np.asarray(ms.to_dense()))
        exact = exact[np.argsort(-np.abs(exact))][:3]
        for e in exact:
            assert min(abs(rt.eigenvalues.numpy() - e)) < 1e-5

    def test_exact_when_m_equals_n(self):
        rng = np.random.default_rng(5)
        a = rng.random((12, 12))
        Mj, Mt = dense_pair(a)
        x0 = rng.uniform(-1, 1, 12)
        rj = J.arnoldi_eigenvalues(Mj, k=12, m=12, x0=x0)
        rt = T.arnoldi_eigenvalues(Mt, k=12, m=12, x0=x0)
        assert_same(rj, rt)
        for e in np.linalg.eigvals(a):
            assert min(abs(rt.eigenvalues.numpy() - e)) < 1e-7

    def test_errors(self):
        for es, dev in ((J, {}), (T, {"device": "cpu"})):
            M = es.DenseMatrix.from_array(np.ones((2, 3)), **dev)
            with pytest.raises(ValueError, match="square"):
                es.arnoldi_eigenvalues(M)
            M2 = es.DenseMatrix.from_array(np.eye(4), **dev)
            with pytest.raises(ValueError, match="k .4. must be <= m"):
                es.arnoldi_eigenvalues(M2, k=4, m=3)
            with pytest.raises(TypeError, match="scalar type mismatch"):
                es.arnoldi_eigenvalues(M2, k=1, dtype=np.complex128)
            with pytest.raises(ValueError, match="k must be >= 1"):
                es.arnoldi_eigenvalues(M2, k=0)

    def test_complex128_operator(self):
        rng = np.random.default_rng(8)
        a = rng.standard_normal((80, 80)) + 1j * rng.standard_normal((80, 80))
        a[0, 0] += 30
        Mj, Mt = dense_pair(a)
        x0 = rng.uniform(-1, 1, 80) + 1j * rng.uniform(-1, 1, 80)
        rj = J.arnoldi_eigenvalues(Mj, k=2, m=30, x0=x0)
        rt = T.arnoldi_eigenvalues(Mt, k=2, m=30, x0=x0)
        assert rt.eigenvalues.dtype == torch.complex128
        assert_same(rj, rt)

    @pytest.mark.parametrize("interleaved", [False, True])
    def test_float32_band(self, interleaved):
        """A float32 band as ``SparseDIA`` and, in the port only (the JAX
        function takes natural-layout vectors), as ``InterleavedDIA``:
        within 1e-4 of JAX's Ritz values on the ``SparseDIA``."""
        rng = np.random.default_rng(9)
        n, offs = 300, (-2, -1, 0, 1, 3)
        data = rng.uniform(-1, 1, (len(offs), n)).astype(np.float32)
        data[2, :3] += (14.0, 10.0, 8.0)
        for d, off in enumerate(offs):
            if off > 0:
                data[d, n - off:] = 0
            elif off < 0:
                data[d, :-off] = 0
        Mj = JSparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))
        Mt = TSparseDIA(data=torch.from_numpy(data), offsets=offs, shape=(n, n))
        if interleaved:
            Mt = Mt.interleaved()
        x0 = rng.uniform(-1, 1, n)
        rj = J.arnoldi_eigenvalues(Mj, k=3, m=30, x0=x0)
        rt = T.arnoldi_eigenvalues(Mt, k=3, m=30, x0=x0)
        assert rt.eigenvalues.dtype == torch.complex64
        assert_same(rj, rt, tol=1e-4, counts=False)

    def test_cuda_projection_takes_the_sweep_kernels(self, monkeypatch):
        """On a CUDA tensor the m x m projection goes to B8 up to
        ``UNBLOCKED_MAX_N`` and to B13 beyond, never to the eager Givens
        loop (the dispatch read with the kernels replaced by spies)."""
        from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked, qr_kernels
        from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as tq
        calls = []

        def spy(name):
            def run(h, max_sweeps, tol, *args, **kw):
                calls.append((name, h.shape[0], h.dtype))
                eig = torch.linalg.eigvals(h)
                return eig, torch.tensor(3), torch.tensor(1)
            return run

        def no_eager(*args, **kw):
            raise AssertionError("eager Givens sweeps on the card's route")

        monkeypatch.setattr(tq, "qr_dispatch", lambda n, device: (
            "cuda_unblocked" if n <= tq.UNBLOCKED_MAX_N else "cuda_blocked"))
        monkeypatch.setattr(tq, "_qr_eigenvalues_accel", no_eager)
        monkeypatch.setattr(qr_kernels, "qr_eig_sweeps", spy("B8"))
        monkeypatch.setattr(qr_eig_blocked, "blocked_sweeps", spy("B13"))
        rng = np.random.default_rng(10)
        a = rng.random((200, 200))
        _, Mt = dense_pair(a)
        for m in (30, 150):
            r = T.arnoldi_eigenvalues(Mt, k=3, m=m, x0=rng.random(200))
            assert int(r.iterations) == 3 and bool(r.converged)
        assert calls == [("B8", 30, torch.complex128), ("B13", 150, torch.complex128)]


class TestKrylovSchur:
    def _clustered(self, n=300, seed=0):
        rng = np.random.default_rng(seed)
        d = np.concatenate([[5.0, 4.9995, 4.999], rng.uniform(0, 4.9, n - 3)])
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
        return (Qo * d) @ Qo.T, np.sort(d)[::-1][:3]

    def test_fixed_m_stagnates_krylov_schur_converges(self):
        A, truth = self._clustered()
        Mj, Mt = dense_pair(A)
        opts_j, opts_t = J.SolverOptions(tolerance=1e-8), T.SolverOptions(tolerance=1e-8)
        x0 = np.random.default_rng(11).uniform(-1, 1, A.shape[0])
        fixed = T.arnoldi_eigenvalues(Mt, k=3, m=15, opts=opts_t, x0=x0)
        fe = np.abs(np.sort(fixed.eigenvalues.numpy().real)[::-1] - truth).max()
        assert_same(J.arnoldi_eigenvalues(Mj, k=3, m=15, opts=opts_j, x0=x0), fixed)
        rj = J.krylov_schur_eigenvalues(Mj, k=3, m=15, opts=opts_j, x0=x0)
        rt = T.krylov_schur_eigenvalues(Mt, k=3, m=15, opts=opts_t, x0=x0)
        assert_same(rj, rt)
        ke = np.abs(np.sort(rt.eigenvalues.numpy().real)[::-1] - truth).max()
        assert fe > 1e-3
        assert bool(rt.converged)
        assert ke < 1e-7

    def test_krylov_schur_nonsymmetric_complex_pair(self):
        rng = np.random.default_rng(5)
        n = 300
        blocks = np.zeros((n, n))
        blocks[0, 0] = blocks[1, 1] = 3.0
        blocks[0, 1], blocks[1, 0] = 2.0, -2.0     # eigs 3 +- 2i
        blocks[2:, 2:] = np.diag(rng.uniform(0, 2.5, n - 2))
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Mj, Mt = dense_pair(Qo @ blocks @ Qo.T)
        x0 = rng.uniform(-1, 1, n)
        rj = J.krylov_schur_eigenvalues(Mj, k=2, m=16, opts=J.SolverOptions(tolerance=1e-8),
                                        x0=x0)
        rt = T.krylov_schur_eigenvalues(Mt, k=2, m=16, opts=T.SolverOptions(tolerance=1e-8),
                                        x0=x0)
        assert_same(rj, rt)
        assert bool(rt.converged)
        got = np.sort_complex(rt.eigenvalues.numpy())
        assert np.abs(got - np.sort_complex(np.array([3 + 2j, 3 - 2j]))).max() < 1e-6

    def test_krylov_schur_validation(self):
        for es, dev in ((J, {}), (T, {"device": "cpu"})):
            with pytest.raises(ValueError, match="square"):
                es.krylov_schur_eigenvalues(es.DenseMatrix.from_array(np.ones((2, 3)), **dev),
                                            k=1)
            with pytest.raises(ValueError, match="k must be >= 1"):
                es.krylov_schur_eigenvalues(es.DenseMatrix.from_array(np.eye(8), **dev), k=0)
            with pytest.raises(ValueError, match="too small"):
                es.krylov_schur_eigenvalues(es.DenseMatrix.from_array(np.eye(8), **dev),
                                            k=5, m=6)

    def test_complex_operator(self):
        """complex128: the complex ordered Schur form and a complex basis."""
        rng = np.random.default_rng(12)
        n = 200
        d = np.concatenate([[6.0 + 1j, 5.9 - 0.5j], rng.uniform(0, 4, n - 2)
                            * np.exp(1j * rng.uniform(0, 6.3, n - 2))])
        Qo, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
        Mj, Mt = dense_pair((Qo * d) @ Qo.conj().T)
        x0 = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        rj = J.krylov_schur_eigenvalues(Mj, k=2, m=12, opts=J.SolverOptions(tolerance=1e-9),
                                        x0=x0)
        rt = T.krylov_schur_eigenvalues(Mt, k=2, m=12, opts=T.SolverOptions(tolerance=1e-9),
                                        x0=x0)
        assert_same(rj, rt)
        assert bool(rt.converged)
        assert_ritz(rt.eigenvalues.numpy(), [6.0 + 1j, 5.9 - 0.5j], 1e-8)


class TestKSContractBlockBoundary:
    """``_ks_contract`` (host numpy/scipy in both packages): equal outputs,
    and the l_eff clamp never cuts a real-Schur 2x2 conjugate block."""

    @staticmethod
    def same(args, kw):
        out_t = ta._ks_contract(*args, **kw)
        out_j = ja._ks_contract(*args, **kw)
        for t, j in zip(out_t, out_j):
            if j is None:
                assert t is None
            else:
                np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-12)
        return out_t

    def test_equal_modulus_spectrum_keeps_blocks_whole(self):
        m = 10
        Hm = np.zeros((m, m))
        for b in range(m // 2):
            c, s = np.cos(0.3 + b), np.sin(0.3 + b)
            Hm[2 * b:2 * b + 2, 2 * b:2 * b + 2] = [[c, -s], [s, c]]
        rng = np.random.default_rng(3)
        for b in range(m // 2):
            Hm[2 * b + 2:, 2 * b:2 * b + 2] = 0.3 * rng.standard_normal((m - 2 * b - 2, 2))
        _, _, conv, Q_l, S_new, _ = self.same((Hm,), dict(beta=0.5, k=3, l_target=m - 1,
                                                            tol=1e-14))
        assert not conv
        l_eff = Q_l.shape[1]
        assert l_eff % 2 == 0
        sub = np.abs(np.diag(S_new, -1))
        for i in range(l_eff - 1):
            if i % 2 == 1:
                assert sub[i] == 0.0
        assert np.abs(Q_l.T @ Hm @ Q_l - S_new).max() < 1e-12

    def test_leading_block_grows_instead_of_emptying(self):
        m = 6
        Hm = np.zeros((m, m))
        c, s = np.cos(0.4), np.sin(0.4)
        Hm[0:2, 0:2] = [[c, -s], [s, c]]
        Hm[2:, 2:] = np.diag([0.1, 0.05, 0.02, 0.01])
        Hm[2:, 0:2] = 0.2 * np.random.default_rng(7).standard_normal((4, 2))
        _, _, conv, Q_l, S_new, _ = self.same((Hm,), dict(beta=0.5, k=1, l_target=1,
                                                            tol=1e-14))
        assert not conv
        l_eff = Q_l.shape[1]
        assert l_eff in (1, 2)
        if l_eff == 1:
            assert np.abs(Q_l.T @ Hm @ Q_l - S_new).max() < 1e-12

    def test_float32_projection_sorts_at_a_gap(self):
        # a float32 projection on which JAX's sort at the l-th modulus itself
        # fails in LAPACK after the reordering (ROADMAP Queue C, C5); the
        # port sorts in float64 halfway across a gap of the moduli
        rng = np.random.default_rng(9)
        m = 20
        Hm = (np.triu(rng.standard_normal((m, m)), -1) * 0.3).astype(np.float32)
        Hm[np.diag_indices(m)] += rng.uniform(0.9, 1.0, m).astype(np.float32)
        with pytest.raises(np.linalg.LinAlgError, match="sort condition"):
            ja._ks_contract(Hm, 0.5, 3, 8, 1e-14)
        _, _, conv, Q_l, S_new, _ = ta._ks_contract(Hm, 0.5, 3, 8, 1e-14)
        l_eff = Q_l.shape[1]  # 8, or 9 where a conjugate pair straddles the cut
        assert not conv and Q_l.dtype == np.float32 and l_eff in (8, 9)
        np.testing.assert_allclose(Q_l.T @ Q_l, np.eye(l_eff), atol=1e-5)
        assert np.abs(Q_l.T @ Hm @ Q_l - S_new).max() < 1e-5
        # the kept block holds the l_eff largest eigenvalues by modulus
        top = np.sort(np.abs(np.linalg.eigvals(Hm.astype(np.float64))))[::-1]
        kept = np.sort(np.abs(np.linalg.eigvals(S_new.astype(np.float64))))[::-1]
        np.testing.assert_allclose(kept, top[:l_eff], rtol=1e-5)

    def test_restarts_validation(self):
        for es, dev in ((J, {}), (T, {"device": "cpu"})):
            with pytest.raises(ValueError, match="restarts must be >= 1"):
                es.krylov_schur_eigenvalues(es.DenseMatrix.from_array(np.eye(8), **dev),
                                            k=2, restarts=0)
