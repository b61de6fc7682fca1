"""The automatic layout of the PyTorch port (``matrix/auto.py``) against the
JAX package, on the CPU.

``suggest_layout`` must pick the same kind and the same RCM permutation
(array-equal) with the same statistics as JAX on every pattern of
tests/test_auto_layout.py; ``from_coo`` must build the same kinds and raise
the same messages. Operators are compared on the same numpy inputs.

Tolerances: products relative to max|y|, 1e-5 in float32 and 1e-12 in
float64 (the two sides sum in another order); ``diagonal`` and
``to_dense`` exactly (they move entries, they do not sum them but for the
diagonal's duplicates, which both sum in the same order). ``power_method``
through a ``PermutedOperator`` from the same x0: in float64 equal iteration
counts and the eigenvalue within 1e-10 relative; in float32 the JAX test's
own limits against the dense oracle (tests/test_auto_layout.py:128-153) and
the eigenvalue within 1e-4 of JAX's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu.matrix import auto as jauto
from pcsc_eigenvalue_solver_project_tpu_torch.matrix import auto as tauto

F32_TOL, F64_TOL = 1e-5, 1e-12


def banded_coo(n, bw, rng, shuffle=None, dtype=np.float32):
    """tests/test_auto_layout.py::_banded_coo."""
    i = np.repeat(np.arange(n), 2 * bw + 1)
    off = np.tile(np.arange(-bw, bw + 1), n)
    j = i + off
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    v = rng.standard_normal(len(i)).astype(dtype)
    if shuffle is not None:
        i, j = shuffle[i], shuffle[j]
    return i, j, v


def dense_of(i, j, v, n):
    d = np.zeros((n, n), np.float64)
    np.add.at(d, (i, j), v)
    return d


def rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


def pattern(name):
    """The patterns of tests/test_auto_layout.py, with their arguments, plus
    a shuffled column-local pattern on which RCM cuts the chunk footprint
    (the permuted-GELL branch)."""
    if name == "banded":
        n = 2048
        return banded_coo(n, 8, np.random.default_rng(0)), n, {}
    if name == "uniform":
        rng = np.random.default_rng(1)
        n = 4096
        return (np.repeat(np.arange(n), 6), rng.integers(0, n, 6 * n),
                rng.standard_normal(6 * n).astype(np.float32)), n, {}
    if name in ("shuffled", "shuffled_no_rcm"):
        rng = np.random.default_rng(2)
        n = 2048
        shuffle = rng.permutation(n)
        return banded_coo(n, 4, rng, shuffle=shuffle), n, {"try_rcm": name == "shuffled"}
    if name == "local":
        rng = np.random.default_rng(3)
        n = 65536
        i = np.repeat(np.arange(n), 4)
        j = (i + rng.integers(-8192, 8193, 4 * n)) % n
        return (i, j, rng.standard_normal(4 * n).astype(np.float32)), n, {}
    rng = np.random.default_rng(10)
    n = 32768
    i = np.repeat(np.arange(n), 6)
    j = (i + rng.integers(-300, 301, 6 * n)) % n
    shuffle = rng.permutation(n)
    return (shuffle[i], shuffle[j], rng.standard_normal(6 * n).astype(np.float32)), n, {}


EXPECTED = {"banded": ("dia_il", False), "uniform": ("gell", False),
            "shuffled": ("dia_il", True), "shuffled_no_rcm": ("gell", False),
            "local": ("gell", False), "shuffled_local": ("gell", True)}


class TestDecisionRule:
    @pytest.mark.parametrize("name", list(EXPECTED))
    def test_same_kind_perm_and_stats_as_jax(self, name):
        (i, j, v), n, kw = pattern(name)
        got = T.suggest_layout(i, j, v, (n, n), **kw)
        want = jauto.suggest_layout(i, j, v, (n, n), **kw)
        assert isinstance(got, T.LayoutDecision)
        assert (got.kind, got.perm is not None) == EXPECTED[name]
        assert got.kind == want.kind
        assert (got.perm is None) == (want.perm is None)
        if want.perm is not None:
            np.testing.assert_array_equal(got.perm, want.perm)
        assert got.stats == want.stats

    def test_constants_are_the_jax_rule(self):
        for name in ("MAX_DIAGS", "MIN_DIA_FILL", "_CHUNK", "_TILE_ROWS"):
            assert getattr(tauto, name) == getattr(jauto, name)


class TestFromCoo:
    @pytest.mark.parametrize("layout,kind", [("auto", "InterleavedDIA"),
                                             ("dia_il", "InterleavedDIA"),
                                             ("gell", "SparseGELL"), ("csr", "SparseCSR")])
    def test_kinds_and_matvec_match_jax(self, layout, kind):
        rng = np.random.default_rng(6)
        n = 256
        i, j, v = banded_coo(n, 2, rng)
        mt = T.from_coo(i, j, v, (n, n), layout=layout, device="cpu")
        mj = J.from_coo(i, j, v, (n, n), layout=layout)
        assert type(mt).__name__ == type(mj).__name__ == kind
        x = rng.standard_normal(n).astype(np.float32)
        yt = mt.decode_vec(mt.matvec(mt.encode_vec(torch.from_numpy(x)))).numpy()
        yj = mj.decode_vec(mj.matvec(mj.encode_vec(jnp.asarray(x))))
        assert rel(yt, yj) < F32_TOL
        assert rel(yt, dense_of(i, j, v, n) @ x) < F32_TOL

    @pytest.mark.parametrize("args", [((16, 16), "nope"), ((2, 3), "dia_il"), ((2, 3), "nope")],
                             ids=["unknown", "rectangular_dia", "rectangular_unknown"])
    def test_same_error_messages(self, args):
        shape, layout = args
        msgs = []
        for fn, kw in ((J.from_coo, {}), (T.from_coo, {"device": "cpu"})):
            with pytest.raises(ValueError) as err:
                fn([0], [0], np.float32([1.0]), shape, layout=layout, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def test_rectangular_auto_is_gell(self):
        m = T.from_coo([0, 1], [0, 2], np.float32([1, 2]), (2, 3), layout="auto", device="cpu")
        assert isinstance(m, T.SparseGELL) and m.shape == (2, 3)
        np.testing.assert_array_equal(m.matvec(torch.ones(3)).numpy(), [1.0, 2.0])

    def test_tile_rows_reaches_the_gell_pack(self):
        rng = np.random.default_rng(11)
        i, j, v = banded_coo(64, 1, rng)
        m = T.from_coo(i, j, v, (64, 64), layout="gell", tile_rows=256, device="cpu")
        assert m.pack.tile_rows == 256
        with pytest.raises(ValueError, match="multiple of 128"):
            T.from_coo(i, j, v, (64, 64), layout="gell", tile_rows=100, device="cpu")


def permuted_pair(name, dtype=np.float32):
    """A port and a JAX ``PermutedOperator`` of the same shuffled pattern."""
    if name == "dia":
        rng = np.random.default_rng(5)
        n = 1024
        i, j, v = banded_coo(n, 3, rng, shuffle=rng.permutation(n), dtype=dtype)
    else:
        (i, j, v), n, _ = pattern("shuffled_local")
        v = v.astype(dtype)
    mt = T.from_coo(i, j, v, (n, n), layout="auto", device="cpu")
    mj = J.from_coo(i, j, v, (n, n), layout="auto")
    return mt, mj, (i, j, v, n)


class TestPermutedOperator:
    @pytest.mark.parametrize("name,inner", [("dia", "InterleavedDIA"), ("gell", "SparseGELL")])
    def test_matvec_codec_and_diagonal_match_jax(self, name, inner):
        mt, mj, (i, j, v, n) = permuted_pair(name)
        assert isinstance(mt, T.PermutedOperator) and type(mt.inner).__name__ == inner
        assert type(mj.inner).__name__ == inner
        assert mt.perm.dtype == mt.inv_perm.dtype == torch.int64
        assert mt.device == mt.inner.device == mt.perm.device
        np.testing.assert_array_equal(mt.perm.numpy(), np.asarray(mj.perm))
        np.testing.assert_array_equal(mt.inv_perm.numpy(), np.asarray(mj.inv_perm))
        x = np.random.default_rng(12).standard_normal(n).astype(np.float32)
        enc_t, enc_j = mt.encode_vec(torch.from_numpy(x)), mj.encode_vec(jnp.asarray(x))
        np.testing.assert_array_equal(enc_t.numpy(), np.asarray(enc_j))
        np.testing.assert_array_equal(mt.decode_vec(enc_t).numpy(), x)
        yt = mt.decode_vec(mt.matvec(enc_t)).numpy()
        assert rel(yt, mj.decode_vec(mj.matvec(enc_j))) < F32_TOL
        d = np.zeros(n)
        on = i == j
        np.add.at(d, i[on], v[on].astype(np.float64))
        np.testing.assert_array_equal(mt.diagonal().numpy(), np.asarray(mj.diagonal()))
        np.testing.assert_allclose(mt.diagonal().numpy(), d, rtol=1e-6)
        if name == "dia":
            np.testing.assert_array_equal(mt.to_dense().numpy(), np.asarray(mj.to_dense()))
            assert rel(yt, dense_of(i, j, v, n) @ x) < F32_TOL
            # the block product delegates to the inner layout
            xs = torch.from_numpy(np.stack([x, 2 * x]))
            ys = mt.matmat(torch.stack([mt.encode_vec(row) for row in xs]))
            assert rel(mt.decode_vec(ys[1]).numpy(), 2 * yt) < F32_TOL


class TestSolversOnAutoOperators:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_power_method_through_permuted_operator(self, dtype):
        # tests/test_auto_layout.py:128-153 from the same x0
        rng = np.random.default_rng(7)
        n = 512
        shuffle = rng.permutation(n)
        i, j, v = banded_coo(n, 2, rng, shuffle=shuffle)
        i = np.concatenate([i, np.arange(n)])
        j = np.concatenate([j, np.arange(n)])
        v = np.concatenate([v, np.full(n, 6.0, np.float32)])
        v[-1] = 30.0
        v = v.astype(dtype)
        x0 = np.random.default_rng(13).uniform(-1, 1, n).astype(dtype)
        mt = T.from_coo(i, j, v, (n, n), layout="auto", device="cpu")
        mj = J.from_coo(i, j, v, (n, n), layout="auto")
        assert isinstance(mt, T.PermutedOperator)
        opts = (2000, 1e-8)
        rt = T.power_method(mt, T.SolverOptions(*opts), x0=x0)
        rj = J.power_method(mj, J.SolverOptions(*opts), x0=x0)
        d = dense_of(i, j, v, n)
        ev = np.linalg.eigvals(d)
        lam_oracle = ev[np.argmax(np.abs(ev))]
        lam, lam_j = complex(rt.eigenvalue), complex(np.asarray(rj.eigenvalue))
        assert bool(rt.converged) and bool(rj.converged)
        assert abs(lam - lam_oracle) < 1e-3 * abs(lam_oracle)
        xt = rt.eigenvector.numpy()
        assert np.abs(d @ xt - lam * xt).max() / abs(lam) < 1e-3  # original indexing
        if dtype == np.float64:
            assert int(rt.iterations) == int(rj.iterations)
            assert abs(lam - lam_j) <= 1e-10 * abs(lam_j)
            np.testing.assert_allclose(xt, np.asarray(rj.eigenvector), atol=1e-8)
        else:
            assert abs(lam - lam_j) <= 1e-4 * abs(lam_j)

    def test_auto_matches_handpicked_layout_numerics(self):
        # tests/test_auto_layout.py:155-165
        rng = np.random.default_rng(8)
        n = 1024
        i = np.repeat(np.arange(n), 5)
        j = rng.integers(0, n, 5 * n)
        v = rng.standard_normal(5 * n).astype(np.float32)
        auto = T.from_coo(i, j, v, (n, n), layout="auto", device="cpu")
        hand = T.SparseGELL.from_coo(i, j, v, (n, n), device="cpu")
        assert isinstance(auto, T.SparseGELL)
        x = rng.standard_normal(n).astype(np.float32)
        ya = auto.matvec(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ya, hand.matvec(torch.from_numpy(x)).numpy(), rtol=1e-6)
        yj = J.from_coo(i, j, v, (n, n), layout="auto").matvec(jnp.asarray(x))
        assert rel(ya, yj) < F32_TOL
