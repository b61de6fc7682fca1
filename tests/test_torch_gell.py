"""General sparse SpMV (B6) of the PyTorch port against the JAX package, on
the CPU.

The same numpy COO goes through the JAX pack (``ops/pallas/gell_spmv.py``:
its Pallas kernel in interpret mode, or its pure-jnp "xla" evaluation) and
through the port's pack and plain version (``ops/gell_spmv.py``, which the
port runs for CPU tensors). The cases are those of tests/test_gell.py. JAX
operators are carried across with ``from_numpy_leaves("SparseGELL", ...)``,
which decodes the JAX pack (``unpack_gell_leaves``).

Tolerances, relative to max|y|: 1e-5 in float32, complex64 and for bf16
values (both sides read the same bf16 values and sum in float32); 1e-12 in
float64 and complex128. The two sides sum the entries of a row in another
order. ``power_method`` on ``to_gell()`` from the same x0: equal iteration
counts, eigenvalues within 1e-6 relative in float64 and complex128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu.ops.pallas import gell_spmv as jg
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as tg
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves

F32_TOL, F64_TOL = 1e-5, 1e-12


def tol(dtype):
    return F64_TOL if np.dtype(dtype) in (np.float64, np.complex128) else F32_TOL


def random_coo(rng, n_rows, n_cols, nnz, dtype):
    """tests/test_gell.py::_random_coo."""
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    v = rng.standard_normal(nnz)
    if np.dtype(dtype).kind == "c":
        v = (v + 1j * rng.standard_normal(nnz)).astype(dtype)
    else:
        v = v.astype(dtype)
    return r, c, v


def random_vec(rng, n, dtype):
    x = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


def jax_gell_leaves(m):
    """A JAX SparseGELL's leaves (numpy, pytree order) and static fields."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {"shape": m.pack.shape, "tile_rows": m.pack.tile_rows,
              "is_complex": m.pack.is_complex, "nnz": m.nnz}
    return leaves, static


def to_port(m):
    leaves, static = jax_gell_leaves(m)
    return from_numpy_leaves("SparseGELL", leaves, static, device="cpu")


def both_products(r, c, v, shape, x, force, tile_rows=128):
    """(JAX y, port y) for the same COO and x."""
    jpack = jg.pack_gell(r, c, v, shape, tile_rows=tile_rows)
    tpack = tg.pack_gell(r, c, v, shape, tile_rows=tile_rows, device="cpu")
    yj = np.asarray(jg.gell_matvec(jpack, jnp.asarray(x), force=force))
    yt = tg.gell_matvec(tpack, torch.from_numpy(x))
    assert yt.dtype == torch.from_numpy(x).dtype
    return jpack, yj, yt.numpy()


class TestPackAndMatvec:
    @pytest.mark.parametrize("force,dtype", [
        ("interpret", np.float32), ("interpret", np.complex64), ("xla", np.float32),
        ("xla", np.float64), ("xla", np.complex64), ("xla", np.complex128)])
    def test_plain_matches_jax_random(self, force, dtype):
        # tests/test_gell.py:39-60
        rng = np.random.default_rng(0)
        r, c, v = random_coo(rng, 500, 700, 9000, dtype)
        x = random_vec(rng, 700, dtype)
        _, yj, yt = both_products(r, c, v, (500, 700), x, force)
        assert rel(yt, yj) < tol(dtype)

    @pytest.mark.parametrize("force", ["xla", "interpret"])
    def test_duplicates_sum(self, force):
        # tests/test_gell.py:62-73: duplicates sum, as the JAX run scan sums them
        r = np.array([3, 3, 3, 3, 7, 7])
        c = np.array([5, 5, 5, 5, 5, 5])
        v = np.array([1.0, 2.0, 3.0, 4.0, 10.0, 20.0], np.float32)
        x = np.zeros(10, np.float32)
        x[5] = 2.0
        _, yj, yt = both_products(r, c, v, (10, 10), x, force)
        np.testing.assert_allclose(yt[[3, 7]], [20.0, 60.0], rtol=1e-6)
        np.testing.assert_allclose(yt, yj, rtol=1e-6)

    @pytest.mark.parametrize("force", ["xla", "interpret"])
    def test_spill_paths(self, force):
        # tests/test_gell.py:75-86: the JAX pack spills (bucket overflow and
        # runs deeper than 8); the port's layout has no spill and y agrees
        rng = np.random.default_rng(1)
        r, c, v = random_coo(rng, 8, 8, 2000, np.float32)
        x = rng.standard_normal(8).astype(np.float32)
        jpack, yj, yt = both_products(r, c, v, (8, 8), x, force)
        assert jpack.n_spill > 0
        assert rel(yt, yj) < 2e-5  # tests/test_gell.py:86: 250 entries a row

    def test_empty_matrix(self):
        # tests/test_gell.py:88-92
        none = np.zeros(0, int)
        jpack = jg.pack_gell(none, none, np.zeros(0, np.float32), (64, 64))
        tpack = tg.pack_gell(none, none, np.zeros(0, np.float32), (64, 64), device="cpu")
        yj = np.asarray(jg.gell_matvec(jpack, jnp.ones(64, jnp.float32), force="xla"))
        yt = tg.gell_matvec(tpack, torch.ones(64)).numpy()
        np.testing.assert_array_equal(yt, np.zeros(64))
        np.testing.assert_array_equal(yt, yj)
        assert tpack.nnz == 0 and tpack.indptr.tolist() == [0] * 65

    @pytest.mark.parametrize("force", ["xla", "interpret"])
    def test_multi_tile_and_wide_columns(self, force):
        # tests/test_gell.py:94-105: 700 x 40000, three row tiles and three
        # gather chunks in the JAX pack
        rng = np.random.default_rng(2)
        r, c, v = random_coo(rng, 700, 40_000, 15_000, np.float32)
        x = rng.standard_normal(40_000).astype(np.float32)
        jpack, yj, yt = both_products(r, c, v, (700, 40_000), x, force, tile_rows=256)
        assert jpack.n_chunks == 3 and jpack.n_tiles == 3
        assert rel(yt, yj) < F32_TOL

    @pytest.mark.parametrize("dtype", [np.float32, np.complex64])
    def test_bf16_values_match_jax_bf16_pack(self, dtype):
        rng = np.random.default_rng(3)
        r, c, v = random_coo(rng, 300, 400, 5000, dtype)
        x = random_vec(rng, 400, dtype)
        jpack = jg.pack_gell(r, c, v, (300, 400), tile_rows=128).with_values_dtype(jnp.bfloat16)
        yj = np.asarray(jg.gell_matvec(jpack, jnp.asarray(x), force="xla"))
        tpack = tg.pack_gell(r, c, v, (300, 400), device="cpu").with_values_dtype(torch.bfloat16)
        assert tpack.values.dtype == torch.bfloat16
        assert tpack.dtype == (torch.complex64 if np.dtype(dtype).kind == "c" else torch.bfloat16)
        assert tpack.vector_dtype == torch.from_numpy(x).dtype
        yt = tg.gell_matvec(tpack, torch.from_numpy(x)).numpy()
        assert rel(yt, yj) < F32_TOL

    def test_inf_in_x_reaches_only_the_rows_that_hold_its_column(self):
        rng = np.random.default_rng(4)
        r, c, v = random_coo(rng, 200, 150, 600, np.float32)
        x = rng.standard_normal(150).astype(np.float32)
        x[c[0]] = np.inf
        _, yj, yt = both_products(r, c, v, (200, 150), x, "xla")
        hit = np.zeros(200, bool)
        hit[r[c == c[0]]] = True
        assert not np.isfinite(yt[hit]).any()
        assert np.isfinite(yt[~hit]).all()
        np.testing.assert_array_equal(np.isfinite(yj), np.isfinite(yt))
        assert rel(yt[~hit], yj[~hit]) < F32_TOL


class TestPlanes:
    @pytest.mark.parametrize("force,dtype", [("interpret", np.complex64), ("xla", np.complex64),
                                             ("xla", np.complex128)])
    def test_planes_match_jax(self, force, dtype):
        rng = np.random.default_rng(5)
        r, c, v = random_coo(rng, 300, 1000, 6000, dtype)
        x = random_vec(rng, 1000, dtype)
        planes = np.stack([x.real, x.imag])
        jpack = jg.pack_gell(r, c, v, (300, 1000), tile_rows=128)
        tpack = tg.pack_gell(r, c, v, (300, 1000), device="cpu")
        yj = np.asarray(jg.gell_matvec_planes(jpack, jnp.asarray(planes), force=force))
        yt = tg.gell_matvec_planes(tpack, torch.from_numpy(planes))
        assert yt.shape == (2, 300) and yt.dtype == torch.from_numpy(planes).dtype
        assert rel(yt.numpy(), yj) < tol(dtype)
        # the planes product is the native complex product
        yc = tg.gell_matvec(tpack, torch.from_numpy(x)).numpy()
        assert rel(yt[0].numpy() + 1j * yt[1].numpy(), yc) < tol(dtype)

    def test_real_pack_is_refused_with_the_jax_words(self):
        r, c, v = np.array([0]), np.array([0]), np.array([1.0], np.float32)
        msgs = []
        for fn, pack, planes in (
                (jg.gell_matvec_planes, jg.pack_gell(r, c, v, (2, 2)), jnp.zeros((2, 2))),
                (tg.gell_matvec_planes, tg.pack_gell(r, c, v, (2, 2), device="cpu"),
                 torch.zeros((2, 2)))):
            with pytest.raises(ValueError) as err:
                fn(pack, planes)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == "gell_matvec_planes: pack is not complex"


class TestSparseGELLMatrix:
    def test_to_gell_matches_csr(self):
        # tests/test_gell.py:116-126
        rng = np.random.default_rng(3)
        r, c, v = random_coo(rng, 300, 300, 4000, np.float64)
        csr = T.SparseCSR.from_coo(r, c, v, (300, 300), device="cpu")
        g = csr.to_gell()
        assert isinstance(g, T.SparseGELL) and g.device == csr.device
        assert g.shape == (300, 300) and not g.is_dense and g.dtype == torch.float64
        x = torch.from_numpy(rng.standard_normal(300))
        np.testing.assert_allclose(g.matvec(x).numpy(), csr.matvec(x).numpy(), rtol=1e-10)
        gj = J.SparseCSR.from_coo(r, c, v, (300, 300)).to_gell()
        assert rel(g.matvec(x).numpy(), gj.matvec(jnp.asarray(x.numpy()))) < F64_TOL

    @pytest.mark.parametrize("shape", [(3, 3), (3, 5), (5, 3)])
    def test_diagonal_sums_duplicates(self, shape):
        # tests/test_gell.py:128-133, with a duplicate on the diagonal
        r = np.array([0, 1, 2, 0, 2, 2, 1])
        c = np.array([0, 1, 2, 2, 0, 2, 1])
        v = np.array([1.0, 2.0, 3.0, 9.0, 8.0, 4.0, 0.5])
        g = T.SparseGELL.from_coo(r, c, v, shape, device="cpu")
        gj = J.SparseGELL.from_coo(r, c, v, shape)
        np.testing.assert_array_equal(g.diagonal().numpy(), np.asarray(gj.diagonal()))
        np.testing.assert_allclose(g.diagonal().numpy(), [1.0, 2.5, 7.0])
        assert g.nnz == gj.nnz == 7 and g.pack.nnz == 7

    def test_index_out_of_range(self):
        msgs = []
        for cls, kw in ((J.SparseGELL, {}), (T.SparseGELL, {"device": "cpu"})):
            with pytest.raises(ValueError, match="out of range") as err:
                cls.from_coo([0], [5], [1.0], (3, 3), **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        with pytest.raises(ValueError, match="out of range"):
            tg.pack_gell([-1], [0], [1.0], (3, 3), device="cpu")

    def test_tile_rows_error_words_and_record(self):
        one = (np.array([0]), np.array([0]), np.array([1.0], np.float32), (4, 4))
        msgs = []
        for fn, kw in ((jg.pack_gell, {}), (tg.pack_gell, {"device": "cpu"}),
                       (J.SparseGELL.from_coo, {}), (T.SparseGELL.from_coo, {"device": "cpu"})):
            with pytest.raises(ValueError) as err:
                fn(*one, tile_rows=100, **kw)
            msgs.append(str(err.value))
        assert msgs == ["pack_gell: tile_rows must be a multiple of 128"] * 4
        assert tg.pack_gell(*one, tile_rows=256, device="cpu").tile_rows == 256
        assert T.SparseCSR.from_coo(*one[:3], (4, 4), device="cpu").to_gell(
            tile_rows=384).pack.tile_rows == 384

    def test_scalar_concept(self):
        with pytest.raises(TypeError, match="scalar concept"):
            T.SparseGELL.from_coo([0], [0], np.array([1], np.int32), (2, 2), device="cpu")
        with pytest.raises(TypeError, match="unsupported value dtype"):
            tg.pack_gell([0], [0], np.array([1], np.int32), (2, 2), device="cpu")

    @pytest.mark.parametrize("nnz,n_rows,group", [(0, 10, 4), (10, 10, 4), (60, 10, 8),
                                                  (330, 10, 32), (2000, 10, 32)])
    def test_group_width(self, nnz, n_rows, group):
        # the mean row lengths 1, 6, 33 and 200 give 4, 8, 32 and 32 lanes
        assert tg.group_width(nnz, n_rows) == group


def runs_coo(rng):
    """Rows whose entries share a lane bucket (col % 128): runs of 1 to 10
    members in the JAX pack, the last two deeper than 8 (spilled), plus
    exact duplicates and scattered entries."""
    rows, cols = [], []
    for k in range(1, 11):
        rows += [k] * k
        cols += list(5 + 128 * np.arange(k))
    rows += [12] * 3 + list(rng.integers(0, 40, 300))
    cols += [7] * 3 + list(rng.integers(0, 1300, 300))
    return np.array(rows), np.array(cols), rng.standard_normal(len(rows)), (40, 1300)


def coo_case(name):
    rng = np.random.default_rng(6)
    if name == "runs":
        r, c, v, shape = runs_coo(rng)
        return r, c, v.astype(np.float32), shape
    if name == "spill":
        r, c, v = random_coo(rng, 8, 8, 2000, np.float32)
        return r, c, v, (8, 8)
    dtype = {"f32": np.float32, "f64": np.float64, "c64": np.complex64,
             "c128": np.complex128, "wide": np.float32}[name]
    n_cols = 40_000 if name == "wide" else 700
    r, c, v = random_coo(rng, 500, n_cols, 9000, dtype)
    return r, c, v, (500, n_cols)


def sorted_coo(r, c, v):
    """The COO as a sorted list of (row, col, value) with value as
    (re, im) pairs for complex data."""
    pairs = np.stack([v.real, v.imag], -1) if np.iscomplexobj(v) else v.reshape(-1, 1)
    order = np.lexsort(tuple(pairs.T[::-1]) + (c, r))
    return r[order], c[order], pairs[order]


class TestCarryAcross:
    @pytest.mark.parametrize("name", ["f32", "f64", "c64", "c128", "runs", "spill", "wide"])
    def test_unpack_gives_back_the_coo(self, name):
        r, c, v, shape = coo_case(name)
        m = J.SparseGELL.from_coo(r, c, v, shape, tile_rows=256 if name == "wide" else 128)
        if name in ("runs", "spill"):
            assert m.pack.n_spill > 0 and m.pack.scan_steps == 3
        leaves, static = jax_gell_leaves(m)
        ru, cu, vu = tg.unpack_gell_leaves(*leaves[:6], static["tile_rows"],
                                           static["is_complex"])
        if np.iscomplexobj(v):
            vu = vu[:, 0] + 1j * vu[:, 1]
        for got, want in zip(sorted_coo(ru, cu, vu.astype(v.dtype)), sorted_coo(r, c, v)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("name", ["f32", "f64", "c64", "c128", "runs", "spill", "wide"])
    def test_from_numpy_leaves_gives_the_same_product(self, name):
        r, c, v, shape = coo_case(name)
        m = J.SparseGELL.from_coo(r, c, v, shape, tile_rows=256 if name == "wide" else 128)
        mt = to_port(m)
        assert isinstance(mt, T.SparseGELL) and mt.shape == shape and mt.nnz == m.nnz
        assert mt.pack.tile_rows == m.pack.tile_rows and mt.dtype == torch.from_numpy(v).dtype
        x = random_vec(np.random.default_rng(7), shape[1], v.dtype)
        yj = np.asarray(m.matvec(jnp.asarray(x)))
        assert rel(mt.matvec(torch.from_numpy(x)).numpy(), yj) < tol(v.dtype)
        np.testing.assert_array_equal(mt.diagonal().numpy(), np.asarray(m.diagonal()))

    def test_bf16_pack_leaves(self):
        rng = np.random.default_rng(8)
        r, c, v = random_coo(rng, 300, 300, 3000, np.complex64)
        m = J.SparseGELL.from_coo(r, c, v, (300, 300))
        m = dataclasses.replace(m, pack=m.pack.with_values_dtype(jnp.bfloat16))
        mt = to_port(m)
        assert mt.pack.values.dtype == torch.bfloat16 and mt.dtype == torch.complex64
        x = random_vec(rng, 300, np.complex64)
        yj = np.asarray(jg.gell_matvec(m.pack, jnp.asarray(x), force="xla"))
        assert rel(mt.matvec(torch.from_numpy(x)).numpy(), yj) < F32_TOL


class TestDispatch:
    """The plain versions run only for CPU tensors; anything else goes to a
    kernel wrapper, which launches or raises."""

    def test_non_cpu_pack_never_takes_the_plain_path(self):
        pack = tg.pack_gell([0, 1], [1, 0], np.float32([1, 2]), (2, 2), device="cpu")
        meta = tg.GELLPack(indptr=pack.indptr.to("meta"), indices=pack.indices.to("meta"),
                           values=pack.values.to("meta"), shape=(2, 2), group=pack.group)
        tg.reset_launch_counts()
        with pytest.raises(ValueError, match="expected a CUDA device"):
            tg.gell_matvec(meta, torch.empty(2, device="meta"))
        cpack = tg.pack_gell([0], [1], np.complex64([1j]), (2, 2), device="cpu")
        cmeta = dataclasses.replace(cpack, indptr=cpack.indptr.to("meta"),
                                    indices=cpack.indices.to("meta"),
                                    values=cpack.values.to("meta"))
        with pytest.raises(ValueError, match="expected a CUDA device"):
            tg.gell_matvec_planes(cmeta, torch.empty((2, 2), device="meta"))
        assert _build._lib is None  # rejected before any build
        assert [k.launches for k in tg.KERNELS] == [0, 0]
        assert {k.__name__ for k in tg.KERNELS} == {"gell_kernel", "gell_planes_kernel"}


class TestPowerMethod:
    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_power_method_on_gell_matches_jax(self, dtype):
        # tests/test_gell.py:135-150 from the same x0
        rng = np.random.default_rng(4)
        n = 200
        a = rng.standard_normal((n, n)) * 0.1
        if np.dtype(dtype).kind == "c":
            a = a + 0.1j * rng.standard_normal((n, n))
        a[np.diag_indices(n)] += np.linspace(1.0, 3.0, n)
        a = ((a + a.conj().T) / 2).astype(dtype)
        x0 = random_vec(np.random.default_rng(9), n, dtype)
        opts = (5000, 1e-12)
        rj = J.power_method(J.SparseCSR.from_dense(a).to_gell(), J.SolverOptions(*opts), x0=x0)
        rt = T.power_method(T.SparseCSR.from_dense(a, device="cpu").to_gell(),
                            T.SolverOptions(*opts), x0=x0)
        assert bool(rt.converged) and bool(rj.converged)
        assert int(rt.iterations) == int(rj.iterations)
        lam_j, lam_t = complex(np.asarray(rj.eigenvalue)), complex(rt.eigenvalue)
        assert abs(lam_t - lam_j) <= 1e-6 * abs(lam_j)
        np.testing.assert_allclose(lam_t.real, np.max(np.linalg.eigvalsh(a)), rtol=1e-6)
