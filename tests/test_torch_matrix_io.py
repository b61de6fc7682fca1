"""Matrices, protocol, generators and reader of the PyTorch port against the
JAX package, on the CPU.

Both sides get the same numpy inputs. Conversions and layouts must agree
exactly (identical offsets, R, interleaved diagonals, dense forms); error
paths must raise the same exception type with the same message.
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
from pcsc_eigenvalue_solver_project_tpu.core import dtypes as jdt
from pcsc_eigenvalue_solver_project_tpu.matrix import protocol as jproto
from pcsc_eigenvalue_solver_project_tpu.models import generators as jgen
from pcsc_eigenvalue_solver_project_tpu_torch.core import dtypes as tdt
from pcsc_eigenvalue_solver_project_tpu_torch.core.device import resolve_device
from pcsc_eigenvalue_solver_project_tpu_torch.matrix import protocol as tproto
from pcsc_eigenvalue_solver_project_tpu_torch.models import generators as tgen
from pcsc_eigenvalue_solver_project_tpu_torch.ops.gell_spmv import pack_gell
from pcsc_eigenvalue_solver_project_tpu_torch.ops.split_complex import to_planes
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def to_port(m):
    """The port's counterpart of JAX matrix ``m``, on identical data."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def np_of(t):
    """numpy view of a port tensor (bf16 as its bit pattern's float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def raised(fn):
    """(type, message) of the exception ``fn`` raises."""
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def sparse_band(n, offsets, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for off in offsets:
        idx = np.arange(max(0, -off), min(n, n - off))
        a[idx, idx + off] = rng.random(len(idx))
    return a


class TestDIAConversions:
    @pytest.mark.parametrize("n,offsets", [(10, (-2, 0, 3)), (200, (-130, 0, 129)),
                                           (64, (-5, -1, 0, 1, 4))])
    def test_from_csr_matches_jax(self, n, offsets):
        a = sparse_band(n, offsets, seed=n)
        dj = J.SparseDIA.from_csr(J.SparseCSR.from_dense(a))
        dt = T.SparseDIA.from_csr(T.SparseCSR.from_dense(a, device="cpu"))
        assert dt.offsets == dj.offsets == offsets
        np.testing.assert_array_equal(dt.data.numpy(), np.asarray(dj.data))
        np.testing.assert_array_equal(dt.to_dense().numpy(), a)
        assert dt.nnz == dj.nnz and dt.bandwidth == dj.bandwidth

    @pytest.mark.parametrize("tile_s,dtype", [(None, None), (8, None),
                                              (64, "bfloat16"), (8, "bfloat16")])
    def test_interleaved_matches_jax(self, tile_s, dtype):
        mj = jgen.banded_full(3000, bandwidth=5, dtype=np.float32, seed=4)
        mt = tgen.banded_full(3000, bandwidth=5, dtype=np.float32, seed=4, device="cpu")
        il_j = mj.interleaved(tile_s, dtype=None if dtype is None else jnp.bfloat16)
        il_t = mt.interleaved(tile_s, dtype=None if dtype is None else torch.bfloat16)
        assert (il_t.R, il_t.tile_s, il_t.offsets) == (il_j.R, il_j.tile_s, il_j.offsets)
        assert il_t.dtype == (torch.float32 if dtype is None else torch.bfloat16)
        # bit-exact, including bf16 rounding, and through the interop path
        np.testing.assert_array_equal(np_of(il_t.data_il),
                                      np.asarray(il_j.data_il, np.float32))
        np.testing.assert_array_equal(np_of(to_port(il_j).data_il), np_of(il_t.data_il))
        np.testing.assert_array_equal(np_of(il_t.to_dense()),
                                      np.asarray(il_j.to_dense(), np.float32))
        np.testing.assert_array_equal(np_of(il_t.to_natural().data),
                                      np.asarray(il_j.to_natural().data, np.float32))

    def test_from_diagonals_matches_jax(self):
        diags = [np.arange(6.0), np.ones(6), np.full(6, 2.0)]
        dj = J.SparseDIA.from_diagonals(diags, (-2, 0, 1), 6, dtype=np.float64)
        dt = T.SparseDIA.from_diagonals(diags, (-2, 0, 1), 6, dtype=np.float64, device="cpu")
        np.testing.assert_array_equal(dt.data.numpy(), np.asarray(dj.data))

    def test_interleaved_queries_match_jax(self):
        mj = jgen.banded_full(2000, bandwidth=3, dtype=np.float64, seed=7)
        mt = to_port(mj)
        for pj, pt in ((mj, mt), (mj.interleaved(), mt.interleaved())):
            x = np.random.default_rng(0).standard_normal(2000)
            xj, xt = pj.encode_vec(jnp.asarray(x)), pt.encode_vec(torch.from_numpy(x))
            np.testing.assert_allclose(pt.decode_vec(pt.rmatvec(xt)).numpy(),
                                       np.asarray(pj.decode_vec(pj.rmatvec(xj))),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_array_equal(pt.adjoint().to_dense().numpy(),
                                          np.asarray(pj.adjoint().to_dense()))
            np.testing.assert_array_equal(pt.diagonal().numpy(), np.asarray(pj.diagonal()))
            np.testing.assert_allclose(float(pt.spectral_bound()),
                                       float(pj.spectral_bound()), rtol=1e-12)
            lo_t, hi_t = pt.gershgorin_interval()
            lo_j, hi_j = pj.gershgorin_interval()
            np.testing.assert_allclose([float(lo_t), float(hi_t)],
                                       [float(lo_j), float(hi_j)], rtol=1e-12)

    def test_complex_adjoint_matches_jax(self):
        mj = jgen.banded_full(50, bandwidth=3, dtype=np.complex128, seed=6)
        mt = tgen.banded_full(50, bandwidth=3, dtype=np.complex128, seed=6, device="cpu")
        np.testing.assert_array_equal(mt.adjoint().to_dense().numpy(),
                                      np.asarray(mj.adjoint().to_dense()))

    def test_matmat_waits_for_its_kernel(self):
        # the block kernel B5 is ported: matmat is the JAX block SpMM
        mj = jgen.banded_full(100, bandwidth=2, dtype=np.float32, seed=3).interleaved(8)
        il = to_port(mj)
        xs = np.random.default_rng(4).standard_normal((2, il.R, 128)).astype(np.float32)
        np.testing.assert_allclose(il.matmat(torch.from_numpy(xs)).numpy(),
                                   np.asarray(mj.matmat(jnp.asarray(xs))), rtol=1e-5,
                                   atol=1e-5)


class TestDefaultDevice:
    """Constructors put their data on the card unless asked for the CPU."""

    def test_resolve_device(self):
        assert resolve_device(None).type == "cuda"
        assert resolve_device("cpu") == torch.device("cpu")
        assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)

    @pytest.mark.parametrize("build", [
        lambda: T.SparseDIA.from_diagonals([[1.0, 2.0]], (0,), 2),
        lambda: T.read_matrix_from_file(os.path.join(DATA, "A.txt"), torch.complex128),
        lambda: T.read_matrix_from_file(os.path.join(DATA, "B.txt"), torch.complex128,
                                        use_native=False),
        lambda: T.read_matrix_from_text("dense\n1 1\n2\n", np.float64),
        lambda: T.DenseMatrix.from_array(np.eye(2)),
        lambda: T.DenseMatrix.from_flat([1.0, 2.0], 1, 2),
        lambda: T.SparseCSR.from_coo([0], [0], [1.0], (1, 1)),
        lambda: T.SparseCSR.from_dense(np.eye(2)),
        lambda: tgen.dense_random(3),
        lambda: tgen.laplacian_1d(4),
        lambda: tgen.banded_full(10, bandwidth=1),
        lambda: from_numpy_leaves("SparseDIA", [np.ones((1, 3))], {"offsets": (0,),
                                                                   "shape": (3, 3)}),
        lambda: T.SparseGELL.from_coo([0, 1], [1, 0], [1.0, 2.0], (2, 2)),
        lambda: pack_gell([0, 1], [1, 0], np.float32([1.0, 2.0]), (2, 2)),
        lambda: T.from_coo([0, 1], [0, 1], [1.0, 2.0], (2, 2), layout="auto"),
        lambda: T.from_coo([0, 1], [1, 0], [1.0, 2.0], (2, 2), layout="gell"),
    ], ids=["from_diagonals", "read_native", "read_python", "read_text", "from_array",
            "from_flat", "from_coo", "from_dense", "dense_random", "laplacian_1d",
            "banded_full", "from_numpy_leaves", "gell_from_coo", "pack_gell", "auto_from_coo",
            "auto_from_coo_gell"])
    def test_no_device_is_not_the_cpu(self, build):
        if torch.cuda.is_available():
            m = build()
            assert next(v for v in vars(m).values() if isinstance(v, torch.Tensor)).is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()

    @pytest.mark.parametrize("z", [np.array([1 + 2j, -3j]), [0.5, 1.5]], ids=["numpy", "list"])
    def test_to_planes_of_a_host_array_is_not_the_cpu(self, z):
        if torch.cuda.is_available():
            assert to_planes(z).is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                to_planes(z)

    def test_to_planes_of_a_tensor_keeps_its_device(self):
        p = to_planes(torch.tensor([1 + 2j, -3j]))
        assert p.device.type == "cpu" and p.tolist() == [[1.0, 0.0], [2.0, -3.0]]


class TestInterop:
    @pytest.mark.parametrize("make", [
        lambda: J.DenseMatrix.from_array(np.arange(9.0).reshape(3, 3) + 1j, dtype=np.complex128),
        lambda: jgen.laplacian_1d(40),
        lambda: jgen.banded_random(60, bandwidth=3, nnz_per_row=4, seed=2).to_ell(),
        lambda: jgen.banded_full(300, bandwidth=4, dtype=np.float32, seed=1),
        lambda: jgen.banded_full(300, bandwidth=4, dtype=np.float32, seed=1).interleaved(8),
    ], ids=["dense", "csr", "ell", "dia", "il"])
    def test_from_numpy_leaves_round_trip(self, make):
        mj = make()
        mt = to_port(mj)
        assert type(mt).__name__ == type(mj).__name__
        assert mt.shape == tuple(mj.shape)
        np.testing.assert_array_equal(mt.to_dense().numpy(), np.asarray(mj.to_dense()))
        x = np.random.default_rng(3).standard_normal(mt.shape[0])
        x = x.astype(np.asarray(mj.to_dense()).dtype)
        xj, xt = mj.encode_vec(jnp.asarray(x)), mt.encode_vec(torch.from_numpy(x))
        np.testing.assert_allclose(mt.decode_vec(mt.matvec(xt)).numpy(),
                                   np.asarray(mj.decode_vec(mj.matvec(xj))),
                                   rtol=1e-5, atol=1e-5)

    def test_unknown_kind(self):
        with pytest.raises(ValueError, match="unknown matrix kind"):
            from_numpy_leaves("SparseBSR", [], {}, device="cpu")


class TestGenerators:
    @pytest.mark.parametrize("name,args,kwargs", [
        ("dense_random", (12,), dict(dtype=np.complex128, seed=3)),
        ("laplacian_1d", (30,), {}),
        ("laplacian_2d", (5,), {}),
        ("banded_random", (80,), dict(bandwidth=4, nnz_per_row=5, seed=1, diag_boost=2.0)),
        ("banded_full", (90,), dict(bandwidth=3, dtype=np.float64, seed=2, diag_boost=1.5)),
        ("banded_full", (90,), dict(bandwidth=3, dtype=np.complex64, seed=2)),
    ])
    def test_same_matrix_as_jax(self, name, args, kwargs):
        mj = getattr(jgen, name)(*args, **kwargs)
        mt = getattr(tgen, name)(*args, **kwargs, device="cpu")
        assert type(mt).__name__ == type(mj).__name__
        np.testing.assert_array_equal(mt.to_dense().numpy(), np.asarray(mj.to_dense()))

    def test_spectrum(self):
        np.testing.assert_array_equal(tgen.spd_tridiagonal_spectrum(9),
                                      jgen.spd_tridiagonal_spectrum(9))


class TestMatrices:
    def test_csr_and_ell_match_jax(self):
        rng = np.random.default_rng(1)
        a = (rng.random((7, 7)) + 1j * rng.random((7, 7))) * (rng.random((7, 7)) < 0.5)
        a[3, 3] = 2.0
        cj = J.SparseCSR.from_dense(a, dtype=np.complex128)
        ct = T.SparseCSR.from_dense(a, dtype=np.complex128, device="cpu")
        for name in ("data", "indices", "rows", "indptr"):
            np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                          np.asarray(getattr(cj, name)))
        x = rng.random(7) + 1j * rng.random(7)
        np.testing.assert_allclose(ct.matvec(torch.from_numpy(x)).numpy(), a @ x, rtol=1e-12)
        np.testing.assert_allclose(ct.rmatvec(torch.from_numpy(x)).numpy(),
                                   a.conj().T @ x, rtol=1e-12)
        np.testing.assert_array_equal(ct.diagonal().numpy(), np.asarray(cj.diagonal()))
        ej, et = cj.to_ell(), ct.to_ell()
        np.testing.assert_array_equal(et.indices.numpy(), np.asarray(ej.indices))
        np.testing.assert_array_equal(et.data.numpy(), np.asarray(ej.data))
        np.testing.assert_array_equal(et.diagonal().numpy(), np.asarray(ej.diagonal()))
        np.testing.assert_array_equal(et.to_dense().numpy(), a)
        assert (ct.nnz, et.nnz) == (cj.nnz, ej.nnz)

    def test_dense_queries(self):
        a = np.array([[1.0, 2.0], [3.0, 4.0]])
        m = T.DenseMatrix.from_array(a, device="cpu")
        assert m.shape == (2, 2) and m.is_dense and m.dtype == torch.float64
        np.testing.assert_array_equal(m.matvec(torch.ones(2, dtype=torch.float64)).numpy(),
                                      [3.0, 7.0])
        np.testing.assert_array_equal(m.rmatvec(torch.ones(2, dtype=torch.float64)).numpy(),
                                      [4.0, 6.0])
        flat = T.DenseMatrix.from_flat([1, 2, 3, 4, 5, 6], 2, 3, dtype=np.float64,
                                      device="cpu")
        np.testing.assert_array_equal(flat.array.numpy(), [[1, 2, 3], [4, 5, 6]])
        a[0, 0] = 9.0  # the matrix holds a copy
        assert float(m.array[0, 0]) == 1.0

    @pytest.mark.parametrize("case", [
        ("flat size", lambda M, cpu: M.DenseMatrix.from_flat([1, 2, 3], 2, 2, **cpu)),
        ("not 2-D", lambda M, cpu: M.DenseMatrix.from_array([1.0, 2.0], **cpu)),
        ("int dtype", lambda M, cpu: M.DenseMatrix.from_array([[1, 2]], dtype=np.int32, **cpu)),
        ("dense as_csr", lambda M, cpu: M.DenseMatrix.from_array([[1.0]], **cpu).as_csr()),
        ("csr as_dense", lambda M, cpu: M.SparseCSR.from_coo([0], [0], [1.0], (1, 1),
                                                         **cpu).as_dense()),
        ("ell as_csr", lambda M, cpu: M.SparseCSR.from_coo([0], [0], [1.0], (1, 1),
                                                       **cpu).to_ell().as_csr()),
        ("dia as_csr", lambda M, cpu: M.SparseDIA.from_diagonals([[1.0]], (0,), 1, **cpu).as_csr()),
        ("il as_csr", lambda M, cpu: M.SparseDIA.from_diagonals([[1.0]], (0,), 1,
                                                            **cpu).interleaved(8).as_csr()),
        ("coo range", lambda M, cpu: M.SparseCSR.from_coo([0, 2], [0, 0], [1.0, 1.0], (2, 2),
                                                        **cpu)),
        ("coo dup", lambda M, cpu: M.SparseCSR.from_coo([0, 0], [0, 0], [1.0, 2.0], (1, 1),
                                                        sum_duplicates=False, **cpu)),
        ("coo ragged", lambda M, cpu: M.SparseCSR.from_coo([0, 1], [0], [1.0], (2, 2), **cpu)),
        ("dia non-square", lambda M, cpu: M.SparseDIA.from_csr(
            M.SparseCSR.from_coo([0], [1], [1.0], (2, 3), **cpu))),
        ("options", lambda M, cpu: M.SolverOptions(max_iterations=-1)),
        ("tolerance", lambda M, cpu: M.SolverOptions(tolerance=-1e-3)),
    ], ids=lambda c: c[0])
    def test_errors_match_jax(self, case):
        _, fn = case
        assert raised(lambda: fn(T, {"device": "cpu"})) == raised(lambda: fn(J, {}))


class TestProtocolAndDtypes:
    @pytest.mark.parametrize("guard,shape", [("require_square", (2, 3)),
                                             ("require_nonempty", (0, 0)),
                                             ("require_nonempty", (3, 0))])
    def test_guards_match_jax(self, guard, shape):
        mt = T.DenseMatrix.from_array(np.ones(shape), device="cpu")
        mj = J.DenseMatrix.from_array(np.ones(shape))
        fj, ft = getattr(jproto, guard), getattr(tproto, guard)
        assert raised(lambda: ft(mt, "power_method")) == \
            raised(lambda: fj(mj, "power_method"))

    @pytest.mark.parametrize("dtype", [np.int32, np.int64, bool, np.float16])
    def test_scalar_concept_matches_jax(self, dtype):
        assert raised(lambda: tdt.canonical_dtype(dtype)) == \
            raised(lambda: jdt.canonical_dtype(dtype))

    def test_dtype_maps(self):
        for d in (np.float32, np.float64, np.complex64, np.complex128):
            assert tdt.numpy_dtype(tdt.canonical_dtype(d)) == jdt.canonical_dtype(d)
            assert tdt.numpy_dtype(tdt.real_dtype_of(d)) == jdt.real_dtype_of(d)
            assert tdt.numpy_dtype(tdt.complex_dtype_of(d)) == jdt.complex_dtype_of(d)
            assert tdt.is_complex_dtype(d) == jdt.is_complex_dtype(d)
        assert tdt.canonical_dtype(torch.complex64) is torch.complex64
        assert tdt.as_torch_dtype(jnp.bfloat16) is torch.bfloat16
        assert raised(lambda: tdt.check_scalar_type(np.float32, np.float64, "power_method")) \
            == raised(lambda: jdt.check_scalar_type(np.float32, np.float64, "power_method"))

    def test_decode_result(self):
        il = tgen.banded_full(300, bandwidth=2, device="cpu").interleaved(8)
        x = torch.arange(300, dtype=torch.float32)
        res = T.EigenResult(eigenvalue=torch.tensor(1.0), eigenvector=il.encode_vec(x),
                            iterations=torch.tensor(3, dtype=torch.int32),
                            converged=torch.tensor(True))
        out = tproto.decode_result(il, res)
        np.testing.assert_array_equal(out.eigenvector.numpy(), x.numpy())
        assert out.item_iterations() == 3 and out.item_converged()
        assert repr(out) == "EigenResult(eigenvalue=(1+0j), iterations=3, converged=True)"


MALFORMED = [
    ("dense\n2 2\n1 2 3", np.float64),
    ("dense\n1 1\n1", np.complex128),
    ("sparse\n2 2\n1\n0 9 1.0", np.float64),
    ("sparse\n2 2\n0\n", np.float64),
    ("sparse\n2 2\n", np.float64),
    ("sparse\n2 2\n1\nx y 1.0", np.float64),
    ("sparse\n2 2\n1\n0 0 zz", np.float64),
    ("sparse\n2 2\n2\n0 0 1.0\n0 0 2.0", np.float64),
    ("diagonal\n2 2\n", np.float64),
    ("dense\n2\n", np.float64),
    ("dense\n0 2\n", np.float64),
    ("", np.float64),
    ("dense\n1 1\nfoo", np.float64),
]


class TestReader:
    @pytest.mark.parametrize("use_native", [True, False])
    @pytest.mark.parametrize("name", ["A.txt", "B.txt"])
    def test_reference_files_match_jax(self, name, use_native):
        path = os.path.join(DATA, name)
        mj = J.read_matrix_from_file(path, np.complex128, use_native=use_native)
        mt = T.read_matrix_from_file(path, torch.complex128, use_native=use_native,
                                     device="cpu")
        assert type(mt).__name__ == type(mj).__name__
        assert mt.dtype == torch.complex128
        np.testing.assert_array_equal(mt.to_dense().numpy(), np.asarray(mj.to_dense()))

    def test_real_text(self):
        mt = T.read_matrix_from_text("dense\n2 2\n1 2\n3 4\n", np.float64, device="cpu")
        np.testing.assert_array_equal(mt.array.numpy(), [[1, 2], [3, 4]])
        st = T.read_matrix_from_text("sparse\n2 2\n2\n0 1 5\n1 0 -1\n", np.float32,
                                    device="cpu")
        assert st.dtype == torch.float32 and st.nnz == 2

    @pytest.mark.parametrize("text,dtype", MALFORMED)
    def test_malformed_errors_match_jax(self, tmp_path, text, dtype):
        path = str(tmp_path / "bad.txt")
        with open(path, "w") as f:
            f.write(text)
        expect = raised(lambda: J.read_matrix_from_file(path, dtype))
        assert raised(lambda: T.read_matrix_from_file(path, dtype, device="cpu")) == expect
        assert raised(lambda: T.read_matrix_from_text(text, dtype, device="cpu")) == \
            raised(lambda: J.read_matrix_from_text(text, dtype))

    def test_missing_file_matches_jax(self, tmp_path):
        path = str(tmp_path / "absent.txt")
        assert raised(lambda: T.read_matrix_from_file(path, np.float64, device="cpu")) == \
            raised(lambda: J.read_matrix_from_file(path, np.float64))
