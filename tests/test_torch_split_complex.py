"""The split-plane complex path of the PyTorch port against the JAX package,
on the CPU.

The same numpy inputs go through the JAX functions and through the port
(``ops/split_complex.py``, ``ops/dia_spmv.py``'s planes entries,
``matrix/split_complex.py``, ``power_method`` on split operators); JAX
matrices are carried across with ``from_numpy_leaves(..., device="cpu")``.

Tolerances:
- Plane algebra: 1e-12 relative in float64 (the same operations).
- ``dia_matvec_planes_plain`` against the Pallas planes kernel in interpret
  mode: rtol = atol = 2e-5 (tests/test_split_complex.py:80-81; float32 sums in
  another order). The Pallas row-major planes kernel rounds x and y to its
  planes' dtype, so bf16 planes are compared as the float32 planes holding
  the same bf16 values there; the port widens bf16 to float32, as the
  interleaved kernel does.
- ``dia_matvec_il_planes_plain`` against ``dia_matvec_il_planes`` in
  interpret mode: 2e-4 (tests/test_split_complex.py:163), f32 and bf16 planes.
- ``power_method`` on both split kinds against JAX on the same ``x0``:
  iterations equal, lambda within 1e-6 in float64 planes and 1e-4 in float32.
  The float32 runs stop at tol 1e-4: at 1e-6 the stopping test sits within a
  few float32 roundings of the Rayleigh quotient's step, and sums taken in
  another order stop a few iterations apart (144 against 140 measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu import SolverOptions as JSolverOptions
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.matrix.split_complex import (
    SplitComplexDIA as JSplit)
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random
from pcsc_eigenvalue_solver_project_tpu.ops import split_complex as jsc
from pcsc_eigenvalue_solver_project_tpu.ops.pallas import dia_spmv as jds
from pcsc_eigenvalue_solver_project_tpu.solvers.power import (
    power_method_split_complex as j_power_split)
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as tds
from pcsc_eigenvalue_solver_project_tpu_torch.ops import split_complex as tsc
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves, to_tensor


def to_port(m):
    """The port's counterpart of JAX matrix ``m``, on identical data."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def band_planes(n, offsets, seed, dtype=np.float32):
    """(2, k, n) re/im diagonal planes, zero outside the matrix."""
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((2, len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    return planes.astype(dtype)


def bf16_values(a):
    """The bf16 rounding of ``a``, as a JAX bf16 array and as float32."""
    b = jnp.asarray(a, jnp.bfloat16)
    return b, np.asarray(b.astype(jnp.float32))


class TestPlaneAlgebra:
    def setup_method(self):
        rng = np.random.default_rng(0)
        self.a = rng.standard_normal((2, 10))
        self.b = rng.standard_normal((2, 10))
        self.s = np.array([2.0, -1.0])

    def test_roundtrip_matches_jax(self):
        z = np.array([1 + 2j, -3 + 0.5j])
        for src in (z, z.astype(np.complex64), np.array([1.5, -2.0], np.float32)):
            p = tsc.to_planes(src, device="cpu")
            np.testing.assert_array_equal(p.numpy(), np.asarray(jsc.to_planes(src)))
            assert p.dtype == (torch.float64 if src.dtype == np.complex128 else torch.float32)
            np.testing.assert_array_equal(tsc.from_planes(p), jsc.from_planes(jsc.to_planes(src)))

    @pytest.mark.parametrize("name", ["splitc_mul", "splitc_vdot", "splitc_div_scalar"])
    def test_binary_ops_match_jax(self, name):
        other = self.s if name == "splitc_div_scalar" else self.b
        got = getattr(tsc, name)(torch.from_numpy(self.a), torch.from_numpy(other))
        want = getattr(jsc, name)(jnp.asarray(self.a), jnp.asarray(other))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)

    def test_unary_ops_match_jax(self):
        a, s = torch.from_numpy(self.a), torch.from_numpy(self.s)
        np.testing.assert_allclose(float(tsc.splitc_norm(a)),
                                   float(jsc.splitc_norm(jnp.asarray(self.a))), rtol=1e-12)
        np.testing.assert_allclose(float(tsc.splitc_abs(s)),
                                   float(jsc.splitc_abs(jnp.asarray(self.s))), rtol=1e-12)
        np.testing.assert_array_equal(tsc.splitc_scale(a, 0.5).numpy(),
                                      np.asarray(jsc.splitc_scale(jnp.asarray(self.a), 0.5)))

    @pytest.mark.parametrize("delta,tol", [(5.9e-9, 1e-9), (6.1e-9, 1e-9), (0.0, 0.0)])
    def test_is_close_relative_matches_jax(self, delta, tol):
        a = np.array([3.0, 4.0])
        b = a + np.array([delta, 0.0])
        got = bool(tsc.splitc_is_close_relative(torch.from_numpy(a), torch.from_numpy(b), tol))
        assert got == bool(jsc.splitc_is_close_relative(jnp.asarray(a), jnp.asarray(b), tol))

    def test_div_by_zero_scalar_matches_jax(self):
        z = np.zeros(2)
        got = tsc.splitc_div_scalar(torch.from_numpy(self.a), torch.from_numpy(z))
        want = jsc.splitc_div_scalar(jnp.asarray(self.a), jnp.asarray(z))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# tests/test_split_complex.py:68-72
ROWMAJOR_CASES = [(16384, (-1, 0, 1)), (20000, tuple(range(-8, 9))), (16384, (-130, 0, 129))]
# tests/test_split_complex.py:153-166, and the row-major offsets at an n whose
# R (192) holds the (-130, 0, 129) halo
IL_CASES = [(20000, (-7, -2, 0, 3, 7)), (20000, (-1, 0, 1)), (20000, tuple(range(-8, 9))),
            (20000, (-130, 0, 129))]


class TestPlanesKernels:
    @pytest.mark.parametrize("storage", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,offsets", ROWMAJOR_CASES)
    def test_rowmajor_plain_matches_pallas(self, n, offsets, storage):
        planes = band_planes(n, offsets, seed=7)
        xp = np.random.default_rng(8).random((2, n)).astype(np.float32)
        if storage == "bfloat16":
            planes_j, planes_f32 = bf16_values(planes)
            planes_t = to_tensor(np.asarray(planes_j))
            assert planes_t.dtype == torch.bfloat16
        else:
            planes_f32 = planes
            planes_t = torch.from_numpy(planes)
        y_jax = jds.dia_matvec_planes(jnp.asarray(planes_f32), offsets, jnp.asarray(xp),
                                      force="interpret")
        y = tds.dia_matvec_planes(planes_t, offsets, torch.from_numpy(xp))
        assert y.dtype == torch.float32 and y.shape == (2, n)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("storage", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,offsets", IL_CASES)
    def test_interleaved_plain_matches_pallas(self, n, offsets, storage):
        planes = band_planes(n, offsets, seed=1)
        zp = np.random.default_rng(2).standard_normal((2, n)).astype(np.float32)
        planes_j = jnp.asarray(planes) if storage == "float32" else bf16_values(planes)[0]
        il_j = JSplit(planes=planes_j, offsets=offsets, shape=(n, n)).interleaved()
        x_il_j = il_j.encode_vec(jnp.asarray(zp))
        y_jax = jds.dia_matvec_il_planes(il_j.planes_il, offsets, x_il_j, force="interpret")
        il_t = to_port(il_j)
        assert il_t.dtype == (torch.float32 if storage == "float32" else torch.bfloat16)
        x_il = il_t.encode_vec(torch.from_numpy(zp))
        np.testing.assert_array_equal(x_il.numpy(), np.asarray(x_il_j))
        y = tds.dia_matvec_il_planes(il_t.planes_il, offsets, x_il)
        assert y.dtype == torch.float32 and y.shape == (2, il_t.R, 128) and y.is_contiguous()
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=2e-4, atol=2e-4)
        # and the interleaved result is the row-major one through the codec
        y_nat = tds.dia_matvec_planes_plain(to_port(il_j).to_natural().planes, offsets,
                                            torch.from_numpy(zp))
        np.testing.assert_allclose(il_t.decode_vec(y).numpy(), y_nat.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_window_is_built_per_plane(self):
        # the halo of the im plane comes from the im plane: a window copied
        # across planes would pass a band without lane seams
        n, offsets = 20000, (-9, 0, 9)
        R = tds.il_rows(n)
        x_il = torch.from_numpy(np.random.default_rng(3).standard_normal((2, R, 128)))
        w = tds._il_window(x_il, tds.il_window_halo(offsets))
        for p in range(2):
            np.testing.assert_array_equal(
                w[p].numpy(), tds._il_window(x_il[p], tds.il_window_halo(offsets)).numpy())

    def test_complex_dia_matches_planes(self):
        # tests/test_split_complex.py:83-93 through the port
        n, offsets = 300, (-2, 0, 3)
        rng = np.random.default_rng(9)
        data = band_planes(n, offsets, seed=9, dtype=np.float64)
        dia = T.SparseDIA(data=torch.from_numpy(data[0] + 1j * data[1]), offsets=offsets,
                          shape=(n, n))
        M = T.SplitComplexDIA.from_complex_dia(dia, precision=np.float64)
        x = rng.random(n) + 1j * rng.random(n)
        y_complex = dia.matvec(torch.from_numpy(x)).numpy()
        y_planes = tsc.from_planes(M.matvec(tsc.to_planes(x, device="cpu")))
        np.testing.assert_allclose(y_planes, y_complex, rtol=1e-10)

    def test_error_messages_match_jax(self):
        offsets = tuple(range(-20, 21))
        vals = np.zeros((2, len(offsets), 8, 128), np.float32)
        x = np.zeros((2, 8, 128), np.float32)
        msgs = []
        for fn, arg in ((jds.dia_matvec_il_planes, jnp.asarray),
                        (tds.dia_matvec_il_planes, torch.from_numpy)):
            with pytest.raises(ValueError) as err:
                fn(arg(vals), offsets, arg(x))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == "dia_matvec_il_planes: bandwidth exceeds chunk size R"


class TestOperators:
    @pytest.mark.parametrize("precision", [np.float32, np.float64])
    def test_split_dia_matches_jax(self, precision):
        n, offsets = 500, (-3, 0, 2, 5)
        data = band_planes(n, offsets, seed=4, dtype=np.float64)
        cdata = data[0] + 1j * data[1]
        mj = JSplit.from_complex_dia(JSparseDIA(data=jnp.asarray(cdata), offsets=offsets,
                                                shape=(n, n)), precision=precision)
        mt = T.SplitComplexDIA.from_complex_dia(
            T.SparseDIA(data=torch.from_numpy(cdata), offsets=offsets, shape=(n, n)),
            precision=precision)
        np.testing.assert_array_equal(mt.planes.numpy(), np.asarray(mj.planes))
        assert mt.nnz == mj.nnz and mt.offsets == mj.offsets and mt.shape == mj.shape
        np.testing.assert_array_equal(mt.diagonal_planes().numpy(),
                                      np.asarray(mj.diagonal_planes()))
        np.testing.assert_array_equal(mt.to_dense_planes().numpy(),
                                      np.asarray(mj.to_dense_planes()))
        np.testing.assert_array_equal(mt.to_complex_dense(), mj.to_complex_dense())
        ij, it = mj.interleaved(8), mt.interleaved(8)
        assert (it.R, it.tile_s) == (ij.R, ij.tile_s)
        np.testing.assert_array_equal(it.planes_il.numpy(), np.asarray(ij.planes_il))
        np.testing.assert_array_equal(it.to_natural().planes.numpy(),
                                      np.asarray(ij.to_natural().planes))
        np.testing.assert_array_equal(it.diagonal_planes().numpy(),
                                      np.asarray(ij.diagonal_planes()))
        np.testing.assert_array_equal(it.to_complex_dense(), ij.to_complex_dense())
        x = np.random.default_rng(5).standard_normal((2, n)).astype(precision)
        for pj, pt in ((mj, mt), (ij, it)):
            xj, xt = pj.encode_vec(jnp.asarray(x)), pt.encode_vec(torch.from_numpy(x))
            np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
            np.testing.assert_array_equal(pt.decode_vec(xt).numpy(), x)
            tol = 1e-5 if precision == np.float32 else 1e-12
            np.testing.assert_allclose(pt.decode_vec(pt.matvec(xt)).numpy(),
                                       np.asarray(pj.decode_vec(pj.matvec(xj))),
                                       rtol=tol, atol=tol)

    def test_from_csr_and_leaves_match_jax(self):
        m = banded_random(120, bandwidth=3, nnz_per_row=4, seed=6, dtype=np.complex128)
        mj = JSplit.from_csr(m, precision=np.float64)
        mt = T.SplitComplexDIA.from_csr(to_port(m), precision=np.float64)
        np.testing.assert_array_equal(mt.planes.numpy(), np.asarray(mj.planes))
        for kind in (mj, mj.interleaved()):
            back = to_port(kind)
            assert type(back).__name__ == type(kind).__name__
            np.testing.assert_array_equal(back.to_complex_dense(), kind.to_complex_dense())

    def test_absent_main_diagonal(self):
        mt = T.SplitComplexDIA(planes=torch.ones((2, 1, 6)), offsets=(1,), shape=(6, 6))
        np.testing.assert_array_equal(mt.diagonal_planes().numpy(), np.zeros((2, 6)))
        np.testing.assert_array_equal(mt.interleaved(8).diagonal_planes().numpy(),
                                      np.zeros((2, 6)))


def split_pair(n, offsets, seed, precision):
    data = band_planes(n, offsets, seed=seed, dtype=np.float64)
    mj = JSplit(planes=jnp.asarray(data.astype(precision)), offsets=offsets, shape=(n, n))
    return mj, to_port(mj)


class TestPowerMethod:
    @pytest.mark.parametrize("interleaved", [False, True], ids=["natural", "interleaved"])
    @pytest.mark.parametrize("precision,tol,limit", [(np.float64, 1e-10, 1e-6),
                                                     (np.float32, 1e-4, 1e-4)])
    def test_matches_jax_on_same_x0(self, precision, tol, limit, interleaved):
        mj, mt = split_pair(300, (-2, 0, 1), seed=3, precision=precision)
        if interleaved:
            mj, mt = mj.interleaved(), mt.interleaved()
        x0 = np.random.default_rng(11).uniform(-1, 1, (2, 300))
        opts = dict(max_iterations=5000, tolerance=tol)
        rj = j_power_split(mj, JSolverOptions(**opts), x0=x0)
        rt = T.power_method(mt, T.SolverOptions(**opts), x0=x0)
        assert int(rt.iterations) == int(rj.iterations)
        assert bool(rt.converged) == bool(rj.converged)
        lam_j = complex(jsc.from_planes(rj.eigenvalue))
        lam = complex(tsc.from_planes(rt.eigenvalue))
        assert abs(lam - lam_j) <= limit * abs(lam_j)
        assert rt.eigenvector.shape == (2, 300)
        np.testing.assert_allclose(rt.eigenvector.numpy(), np.asarray(rj.eigenvector),
                                   rtol=limit * 100, atol=limit * 100)

    def test_fixed_budget_matches_jax(self):
        # tol 0: every iteration runs, across several host-read blocks
        mj, mt = split_pair(2000, tuple(range(-8, 9)), seed=12, precision=np.float64)
        x0 = np.random.default_rng(13).uniform(-1, 1, (2, 2000))
        rj = j_power_split(mj.interleaved(), JSolverOptions(max_iterations=70, tolerance=0.0),
                           x0=x0)
        rt = T.power_method_split_complex(mt.interleaved(),
                                          T.SolverOptions(max_iterations=70, tolerance=0.0),
                                          x0=x0)
        assert int(rt.iterations) == int(rj.iterations) == 70 and not bool(rt.converged)
        np.testing.assert_allclose(rt.eigenvalue.numpy(), np.asarray(rj.eigenvalue),
                                   rtol=1e-10, atol=1e-10)

    def test_matches_complex_solver(self):
        # tests/test_split_complex.py:97-113: the plane loop and the
        # complex-dtype loop of the port agree, iteration for iteration
        n, offsets = 64, (-1, 0, 1)
        data = band_planes(n, offsets, seed=11, dtype=np.float64)
        dia = T.SparseDIA(data=torch.from_numpy(data[0] + 1j * data[1]), offsets=offsets,
                          shape=(n, n))
        M = T.SplitComplexDIA.from_complex_dia(dia, precision=np.float64)
        x0 = np.random.default_rng(1).uniform(-1, 1, (2, n))
        ref = T.power_method(dia, T.SolverOptions(tolerance=1e-10), x0=x0[0] + 1j * x0[1])
        res = T.power_method_split_complex(M, T.SolverOptions(tolerance=1e-10), x0=x0)
        lam = complex(tsc.from_planes(res.eigenvalue))
        np.testing.assert_allclose(lam, complex(ref.eigenvalue), rtol=1e-9)
        assert int(res.iterations) == int(ref.iterations)
        assert bool(res.converged) == bool(ref.converged)

    def test_default_start_converges_to_dense_oracle(self):
        mj, mt = split_pair(120, tuple(range(-3, 4)), seed=12, precision=np.float64)
        res = T.power_method(mt, T.SolverOptions(tolerance=1e-11, max_iterations=20000))
        assert bool(res.converged)
        ev = np.linalg.eigvals(mt.to_complex_dense())
        dom = ev[np.argmax(np.abs(ev))]
        np.testing.assert_allclose(complex(tsc.from_planes(res.eigenvalue)), dom, rtol=1e-7)
        assert "EigenResult(eigenvalue=(" in repr(res)

    def test_bf16_planes_iterate_in_float32(self):
        # bf16 planes widen to float32 in the matvec, so they run the loop of
        # float32 planes holding the same values, bit for bit
        n, offsets = 3000, (-2, 0, 1)
        planes_bf16 = torch.from_numpy(band_planes(n, offsets, seed=5)).to(torch.bfloat16)
        m16 = T.SplitComplexDIA(planes=planes_bf16, offsets=offsets, shape=(n, n)).interleaved()
        m32 = T.SplitComplexDIA(planes=planes_bf16.float(), offsets=offsets,
                                shape=(n, n)).interleaved()
        x0 = np.random.default_rng(6).uniform(-1, 1, (2, n))
        opts = T.SolverOptions(max_iterations=500, tolerance=1e-6)
        r16, r32 = T.power_method(m16, opts, x0=x0), T.power_method(m32, opts, x0=x0)
        assert r16.eigenvalue.dtype == torch.float32
        assert int(r16.iterations) == int(r32.iterations)
        assert torch.equal(r16.eigenvalue, r32.eigenvalue)

    @pytest.mark.parametrize("case", ["non-square", "zero-size", "x0-shape"])
    def test_errors_match_jax(self, case):
        shape = {"non-square": (4, 5), "zero-size": (0, 0), "x0-shape": (4, 4)}[case]
        planes = np.zeros((2, 1, shape[1]))
        x0 = np.ones((2, 3)) if case == "x0-shape" else None
        msgs = []
        for M, run in ((JSplit(planes=jnp.asarray(planes), offsets=(0,), shape=shape),
                        j_power_split),
                       (T.SplitComplexDIA(planes=torch.from_numpy(planes), offsets=(0,),
                                          shape=shape), T.power_method_split_complex)):
            with pytest.raises(ValueError) as err:
                run(M, x0=x0)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
