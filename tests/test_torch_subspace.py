"""The block SpMM (B5's plain versions) and the block solvers of the PyTorch
port against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions (the Pallas block kernels
in interpret mode) and through the port. Start blocks: the same numpy ``X0``
on both sides.

Tolerances:
- ``dia_matmat_plain``, ``dia_matmat_il_plain`` and
  ``dia_matmat_il_window_plain`` against the Pallas kernels: rtol = atol =
  2e-5 in float32 and bf16 storage (tests/test_subspace.py:32-33; float32
  sums in another order), 1e-12 in float64.
- ``subspace_iteration`` (natural and rows mode) and
  ``chebyshev_subspace_iteration``: in float64 the same number of sweeps and
  Ritz values within 1e-10 relative to max|lambda|; in float32 within 1e-4.
  Ritz values are matched by nearest neighbour: complex pairs of equal
  modulus come back in either order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.models import generators as jgen
from pcsc_eigenvalue_solver_project_tpu.ops.pallas import dia_spmv as jds
from pcsc_eigenvalue_solver_project_tpu.solvers import subspace as jsub
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as tds
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import subspace as tsub
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves, to_tensor


def to_port(m):
    """The port's counterpart of JAX matrix ``m``, on identical data."""
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def band(n, offsets, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vals = rng.random((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    return vals.astype(dtype)


def stored(vals, storage):
    """(JAX array, port tensor) of the same stored values."""
    vj = jnp.asarray(vals, jnp.bfloat16 if storage == "bfloat16" else vals.dtype)
    return vj, to_tensor(np.asarray(vj))


def nn_err(got, want):
    """Max distance under nearest-neighbour matching, relative to max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got[:, None] - want[None, :])
    return max(d.min(axis=0).max(), d.min(axis=1).max()) / np.abs(want).max()


OFFSETS = tuple(range(-4, 5))  # k = 9, tests/test_subspace.py:17-33
TOL = {"float32": 2e-5, "bfloat16": 2e-5, "float64": 1e-12}


class TestBlockKernels:
    @pytest.mark.parametrize("storage", ["float32", "bfloat16", "float64"])
    @pytest.mark.parametrize("nvec", [1, 3, 6, 13])
    def test_rowmajor_plain_matches_pallas(self, nvec, storage):
        n = 20000
        vals = band(n, OFFSETS, seed=0, dtype=np.float64 if storage == "float64" else np.float32)
        xs = np.random.default_rng(1).random((nvec, n)).astype(vals.dtype)
        vj, vt = stored(vals, storage)
        y_jax = jds.dia_matmat(vj, OFFSETS, jnp.asarray(xs), force="interpret")
        y = tds.dia_matmat(vt, OFFSETS, torch.from_numpy(xs))
        assert y.dtype == tds.acc_dtype(vt.dtype) and y.shape == (nvec, n)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=TOL[storage],
                                   atol=TOL[storage])

    @pytest.mark.parametrize("storage", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nvec", [1, 3, 6, 13])
    def test_interleaved_plain_matches_pallas(self, nvec, storage):
        n = 20000
        R = jds.il_rows(n)
        vals = band(n, OFFSETS, seed=2)
        vj, _ = stored(vals, storage)
        vil_j = jds.interleave_dia_vals(vj, R)
        xs = np.random.default_rng(3).random((nvec, n)).astype(np.float32)
        xs_il_j = jnp.stack([jds.interleave_vec(jnp.asarray(x), R) for x in xs])
        y_jax = jds.dia_matmat_il(vil_j, OFFSETS, xs_il_j, force="interpret")
        vil = to_tensor(np.asarray(vil_j))
        xs_il = torch.stack([tds.interleave_vec(torch.from_numpy(x), R) for x in xs])
        np.testing.assert_array_equal(xs_il.numpy(), np.asarray(xs_il_j))
        y = tds.dia_matmat_il(vil, OFFSETS, xs_il)
        assert y.shape == (nvec, R, 128) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=2e-5, atol=2e-5)
        # each vector as the single-vector SpMV (B1's plain version)
        for v in range(nvec):
            np.testing.assert_allclose(y[v].numpy(),
                                       tds.dia_matvec_il_plain(vil, OFFSETS, xs_il[v]).numpy(),
                                       rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("nvec", [1, 3, 6, 13])
    def test_window_with_halo_values_matches_pallas(self, nvec):
        n, offsets = 20000, (-9, 0, 3, 9)
        R = jds.il_rows(n)
        pr = jds.il_window_halo(offsets)
        vil_j = jds.interleave_dia_vals(jnp.asarray(band(n, offsets, seed=4)), R)
        w = np.random.default_rng(5).uniform(-1, 1, (nvec, R + 2 * pr, 128)).astype(np.float32)
        y_jax = jds.dia_matmat_il_window(vil_j, offsets, jnp.asarray(w), force="interpret")
        y = tds.dia_matmat_il_window(to_tensor(np.asarray(vil_j)), offsets, torch.from_numpy(w))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=2e-5, atol=2e-5)

    def test_block_consistent_with_single(self):
        # tests/test_subspace.py:35-43 through the port, complex128 too
        m = jgen.banded_random(300, bandwidth=3, nnz_per_row=4, seed=1)
        dia = T.SparseDIA.from_csr(to_port(m))
        rng = np.random.default_rng(2)
        for xs in (rng.random((4, 300)), rng.random((4, 300)) + 1j * rng.random((4, 300))):
            vals = dia.data if not np.iscomplexobj(xs) else dia.data.to(torch.complex128)
            ys = tds.dia_matmat(vals, dia.offsets, torch.from_numpy(xs))
            for i in range(4):
                np.testing.assert_allclose(
                    ys[i].numpy(), tds.dia_matvec(vals, dia.offsets, torch.from_numpy(xs[i])),
                    rtol=1e-12)

    def test_interleaved_matmat_is_the_block_spmm(self):
        mt = to_port(jgen.banded_full(3000, bandwidth=4, dtype=np.float64, seed=9).interleaved())
        xs = torch.from_numpy(np.random.default_rng(6).standard_normal((5, mt.R, 128)))
        np.testing.assert_array_equal(mt.matmat(xs).numpy(),
                                      tds.dia_matmat_il(mt.data_il, mt.offsets, xs).numpy())

    def test_error_messages_match_jax(self):
        vals_il = np.zeros((3, 64, 128), np.float32)
        w = np.zeros((2, 64 + 2, 128), np.float32)
        msgs = []
        for fn, arg in ((jds.dia_matmat_il_window, jnp.asarray),
                        (tds.dia_matmat_il_window, torch.from_numpy)):
            with pytest.raises(ValueError) as err:
                fn(arg(vals_il), (-1, 0, 1), arg(w))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == ("dia_matmat_il_window: window has 66 sublanes, "
                                      "expected R + 2*pr = 80")
        with pytest.raises(ValueError, match="dia_matmat_il: bandwidth exceeds chunk size R"):
            tds.dia_matmat_il(torch.zeros((41, 8, 128)), tuple(range(-20, 21)),
                              torch.zeros((2, 8, 128)))

    def test_non_cpu_tensors_never_take_the_plain_path(self):
        vals = torch.empty((3, 1000), device="meta")
        with pytest.raises(ValueError, match="^dia_block_kernel: .*CUDA device"):
            tds.dia_matmat(vals, (-1, 0, 1), torch.empty((4, 1000), device="meta"))
        R = tds.il_rows(1000, 8)
        vil = torch.empty((3, R, 128), device="meta")
        with pytest.raises(ValueError, match="^dia_il_block_kernel: .*CUDA device"):
            tds.dia_matmat_il(vil, (-1, 0, 1), torch.empty((4, R, 128), device="meta"))
        with pytest.raises(ValueError, match="^dia_planes_kernel: .*CUDA device"):
            tds.dia_matvec_planes(torch.empty((2, 3, 1000), device="meta"), (-1, 0, 1),
                                  torch.empty((2, 1000), device="meta"))
        with pytest.raises(ValueError, match="^dia_il_planes_kernel: .*CUDA device"):
            tds.dia_matvec_il_planes(torch.empty((2, 3, R, 128), device="meta"), (-1, 0, 1),
                                     torch.empty((2, R, 128), device="meta"))
        with pytest.raises(TypeError, match="planes must be real"):
            tds.dia_planes_kernel(torch.empty((2, 3, 1000), dtype=torch.complex64,
                                              device="meta"), (-1, 0, 1),
                                  torch.empty((2, 1000), device="meta"))
        assert _build._lib is None  # rejected before any build
        assert all(k.launches == 0 for k in tds.KERNELS)


class TestBlockColumns:
    """B5's (n, b) entry, which the block solvers take on a SparseDIA, and
    the rule that picks B5's route on the card."""

    @pytest.mark.parametrize("storage", ["float32", "bfloat16", "float64"])
    @pytest.mark.parametrize("b", [1, 7, 9])
    def test_columns_plain_matches_pallas(self, b, storage):
        n = 20000
        vals = band(n, OFFSETS, seed=7, dtype=np.float64 if storage == "float64" else np.float32)
        X = np.random.default_rng(8).random((n, b)).astype(vals.dtype)
        vj, vt = stored(vals, storage)
        y_jax = jds.dia_matmat(vj, OFFSETS, jnp.asarray(X.T), force="interpret").T
        y = tds.dia_matmat_cols(vt, OFFSETS, torch.from_numpy(X))
        assert y.shape == (n, b) and y.dtype == tds.acc_dtype(vt.dtype)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=TOL[storage],
                                   atol=TOL[storage])

    @pytest.mark.parametrize("dtype,limit", [(np.float64, 1e-12), (np.complex128, 1e-12),
                                             (np.float32, 2e-5)])
    def test_apply_block_matches_jax(self, dtype, limit):
        # _apply_block hands the (n, b) block to the kernel as it lies; the same
        # X0 through JAX's _apply_block and the port's
        dj = jgen.banded_full(3000, bandwidth=4, dtype=dtype, seed=10, diag_boost=1.0)
        X0 = start_block(3000, 8, seed=11).astype(dtype)
        y_jax = np.asarray(jsub._apply_block(dj, jnp.asarray(X0)))
        y = tsub._apply_block(to_port(dj), torch.from_numpy(X0))
        assert y.shape == (3000, 8)
        np.testing.assert_allclose(y.numpy(), y_jax, rtol=limit, atol=limit * np.abs(y_jax).max())
        # and a chunk of sweeps, with its projected block
        Xj, Bj = jsub._subspace_chunk(dj, jsub._cholqr2(jnp.asarray(X0)), 3)
        Xt, Bt = tsub._subspace_chunk(to_port(dj), tsub._cholqr2(torch.from_numpy(X0)), 3)
        np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=100 * limit,
                                   atol=100 * limit * np.abs(np.asarray(Bj)).max())

    def test_non_cpu_columns_never_take_the_plain_path(self):
        vals = torch.empty((3, 1000), device="meta")
        with pytest.raises(ValueError, match="^dia_block_kernel: .*CUDA device"):
            tds.dia_matmat_cols(vals, (-1, 0, 1), torch.empty((1000, 4), device="meta"))
        with pytest.raises(ValueError, match="expected \\(k, n\\) diagonals and an "
                                             "\\(n, nvec\\) block"):
            tds.dia_block_kernel(vals, (-1, 0, 1), torch.empty((4, 1000), device="meta"),
                                 vectors_last=True)
        assert _build._lib is None

    @pytest.mark.parametrize("dtype,rows", [(torch.float32, 4), (torch.bfloat16, 4),
                                            (torch.float64, 2), (torch.complex64, 2),
                                            (torch.complex128, 1)])
    def test_route_rule(self, dtype, rows):
        # a thread takes 16 bytes of rows of the accumulation dtype; a block
        # 256 threads; the tile holds x of min(nvec, 8) vectors over the
        # positions the band reaches, then a ring of 8 diagonals' stored values
        item = torch.empty((), dtype=tds.acc_dtype(dtype)).element_size()
        stored = torch.empty((), dtype=dtype).element_size()
        ring = 8 * 256 * rows * stored
        band33 = tuple(range(-16, 17))
        positions = 256 * rows + 32
        rowmajor = -(-(positions + positions // (128 // item) + 1) * 8 * item // 16) * 16 + ring
        window = (8 * rows + 32) * 32 * 8 * item + ring
        assert tds.block_stage_smem(False, band33, dtype, 8) == rowmajor
        assert tds.block_stage_smem(True, band33, dtype, 8) == window
        assert tds.block_stage_smem(True, band33, dtype, 17) == window
        assert tds.block_stage_smem(True, band33, dtype, 3) == (window - ring) // 8 * 3 + ring
        # staged where it was the faster: the solvers' (n, nvec) block, and
        # the interleaved window with 4-byte vectors; and where the tile fits
        assert tds.block_route(False, band33, dtype, 8, vectors_last=True) == "staged"
        assert tds.block_route(False, band33, dtype, 8) == "direct"
        assert tds.block_route(True, band33, dtype, 8) == \
            ("staged" if item == 4 and window <= tds.BLOCK_STAGED_SMEM else "direct")
        # a one-sided band's span is its width, not twice its reach
        assert tds.block_stage_smem(True, (0, 1, 2), dtype, 8) == \
            (8 * rows + 2) * 32 * 8 * item + ring
        # spans that make the tile too large take the direct route
        assert tds.block_route(True, (-130, 0, 129), dtype, 8) == "direct"
        assert tds.block_route(False, (-5000, 0, 4999), dtype, 8, vectors_last=True) == "direct"
        assert tds.block_route(False, (-130, 0, 129), dtype, 8, vectors_last=True) == "staged"


class TestCholQR2:
    @pytest.mark.parametrize("rows", [False, True])
    def test_matches_jax(self, rows):
        X = np.random.default_rng(3).random((200, 8))
        if rows:
            q = tsub._cholqr2_rows(torch.from_numpy(X.T.copy())).numpy()
            qj = np.asarray(jsub._cholqr2_rows(jnp.asarray(X.T)))
        else:
            q = tsub._cholqr2(torch.from_numpy(X)).numpy()
            qj = np.asarray(jsub._cholqr2(jnp.asarray(X)))
        np.testing.assert_allclose(q, qj, rtol=1e-10, atol=1e-10)
        Q = q.T if rows else q
        np.testing.assert_allclose(Q.T @ Q, np.eye(8), atol=1e-10)


def start_block(n, b, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, b))


def sym_banded(n, bw, seed, boost, dtype=np.float64):
    """A random symmetric band with a boosted head (tests/test_lanczos.py:21-36),
    as a JAX SparseDIA."""
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
    data[bw] += np.asarray(boost, dtype)
    return JSparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n))


def check_pair(rj, rt, limit, equal_sweeps=True):
    if equal_sweeps:
        assert int(rt.iterations) == int(rj.iterations)
        assert bool(rt.converged) == bool(rj.converged)
    assert rt.eigenvalues.shape == tuple(np.asarray(rj.eigenvalues).shape)
    assert nn_err(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues)) <= limit


class TestSubspaceIteration:
    def test_separated_diagonal(self):
        # tests/test_subspace.py:58-66
        d = np.concatenate([[40.0, 30.0, 22.0, 15.0], np.linspace(0.1, 2.0, 60)])
        mj = J.DenseMatrix.from_array(np.diag(d))
        X0 = start_block(64, 8, seed=0)
        opts = dict(tolerance=1e-10, max_iterations=2000)
        rj = jsub.subspace_iteration(mj, k=4, opts=J.SolverOptions(**opts), X0=X0)
        rt = T.subspace_iteration(to_port(mj), k=4, opts=T.SolverOptions(**opts), X0=X0)
        assert bool(rt.converged)
        check_pair(rj, rt, 1e-10)
        np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy().real)[::-1],
                                   [40, 30, 22, 15], rtol=1e-8)

    def test_banded_with_complex_pair(self):
        # tests/test_subspace.py:68-79: the block kernel's path (SparseDIA)
        m = jgen.banded_random(400, bandwidth=4, nnz_per_row=5, seed=2)
        dj = JSparseDIA.from_csr(m)
        X0 = start_block(400, 8, seed=1)
        opts = dict(tolerance=1e-9, max_iterations=3000)
        rj = jsub.subspace_iteration(dj, k=3, opts=J.SolverOptions(**opts), X0=X0)
        rt = T.subspace_iteration(to_port(dj), k=3, opts=T.SolverOptions(**opts), X0=X0)
        assert bool(rt.converged)
        check_pair(rj, rt, 1e-10)
        exact = np.linalg.eigvals(np.asarray(m.to_dense()))
        exact = exact[np.argsort(-np.abs(exact))][:3]
        assert nn_err(rt.eigenvalues.numpy(), exact) < 1e-5

    @pytest.mark.parametrize("dtype,limit", [(np.float64, 1e-10), (np.float32, 1e-4)])
    @pytest.mark.parametrize("interleaved", [False, True], ids=["natural", "rows"])
    def test_banded_full_matches_jax(self, interleaved, dtype, limit):
        # tests/test_subspace.py:89-102's operator, a fixed budget of sweeps
        dj = jgen.banded_full(3000, bandwidth=4, dtype=dtype, seed=9, diag_boost=1.0)
        if interleaved:
            dj = dj.interleaved()
        X0 = start_block(3000, 8, seed=2)
        opts = dict(tolerance=1e-7, max_iterations=60)
        rj = jsub.subspace_iteration(dj, k=4, opts=J.SolverOptions(**opts), X0=X0)
        rt = T.subspace_iteration(to_port(dj), k=4, opts=T.SolverOptions(**opts), X0=X0)
        check_pair(rj, rt, limit, equal_sweeps=dtype == np.float64)

    def test_complex_operator(self):
        m = jgen.banded_random(300, bandwidth=3, nnz_per_row=4, seed=3, dtype=np.complex128)
        dj = JSparseDIA.from_csr(m)
        X0 = start_block(300, 8, seed=4)
        opts = dict(tolerance=1e-9, max_iterations=2000)
        rj = jsub.subspace_iteration(dj, k=2, opts=J.SolverOptions(**opts), X0=X0)
        rt = T.subspace_iteration(to_port(dj), k=2, opts=T.SolverOptions(**opts), X0=X0)
        check_pair(rj, rt, 1e-10)

    def test_default_start(self):
        d = np.concatenate([[9.0, 7.0, 5.0], np.linspace(0.1, 1.0, 40)])
        rt = T.subspace_iteration(T.DenseMatrix.from_array(np.diag(d), device="cpu"), k=3,
                                  opts=T.SolverOptions(tolerance=1e-10, max_iterations=1000))
        assert bool(rt.converged)
        np.testing.assert_allclose(np.sort(rt.eigenvalues.numpy().real)[::-1], [9, 7, 5],
                                   rtol=1e-8)


class TestChebyshev:
    def test_separated_top_exact(self):
        # tests/test_subspace.py:141-154
        boost = np.zeros(2000)
        boost[:4] = [8, 7, 6.5, 6]
        aj = sym_banded(2000, 3, 0, boost)
        X0 = start_block(2000, 8, seed=5)
        opts = dict(max_iterations=1000, tolerance=1e-9)
        rj = jsub.chebyshev_subspace_iteration(aj, k=4, degree=10, X0=X0,
                                               opts=J.SolverOptions(**opts))
        rt = T.chebyshev_subspace_iteration(to_port(aj), k=4, degree=10, X0=X0,
                                            opts=T.SolverOptions(**opts))
        assert bool(rt.converged)
        check_pair(rj, rt, 1e-10)
        exact = np.sort(np.linalg.eigvalsh(np.asarray(aj.to_dense())))[::-1][:4]
        np.testing.assert_allclose(rt.eigenvalues.numpy(), exact, rtol=1e-7)

    def test_clustered_top(self):
        # tests/test_subspace.py:156-170 at a smaller budget: the filter on a
        # laplacian's top cluster, the same sweeps as JAX
        lj = JSparseDIA.from_csr(jgen.laplacian_1d(1000))
        X0 = start_block(1000, 8, seed=6)
        opts = dict(max_iterations=40, tolerance=1e-10)
        rj = jsub.chebyshev_subspace_iteration(lj, k=3, degree=20, X0=X0,
                                               opts=J.SolverOptions(**opts))
        rt = T.chebyshev_subspace_iteration(to_port(lj), k=3, degree=20, X0=X0,
                                            opts=T.SolverOptions(**opts))
        check_pair(rj, rt, 1e-10)

    def test_interleaved_rows_mode(self):
        # tests/test_subspace.py:172-186: float32 rows mode
        boost = np.zeros(2000, np.float32)
        boost[:4] = [8, 7, 6.5, 6]
        aj = sym_banded(2000, 3, 0, boost, dtype=np.float32).interleaved()
        X0 = start_block(2000, 8, seed=7)
        opts = dict(max_iterations=1000, tolerance=1e-5)
        rj = jsub.chebyshev_subspace_iteration(aj, k=4, degree=10, X0=X0,
                                               opts=J.SolverOptions(**opts))
        rt = T.chebyshev_subspace_iteration(to_port(aj), k=4, degree=10, X0=X0,
                                            opts=T.SolverOptions(**opts))
        check_pair(rj, rt, 1e-4, equal_sweeps=False)

    def test_interval_argument(self):
        boost = np.zeros(500)
        boost[:2] = [6, 5]
        aj = sym_banded(500, 2, 1, boost)
        X0 = start_block(500, 8, seed=8)
        kw = dict(k=2, degree=8, interval=(-2.0, 7.0), X0=X0)
        rj = jsub.chebyshev_subspace_iteration(aj, opts=J.SolverOptions(max_iterations=30),
                                               **kw)
        rt = T.chebyshev_subspace_iteration(to_port(aj), opts=T.SolverOptions(max_iterations=30),
                                            **kw)
        check_pair(rj, rt, 1e-10)


ERROR_CASES = [
    ("non-square", "subspace_iteration", lambda M, c: M.DenseMatrix.from_array(np.ones((2, 3)), **c),
     {}),
    ("block < k", "subspace_iteration", lambda M, c: M.DenseMatrix.from_array(np.eye(6), **c),
     dict(k=3, block=2)),
    ("k < 1", "subspace_iteration", lambda M, c: M.DenseMatrix.from_array(np.eye(6), **c),
     dict(k=0)),
    ("zero size", "subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.zeros((0, 0)), **c), {}),
    ("dtype", "subspace_iteration", lambda M, c: M.DenseMatrix.from_array(np.eye(6), **c),
     dict(dtype=np.float32)),
    ("cheb non-square", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.ones((2, 3)), **c), {}),
    ("cheb degree", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.eye(8), **c), dict(k=2, degree=0)),
    ("cheb k < 1", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.eye(8), **c), dict(k=0)),
    ("cheb block < k", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.eye(8), **c), dict(k=4, block=3)),
    ("cheb complex", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.eye(8) + 0j, **c), dict(k=2)),
    ("cheb interval", "chebyshev_subspace_iteration",
     lambda M, c: M.DenseMatrix.from_array(np.eye(8), **c), dict(k=2, interval=(1.0, 1.0))),
]


@pytest.mark.parametrize("case", ERROR_CASES, ids=[c[0] for c in ERROR_CASES])
def test_errors_match_jax(case):
    # tests/test_subspace.py:81-87, :188-196 and every other argument check
    _, fn, make, kwargs = case
    msgs = []
    for M, solvers, cpu in ((J, jsub, {}), (T, tsub, {"device": "cpu"})):
        with pytest.raises((TypeError, ValueError)) as err:
            getattr(solvers, fn)(make(M, cpu), **kwargs)
        msgs.append((type(err.value), str(err.value)))
    assert msgs[0] == msgs[1]
