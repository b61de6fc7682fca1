"""``power_method_ds64`` of the PyTorch port against the JAX package and a
host float64 loop, on the CPU.

The JAX function runs the power loop in two-float compensated arithmetic
(its TPU has no float64); the port widens the diagonals to float64 and runs
the masked power loop on B2's float64 instance (its plain version here).
The same numpy operator and the same explicit ``x0`` go through both.
Tolerances: eigenvalues within 1e-12 relative of JAX's and of the host loop,
equal iteration counts and flags, eigenvectors within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu.core.options import SolverOptions as JOptions
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA as JSparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full
from pcsc_eigenvalue_solver_project_tpu.solvers.power import power_method_ds64 as j_ds64
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.dia import SparseDIA as TSparseDIA
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as tds

N = 300


def planted(n=N, bandwidth=4, dtype=np.float64, peak=25.0):
    """banded_full with a shifted diagonal and a planted dominant entry
    (tests/test_ds64.py's operator)."""
    dia = banded_full(n, bandwidth=bandwidth, dtype=np.float64, seed=0)
    data = np.array(dia.data, np.float64)
    mid = len(dia.offsets) // 2
    data[mid] += 3.0
    data[mid, 7] = peak
    return data.astype(dtype), tuple(dia.offsets)


def pair(data, offs):
    n = data.shape[1]
    return (JSparseDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n)),
            TSparseDIA(data=torch.from_numpy(data), offsets=offs, shape=(n, n)))


def host_loop(data, offs, x0, max_iterations, tol):
    """The reference loop in host float64 with the JAX ds64 stopping rule."""
    n = data.shape[1]
    d = data.astype(np.float64)

    def mv(x):
        y = np.zeros(n)
        for k, off in enumerate(offs):
            if off >= 0:
                y[:n - off] += d[k, :n - off] * x[off:]
            else:
                y[-off:] += d[k, -off:] * x[:off]
        return y

    x, z, lam, init, conv, used = x0.astype(np.float64), mv(x0), 0.0, False, False, 0
    tol = float(np.float32(tol))
    for k in range(max_iterations):
        nz = np.sqrt(z @ z)
        used = k + 1
        if nz == 0:
            break
        xn = z / nz
        zn = mv(xn)
        ln = xn @ zn
        done = init and abs(ln - lam) <= tol * (1 + abs(ln))
        x, z, lam, init = xn, zn, ln, True
        if done:
            conv = True
            break
    return lam, x, used, conv


def run(ops, x0, max_iterations=5000, tol=1e-13):
    rj = j_ds64(ops[0], JOptions(max_iterations=max_iterations, tolerance=tol), x0=x0)
    rt = T.power_method_ds64(ops[1], T.SolverOptions(max_iterations=max_iterations,
                                                     tolerance=tol), x0=x0)
    return rj, rt


def assert_same(rj, rt, scale):
    assert abs(rt.eigenvalue - rj.eigenvalue) <= 1e-12 * scale
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(rt.eigenvector, np.asarray(rj.eigenvector), atol=1e-10)


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(1).uniform(-1, 1, N)


class TestPowerDs64:
    def test_eigenpair_f64_accuracy(self, x0):
        data, offs = planted()
        ops = pair(data, offs)
        rj, rt = run(ops, x0)
        d = ops[1].to_dense().numpy()
        ev = np.linalg.eigvals(d)
        lam_o = ev[np.argmax(np.abs(ev))].real
        assert bool(rt.converged)
        assert abs(rt.eigenvalue - lam_o) < 1e-12 * abs(lam_o)
        assert np.abs(d @ rt.eigenvector - rt.eigenvalue * rt.eigenvector).max() < \
            1e-10 * abs(lam_o)
        assert_same(rj, rt, abs(lam_o))

    def test_matches_host_float64_loop(self, x0):
        data, offs = planted()
        _, rt = run(pair(data, offs), x0)
        lam, x, used, conv = host_loop(data, offs, x0, 5000, 1e-13)
        assert abs(rt.eigenvalue - lam) <= 1e-12 * abs(lam)
        assert int(rt.iterations) == used and bool(rt.converged) == conv
        np.testing.assert_allclose(rt.eigenvector, x, atol=1e-10)

    def test_returns_numpy_values(self, x0):
        data, offs = planted()
        _, rt = run(pair(data, offs), x0, max_iterations=50)
        assert isinstance(rt.eigenvalue, np.float64)
        assert rt.eigenvector.dtype == np.float64 and rt.eigenvector.shape == (N,)
        assert isinstance(rt.iterations, np.int32) and isinstance(rt.converged, np.bool_)

    def test_f32_operator_is_widened(self, x0):
        """A float32 ``SparseDIA``: the diagonals widen to float64, so the
        result is JAX's on the same (exactly widened) values."""
        data, offs = planted(dtype=np.float32)
        ops = pair(data, offs)
        rj, rt = run(ops, x0)
        assert ops[1].dtype == torch.float32
        assert_same(rj, rt, abs(rj.eigenvalue))
        lam, _, used, _ = host_loop(data, offs, x0, 5000, 1e-13)
        assert abs(rt.eigenvalue - lam) <= 1e-12 * abs(lam) and int(rt.iterations) == used

    def test_f32_accuracy_is_insufficient_here(self, x0):
        """The same solve in plain float32 cannot reach 1e-12."""
        data, offs = planted()
        _, rt = run(pair(data, offs), x0)
        d64 = pair(data, offs)[1].to_dense().numpy()
        ev = np.linalg.eigvals(d64)
        lam_o = ev[np.argmax(np.abs(ev))].real
        m32 = TSparseDIA(data=torch.from_numpy(data.astype(np.float32)), offsets=offs,
                         shape=(N, N))
        r32 = T.power_method(m32, T.SolverOptions(max_iterations=5000, tolerance=1e-13), x0=x0)
        err32 = abs(complex(r32.eigenvalue) - lam_o)
        err_ds = abs(rt.eigenvalue - lam_o)
        assert err_ds < 1e-12 * abs(lam_o)
        assert err32 > 50 * err_ds

    @pytest.mark.parametrize("max_iterations", [0, 1, 2, 12])
    def test_budget(self, x0, max_iterations):
        """A budget shorter than the solve (tolerance 0; two Rayleigh
        quotients first agree bit for bit after ~20 iterations, at an
        iteration that depends on the summation order): no test on the
        first iterate, and the count is the budget."""
        data, offs = planted()
        rj, rt = run(pair(data, offs), x0, max_iterations=max_iterations, tol=0.0)
        lam, x, used, _ = host_loop(data, offs, x0, max_iterations, 0.0)
        assert int(rt.iterations) == used == max_iterations
        assert not bool(rt.converged)
        assert abs(rt.eigenvalue - lam) <= 1e-12 * 30.0
        assert_same(rj, rt, 30.0)

    def test_breakdown_keeps_the_last_good_iterate(self):
        """A nilpotent shift: A^2 x0 = 0, so the second norm is zero; the
        loop stops there with the last good iterate, ``converged`` False
        and ``iterations = k + 1``."""
        n = 6
        data = np.zeros((1, n))
        data[0, :n - 1] = 1.0
        ops = pair(data, (1,))
        x0 = np.zeros(n)
        x0[1] = 1.0
        rj, rt = run(ops, x0)
        assert not bool(rt.converged)
        assert_same(rj, rt, 1.0)
        lam, x, used, conv = host_loop(data, (1,), x0, 5000, 1e-13)
        assert int(rt.iterations) == used and rt.eigenvalue == lam

    def test_default_start_vector(self):
        data, offs = planted()
        r = T.power_method_ds64(pair(data, offs)[1], T.SolverOptions(max_iterations=5000,
                                                                     tolerance=1e-13))
        ev = np.linalg.eigvals(pair(data, offs)[1].to_dense().numpy())
        lam_o = ev[np.argmax(np.abs(ev))].real
        assert bool(r.converged) and abs(r.eigenvalue - lam_o) < 1e-12 * abs(lam_o)

    def test_float64_matvec_on_the_b2_route(self, x0):
        """The loop's matvec is ``dia_matvec`` in float64: against the host
        band product to 1e-13."""
        data, offs = planted()
        y = tds.dia_matvec(torch.from_numpy(data), offs, torch.from_numpy(x0)).numpy()
        want = np.zeros(N)
        for k, off in enumerate(offs):
            if off >= 0:
                want[:N - off] += data[k, :N - off] * x0[off:]
            else:
                want[-off:] += data[k, -off:] * x0[:off]
        assert np.abs(y - want).max() <= 1e-13 * np.abs(want).max()

    def test_errors(self, x0):
        data, offs = planted()
        with pytest.raises(ValueError, match="must be a SparseDIA"):
            T.power_method_ds64(T.DenseMatrix.from_array(np.eye(4), device="cpu"))
        with pytest.raises(ValueError, match="real operators only"):
            T.power_method_ds64(pair(data.astype(np.complex128), offs)[1])
        with pytest.raises(ValueError, match="must be a SparseDIA"):
            T.power_method_ds64(pair(data, offs)[1].interleaved())
        with pytest.raises(ValueError, match="must be a SparseDIA"):
            j_ds64(pair(data, offs)[0].interleaved())
