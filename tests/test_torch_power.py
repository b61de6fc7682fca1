"""``power_method`` of the PyTorch port against the JAX package, on the CPU.

Both sides run on identical operators (moved across with
``utils.interop.from_numpy_leaves``) from the same numpy start vector x0.
float64: the same iteration count and ``converged``, the eigenvalue to
rtol 1e-10 and the eigenvector to 1e-8. float32: the eigenvalue to rtol
1e-5 and, for the seeds chosen here, the same iteration count (both sides
decide convergence in float64, as JAX does under x64; only the summation
order of the reductions differs).
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
from pcsc_eigenvalue_solver_project_tpu.core.tolerance import is_close_relative as j_close
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full as j_banded_full
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_full as t_banded_full
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import power as tpower
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves
from pcsc_eigenvalue_solver_project_tpu_torch.utils.prng import (default_generator,
                                                                random_unit_vector)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def to_port(m):
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(m)]
    static = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.metadata.get("static")}
    return from_numpy_leaves(type(m).__name__, leaves, static, device="cpu")


def planted_band(n, bandwidth, dtype, seed):
    """Band of uniform(-1, 1) diagonals with 14, 10, 8 planted on the first
    three diagonal entries: a real dominant eigenvalue near 14."""
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-bandwidth, bandwidth + 1))
    data = rng.uniform(-1, 1, (len(offsets), n))
    data[bandwidth, :3] = (14.0, 10.0, 8.0)
    for d, off in enumerate(offsets):
        if off > 0:
            data[d, n - off:] = 0
        elif off < 0:
            data[d, :-off] = 0
    return data.astype(dtype), offsets


def jax_operator(kind, data, offsets):
    n = data.shape[1]
    dia = J.SparseDIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n))
    dense = np.asarray(dia.to_dense())
    return {"dense": lambda: J.DenseMatrix.from_array(dense),
            "csr": lambda: J.SparseCSR.from_dense(dense),
            "ell": lambda: J.SparseCSR.from_dense(dense).to_ell(),
            "dia": lambda: dia,
            "il": lambda: dia.interleaved(8)}[kind]()


def both(mj, opts_args, x0):
    rj = J.power_method(mj, J.SolverOptions(*opts_args), x0=x0)
    rt = T.power_method(to_port(mj), T.SolverOptions(*opts_args), x0=x0)
    return rj, rt


KINDS = ["dense", "csr", "ell", "dia", "il"]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_f64_matches_jax(kind, seed):
    data, offsets = planted_band(300, 3, np.float64, seed)
    x0 = np.random.default_rng(100 + seed).uniform(-1, 1, 300)
    rj, rt = both(jax_operator(kind, data, offsets), (1000, 1e-10), x0)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    assert rt.eigenvalue.dtype == torch.float64
    np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)
    assert rt.eigenvector.shape == (300,)
    np.testing.assert_allclose(rt.eigenvector.numpy(), np.asarray(rj.eigenvector),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_f32_matches_jax(kind, seed):
    data, offsets = planted_band(300, 3, np.float32, seed)
    x0 = np.random.default_rng(100 + seed).uniform(-1, 1, 300)
    rj, rt = both(jax_operator(kind, data, offsets), (1000, 1e-6), x0)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    assert rt.eigenvalue.dtype == torch.float32
    np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-5)
    np.testing.assert_allclose(rt.eigenvector.numpy(), np.asarray(rj.eigenvector),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "csr", "dia"])
def test_complex128_matches_jax(kind):
    rng = np.random.default_rng(5)
    data, offsets = planted_band(120, 2, np.float64, 5)
    data = data + 1j * rng.uniform(-0.5, 0.5, data.shape) * (data != 0)
    x0 = rng.uniform(-1, 1, 120)
    rj, rt = both(jax_operator(kind, data, offsets), (1000, 1e-10), x0)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged)
    np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)


@pytest.mark.parametrize("kind", ["dense", "dia", "il"])
def test_breakdown_matches_jax(kind):
    # A = 0: ||A x0|| == 0 on the first iteration -> converged=False after
    # one iteration, x0 and lambda=0 kept (power_method.hpp:73-76)
    data = np.zeros((3, 200))
    x0 = np.random.default_rng(1).uniform(-1, 1, 200)
    rj, rt = both(jax_operator(kind, data, (-1, 0, 1)), (50, 1e-10), x0)
    assert (int(rt.iterations), bool(rt.converged)) == (int(rj.iterations),
                                                        bool(rj.converged)) == (1, False)
    assert complex(rt.eigenvalue) == complex(rj.eigenvalue) == 0
    np.testing.assert_allclose(rt.eigenvector.numpy(), x0 / np.linalg.norm(x0), rtol=1e-14)


@pytest.mark.parametrize("max_iterations", [0, 1, 7, 45])
def test_iteration_budget_matches_jax(max_iterations):
    # tolerance 0 never converges here: the count is the budget, with the
    # block loop stopping mid-block where the budget ends
    data, offsets = planted_band(200, 3, np.float64, 2)
    x0 = np.random.default_rng(2).uniform(-1, 1, 200)
    rj, rt = both(jax_operator("il", data, offsets), (max_iterations, 0.0), x0)
    assert int(rt.iterations) == int(rj.iterations) == max_iterations
    assert not bool(rt.converged) and not bool(rj.converged)
    np.testing.assert_allclose(complex(rt.eigenvalue), complex(rj.eigenvalue), rtol=1e-10)


@pytest.mark.parametrize("block", [1, 5, 64])
def test_result_independent_of_block_length(block, monkeypatch):
    data, offsets = planted_band(300, 3, np.float64, 3)
    m = T.SparseDIA(data=torch.from_numpy(data), offsets=offsets, shape=(300, 300))
    x0 = np.random.default_rng(3).uniform(-1, 1, 300)
    ref = T.power_method(m, T.SolverOptions(1000, 1e-10), x0=x0)
    monkeypatch.setattr(tpower, "BLOCK_ITERATIONS", block)
    r = T.power_method(m, T.SolverOptions(1000, 1e-10), x0=x0)
    assert int(r.iterations) == int(ref.iterations) and bool(r.converged)
    assert torch.equal(r.eigenvector, ref.eigenvector)
    assert torch.equal(r.eigenvalue, ref.eigenvalue)


def test_whole_slice_matches_jax():
    # generator -> interleaved layout -> power_method, as tests/test_dia.py's
    # operator-protocol test runs it on the JAX side
    dj = j_banded_full(4000, bandwidth=5, dtype=np.float32, seed=3)
    dt = t_banded_full(4000, bandwidth=5, dtype=np.float32, seed=3, device="cpu")
    np.testing.assert_array_equal(dt.data.numpy(), np.asarray(dj.data))
    mj, il = dj.interleaved(), dt.interleaved()
    x0 = np.random.default_rng(0).standard_normal(4000)
    rj = J.power_method(mj, J.SolverOptions(1000, 1e-5), x0=x0)
    rt = T.power_method(il, T.SolverOptions(1000, 1e-5), x0=x0)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(float(rt.eigenvalue), float(rj.eigenvalue), rtol=1e-5)
    assert rt.eigenvector.shape == (4000,)


@pytest.mark.parametrize("call", [
    lambda M, cpu: M.power_method(M.DenseMatrix.from_array(np.ones((2, 3)), **cpu)),
    lambda M, cpu: M.power_method(M.DenseMatrix.from_array(np.zeros((0, 0)), **cpu)),
    lambda M, cpu: M.power_method(M.DenseMatrix.from_array(np.eye(2, dtype=np.float32), **cpu),
                                  dtype=np.float64),
], ids=["non-square", "zero-size", "dtype"])
def test_errors_match_jax(call):
    errors = []
    for M, cpu in ((T, {"device": "cpu"}), (J, {})):
        with pytest.raises((TypeError, ValueError)) as err:
            call(M, cpu)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]


def test_reference_files_default_start():
    # demo.py:50-53 options; the default start comes from a seeded torch
    # generator, so the counts differ from JAX's but the eigenvalues agree
    opts = T.SolverOptions(max_iterations=1000, tolerance=1e-10)
    for name, expected in (("A.txt", 5 - 1j), ("B.txt", 4 + 5j)):
        m = T.read_matrix_from_file(os.path.join(DATA, name), torch.complex128, device="cpu")
        r1 = T.power_method(m, opts)
        r2 = T.power_method(m, opts, generator=default_generator())
        assert bool(r1.converged)
        np.testing.assert_allclose(complex(r1.eigenvalue), expected, rtol=1e-6)
        assert torch.equal(r1.eigenvector, r2.eigenvector)


def test_random_unit_vector():
    g = torch.Generator().manual_seed(7)
    x = random_unit_vector(g, 1000, torch.complex64)
    assert x.dtype == torch.complex64 and x.shape == (1000,)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(x)), 1.0, rtol=1e-6)
    assert float(x.real.abs().max()) < 1 and float(x.imag.abs().max()) > 0
    y = random_unit_vector(torch.Generator().manual_seed(7), 1000, np.complex64)
    assert torch.equal(x, y)


@pytest.mark.parametrize("a,b,tol", [(1.0, 1.0 + 1e-9, 1e-9), (100.0, 100.5, 1e-3),
                                     (1 + 1j, 1 + 1.001j, 1e-3), (0.0, 1e-12, 1e-12)])
def test_is_close_relative_matches_jax(a, b, tol):
    expected = bool(j_close(jnp.asarray(a), jnp.asarray(b), tol))
    assert bool(T.is_close_relative(torch.tensor(a), torch.tensor(b), tol)) == expected
