"""The port's distributed shifted and Krylov solvers against the JAX package,
on the CPU: BiCGStab with injected reductions, ``solve_shifted_distributed``,
distributed shifted inverse power (the cases of
tests/test_parallel_krylov.py), distributed Lanczos on the ELL, DIA and
interleaved partitions, and distributed block iteration.

JAX runs on ``make_row_mesh(4)``; the port on 4 gloo ranks spawned once for
the module (``torch_ranks.krylov_cases``), on the same numpy inputs and the
same explicit start vectors; the block iteration's start block is JAX's
host draw from its key, handed to the port as ``X0``.

Tolerances (float64): BiCGStab against ``numpy.linalg.solve`` to the JAX
test's 1e-8 / 1e-7 relative and against the JAX function to 1e-12;
eigenvalues within 1e-10 relative with equal counts and flags (the port's
``bicgstab`` is a port of the same JAX function the distributed inverse
power runs); Ritz values within 1e-10 of max|lambda|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random, laplacian_1d
from pcsc_eigenvalue_solver_project_tpu.parallel import dia as jd
from pcsc_eigenvalue_solver_project_tpu.parallel.inverse_power import (
    distributed_shifted_inverse_power)
from pcsc_eigenvalue_solver_project_tpu.parallel.krylov import bicgstab as j_bicgstab
from pcsc_eigenvalue_solver_project_tpu.parallel.lanczos import distributed_lanczos_eigenvalues
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.parallel.sharded import partition_ell
from pcsc_eigenvalue_solver_project_tpu.parallel.subspace import distributed_subspace_iteration
from pcsc_eigenvalue_solver_project_tpu.solvers.inverse_power import (
    shifted_inverse_power_method)
from pcsc_eigenvalue_solver_project_tpu.utils.prng import random_unit_vector
from pcsc_eigenvalue_solver_project_tpu_torch.parallel.krylov import bicgstab
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import norm as t_norm
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.power import vdot as t_vdot
from torch_ranks import krylov_cases, run_ranks

WORLD = 4
SUBSPACE_KEY = 12
# The inverse power cases of tests/test_parallel_krylov.py, sized for the
# gloo ranks, where each BiCGStab iteration is eight collectives: the first
# case's Laplacian at 48 rows with the shift 0.665, a tenth of the way from
# its nearest eigenvalue to the next (JAX's test: 96 rows and 0.7), the
# Laplacians' inner solves at 1e-10 (JAX's: 1e-13, which BiCGStab does not
# reach there, so that every inner solve runs its 4 n_padded iterations),
# the padded case's outer tolerance 1e-7 (JAX's: 1e-10; ~90 outer
# iterations). The inner solves run to their tolerance: a capped BiCGStab
# makes the outer map inexact, and the port and JAX may then settle on
# different eigenpairs.
INVERSE_OPTS = {
    "L48": dict(shift=0.665, tolerance=1e-10, inner_method="bicgstab", inner_tolerance=1e-10),
    "L64": dict(shift=float(2 - 2 * np.cos(21 * np.pi / 65)) + 1e-3, tolerance=1e-12,
                inner_tolerance=1e-10),
    "B50": dict(shift=0.05, tolerance=1e-7, inner_tolerance=1e-13),
}


def coo(m):
    return (np.asarray(m.rows), np.asarray(m.indices), np.asarray(m.data), tuple(m.shape))


def symmetric_band(n=96, seed=7):
    """The symmetric tridiagonal of ``dryrun_multichip``'s Lanczos leg, in
    float64: planted extremes 14, 10, 8 over a uniform [0.5, 2] diagonal."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(0.5, 2.0, n)
    diag[:3] = 14.0, 10.0, 8.0
    off = np.full(n, 0.1)
    data = np.stack([off.copy(), diag, off.copy()])
    data[0, 0] = 0.0
    data[2, n - 1:] = 0
    return SparseDIA(data=jnp.asarray(data), offsets=(-1, 0, 1), shape=(n, n))


@pytest.fixture(scope="module")
def jmesh():
    return make_row_mesh(WORLD)


@pytest.fixture(scope="module")
def mats():
    sym = symmetric_band()
    return {"L96": laplacian_1d(96), "L48": laplacian_1d(48), "L64": laplacian_1d(64),
            "B50": banded_random(50, bandwidth=2, nnz_per_row=3, seed=9, diag_boost=4.0),
            "sym_dia": sym, "sym": J.SparseCSR.from_dense(np.asarray(sym.to_dense()))}


def subspace_start(key_seed, b, n):
    """JAX's host start block of ``distributed_subspace_iteration`` (b, n)."""
    key = jax.random.key(key_seed)
    rng = np.random.default_rng(np.asarray(jax.random.key_data(key))[-1])
    return rng.uniform(-1, 1, (b, n))


@pytest.fixture(scope="module")
def inputs(mats):
    key = jax.random.key(42)
    n_sym = mats["sym_dia"].shape[0]
    eigs64 = 2 - 2 * np.cos(np.arange(1, 65) * np.pi / 65)
    return {
        **{name: coo(mats[name]) for name in ("L96", "L48", "L64", "B50", "sym")},
        "sym_dia": (np.array(mats["sym_dia"].data), mats["sym_dia"].offsets),
        "x0_48": np.array(jax.random.uniform(key, (48,), jnp.float64, minval=-1, maxval=1)),
        "x0_64": np.array(random_unit_vector(key, 64, np.float64)),
        "x0_50": np.array(random_unit_vector(key, 50, np.float64)),
        "inverse_opts": INVERSE_OPTS, "target": float(eigs64[20]),
        "b96": np.random.default_rng(5).random(96),
        "x0_sym": np.array(random_unit_vector(jax.random.key(11), n_sym, np.float64)),
        "X0_sym": subspace_start(SUBSPACE_KEY, 8, n_sym).T.copy(),
    }


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return run_ranks(krylov_cases, WORLD, tmp_path_factory.mktemp("ranks"), inputs)


def gather(runs, pick):
    return np.concatenate([pick(r) for r in runs])


def assert_same_on_every_rank(results, key="eigenvalue"):
    for r in results[1:]:
        assert np.array_equal(np.asarray(r[key]), np.asarray(results[0][key]))
        assert (r["iterations"], r["converged"]) == (results[0]["iterations"],
                                                     results[0]["converged"])


class TestBicgstab:
    """The port's generic BiCGStab against the JAX function it ports."""

    @staticmethod
    def both(a, b, precond=None):
        x, res, k = bicgstab(lambda v: torch.from_numpy(a) @ v, torch.from_numpy(b),
                             vdot=t_vdot, norm=t_norm, tol=1e-12,
                             precond=None if precond is None else
                             (lambda v: v / torch.from_numpy(precond)))
        xj, resj, kj = j_bicgstab(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), vdot=jnp.vdot,
                                  norm=jnp.linalg.norm, tol=1e-12,
                                  precond=None if precond is None else
                                  (lambda v: v / jnp.asarray(precond)))
        assert int(k) == int(kj)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)
        return x.numpy(), float(res)

    def test_single_chip_solve(self):
        rng = np.random.default_rng(0)
        n = 40
        a = np.diag(rng.random(n) + 3.0) + 0.1 * rng.random((n, n))
        b = rng.random(n)
        x, res = self.both(a, b)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8, atol=1e-10)
        assert res <= 1e-10 * np.linalg.norm(b) + 1e-12

    def test_preconditioned(self):
        rng = np.random.default_rng(1)
        n = 50
        d = rng.random(n) * 100 + 1
        a = np.diag(d) + 0.01 * rng.random((n, n))
        b = rng.random(n)
        x, _ = self.both(a, b, precond=d)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-7, atol=1e-9)

    def test_complex(self):
        rng = np.random.default_rng(2)
        n = 20
        a = np.diag(rng.random(n) + 2 + 1j) + 0.05 * (rng.random((n, n))
                                                      + 1j * rng.random((n, n)))
        b = rng.random(n) + 1j * rng.random(n)
        x, _ = self.both(a, b)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-7, atol=1e-9)


class TestSolveShiftedDistributed:
    def test_solves_to_a_residual(self, runs, mats, inputs):
        a = np.asarray(mats["L96"].to_dense()) - 0.3 * np.eye(96)
        b = inputs["b96"]
        want = np.linalg.solve(a, b)
        for key in ("solve", "solve_plain"):
            np.testing.assert_allclose(gather(runs, lambda r: r[key]), want, rtol=1e-8)
        assert runs[0]["solve_residual"] <= 1e-11 * np.linalg.norm(b)

    def test_stopped_solve_returns_its_start(self, runs):
        np.testing.assert_array_equal(gather(runs, lambda r: r["solve_stopped"]), 0.0)

    def test_partitioned_diagonal(self, runs, mats):
        np.testing.assert_array_equal(gather(runs, lambda r: r["diag"]),
                                      np.diag(np.asarray(mats["L96"].to_dense())))


class TestDistributedInversePower:
    @pytest.mark.parametrize("exchange", ["all_gather", "halo"])
    def test_matches_jax_and_single_chip(self, runs, jmesh, mats, inputs, exchange):
        m = mats["L48"]
        opts = J.ShiftedSolverOptions(**INVERSE_OPTS["L48"])
        jr = distributed_shifted_inverse_power(partition_ell(m, jmesh), jmesh, opts,
                                               exchange=exchange, x0=inputs["x0_48"])
        seq = shifted_inverse_power_method(m, opts, x0=inputs["x0_48"])
        r = runs[0]["inverse"][exchange]
        assert r["converged"]
        np.testing.assert_allclose(complex(r["eigenvalue"]), complex(jr.eigenvalue),
                                   rtol=1e-10)
        np.testing.assert_allclose(complex(r["eigenvalue"]), complex(seq.eigenvalue), rtol=1e-7)
        assert r["iterations"] == int(jr.iterations)
        assert r["converged"] == bool(jr.converged)
        assert_same_on_every_rank([q["inverse"][exchange] for q in runs])

    def test_targets_nearest_eigenvalue(self, runs, inputs):
        r = runs[0]["inverse_target"]
        assert r["converged"]
        np.testing.assert_allclose(float(np.real(r["eigenvalue"])), inputs["target"],
                                   rtol=1e-7)

    def test_padding_rows_not_excited(self, runs, jmesh, mats, inputs):
        # 50 rows over 4 ranks: the padded operator has spurious zero
        # eigenvalues; with zero padding in the start vector they stay dark
        # even with the shift near zero
        v = gather(runs, lambda r: r["inverse_padded"]["eigenvector"])
        assert np.abs(v[50:]).max() == 0.0
        eigs = np.linalg.eigvals(np.asarray(mats["B50"].to_dense()))
        lam = complex(runs[0]["inverse_padded"]["eigenvalue"])
        assert min(abs(eigs - lam)) < 1e-5
        jr = distributed_shifted_inverse_power(
            partition_ell(mats["B50"], jmesh), jmesh,
            J.ShiftedSolverOptions(**INVERSE_OPTS["B50"]), x0=inputs["x0_50"])
        np.testing.assert_allclose(lam, complex(jr.eigenvalue), rtol=1e-10)
        assert runs[0]["inverse_padded"]["iterations"] == int(jr.iterations)


def jax_lanczos(kind, which, jmesh, mats, inputs, reorth=True):
    sym = mats["sym_dia"]
    A = {"ell": lambda: partition_ell(mats["sym"], jmesh),
         "dia": lambda: jd.partition_dia(sym, jmesh),
         "il": lambda: jd.partition_dia_il(sym, jmesh, tile_s=8)}[kind]()
    return distributed_lanczos_eigenvalues(A, jmesh, k=3, m=24, which=which, reorth=reorth,
                                           opts=J.SolverOptions(tolerance=1e-10),
                                           x0=inputs["x0_sym"])


class TestDistributedLanczos:
    @pytest.mark.parametrize("label", ["ell LM", "ell LA", "ell SA", "dia LA", "il LA",
                                       "ell LA noreorth"])
    def test_matches_jax(self, runs, jmesh, mats, inputs, label):
        kind, which = label.split()[:2]
        jr = jax_lanczos(kind, which, jmesh, mats, inputs, reorth="noreorth" not in label)
        r = runs[0]["lanczos"][label]
        want = np.asarray(jr.eigenvalues)
        assert np.abs(r["eigenvalues"] - want).max() <= 1e-10 * np.abs(want).max()
        assert r["iterations"] == int(jr.iterations)
        assert r["converged"] == bool(jr.converged)
        assert_same_on_every_rank([q["lanczos"][label] for q in runs], "eigenvalues")

    def test_against_numpy(self, runs, mats):
        truth = np.sort(np.linalg.eigvalsh(np.asarray(mats["sym_dia"].to_dense())))[::-1][:3]
        got = np.sort(runs[0]["lanczos"]["il LA"]["eigenvalues"])[::-1]
        assert np.abs(got - truth).max() < 1e-8

    def test_argument_errors(self, runs):
        kind, which, k0, big_k = runs[0]["lanczos_errors"]
        assert "must be a PartitionedELL, PartitionedDIA or PartitionedILDIA" in kind
        assert "unknown which='XX'" in which
        assert "k must be >= 1" in k0
        assert "k (40) must be <= m (30)" in big_k


class TestDistributedSubspace:
    def test_matches_jax(self, runs, jmesh, mats):
        A = jd.partition_dia_il(mats["sym_dia"], jmesh, tile_s=8)
        jr = distributed_subspace_iteration(A, jmesh, k=2, key=jax.random.key(SUBSPACE_KEY),
                                            opts=J.SolverOptions(max_iterations=400,
                                                                 tolerance=1e-6))
        r = runs[0]["subspace"]
        want = np.asarray(jr.eigenvalues)
        assert r["converged"] and bool(jr.converged)
        assert np.abs(r["eigenvalues"] - want).max() <= 1e-10 * np.abs(want).max()
        assert r["iterations"] == int(jr.iterations)
        truth = np.sort(np.linalg.eigvalsh(np.asarray(mats["sym_dia"].to_dense())))[::-1][:2]
        assert np.abs(np.sort(np.abs(r["eigenvalues"]))[::-1] - truth).max() < 1e-6 * truth[0]
        assert_same_on_every_rank([q["subspace"] for q in runs], "eigenvalues")

    def test_argument_errors(self, runs):
        k0, small_block, bad_x0 = runs[0]["subspace_errors"]
        assert "k must be >= 1" in k0
        assert "block (2) must be >= k (4)" in small_block
        assert "X0 must be (96, 8)" in bad_x0

    def test_generator_start_is_the_same_on_every_rank(self, runs):
        assert_same_on_every_rank([q["subspace_generator"] for q in runs], "eigenvalues")
        assert runs[0]["subspace_generator"]["iterations"] == 20
