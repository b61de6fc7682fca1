"""The PyTorch port's distributed layer against the JAX package, on the CPU:
row meshes, the ELL partition and its SpMV, the distributed power method,
distributed Krylov-Schur, and the row-block reader (the cases of
tests/test_parallel.py, the mesh, and ``io/distributed.py``).

The JAX side runs here on ``make_row_mesh(4)`` over conftest's host
devices; the port runs on 4 gloo ranks (``torch_ranks.run_ranks``, spawned
once for the module) on the same numpy inputs and the same explicit start
vectors (JAX's defaults come from ``jax.random``). Each rank's partition
block must equal the JAX partition's slice exactly, and
``from_numpy_leaves`` must carry the JAX partition across to it.

Tolerances: in float64/complex128 eigenvalues within 1e-10 relative with
equal iteration counts and flags; products within 1e-12 relative. Every
rank's eigenvalue, count and flag must be equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.io.distributed import load_partitioned as j_load
from pcsc_eigenvalue_solver_project_tpu.io.distributed import read_sparse_row_block as j_read
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random, laplacian_1d
from pcsc_eigenvalue_solver_project_tpu.parallel.arnoldi import (
    distributed_arnoldi_eigenvalues, distributed_krylov_schur_eigenvalues)
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.parallel.power import distributed_power_method
from pcsc_eigenvalue_solver_project_tpu.parallel.sharded import distributed_matvec, partition_ell
from pcsc_eigenvalue_solver_project_tpu.utils.prng import random_unit_vector
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.io.distributed import read_sparse_row_block
from pcsc_eigenvalue_solver_project_tpu_torch.parallel import mesh as pm
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves
from torch_ranks import parallel_cases, run_ranks

WORLD = 4


def coo(m):
    return (np.asarray(m.rows), np.asarray(m.indices), np.asarray(m.data), tuple(m.shape))


def clustered(n=320, seed=0):
    """The clustered non-symmetric operator of tests/test_parallel.py's
    Krylov-Schur case and its top-3 eigenvalues."""
    rng = np.random.default_rng(seed)
    diag = np.concatenate([[5.0, 4.9995, 4.999], rng.uniform(0, 4.0, n - 3)])
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i)
        cols.append(i)
        vals.append(diag[i])
        for off in (-3, 2):
            j = i + off
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(0.01 * rng.standard_normal())
    return J.SparseCSR.from_coo(np.array(rows), np.array(cols), np.array(vals, np.float64),
                                (n, n), dtype=np.float64)


NAMES = ("L96", "L100", "L128", "L24", "wide", "corner", "general", "cplx", "B50")
# tests/test_parallel.py's power cases with a budget of 300 iterations (JAX's
# test: the default 1000; the Laplacian does not converge in either): each
# iteration is three collectives on the gloo ranks
POWER_OPTS = dict(tolerance=1e-10, max_iterations=300)


def matrices():
    return {
        "L96": laplacian_1d(96), "L100": laplacian_1d(100), "L128": laplacian_1d(128),
        "L24": laplacian_1d(24),
        "wide": J.SparseCSR.from_coo([0, 80], [80, 0], [1.0, 1.0], (128, 128)),
        "corner": J.SparseCSR.from_coo([0, 127], [127, 0], [1.0, 1.0], (128, 128)),
        "general": banded_random(64, bandwidth=40, nnz_per_row=5, seed=3),
        "cplx": banded_random(48, bandwidth=3, nnz_per_row=4, dtype=np.complex128, seed=5),
        "B50": banded_random(50, bandwidth=2, nnz_per_row=3, seed=9, diag_boost=5.0),
    }


@pytest.fixture(scope="module")
def jmesh():
    return make_row_mesh(WORLD)


@pytest.fixture(scope="module")
def mats():
    return matrices()


@pytest.fixture(scope="module")
def inputs(mats, tmp_path_factory):
    rng = np.random.default_rng(0)
    key = jax.random.key(42)
    folder = tmp_path_factory.mktemp("files")
    sparse_file, dense_file = folder / "s.txt", folder / "d.txt"
    sparse_file.write_text(open("data/B.txt").read())
    dense_file.write_text(open("data/A.txt").read())
    return {
        "partitions": list(mats), **{name: coo(m) for name, m in mats.items()},
        "x96": rng.random(96), "x64": np.random.default_rng(1).random(64),
        "xc48": np.random.default_rng(2).random(48) + 1j * np.random.default_rng(3).random(48),
        "power_opts": POWER_OPTS,
        "x0_96": np.array(jax.random.uniform(key, (96,), jnp.float64, minval=-1, maxval=1)),
        "x0_50": np.array(random_unit_vector(key, 50, np.float64)),
        "ks": coo(clustered()), "x0_ks": np.array(random_unit_vector(key, 320, np.float64)),
        "sparse_file": str(sparse_file), "dense_file": str(dense_file),
    }


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return run_ranks(parallel_cases, WORLD, tmp_path_factory.mktemp("ranks"), inputs)


def gather(runs, pick):
    """The ranks' blocks of one result, concatenated along axis 0."""
    return np.concatenate([pick(r) for r in runs])


def jax_leaves(A):
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(A)]
    static = {f.name: getattr(A, f.name) for f in dataclasses.fields(A)
              if f.metadata.get("static")}
    return leaves, static


def fake_mesh(rank):
    """A row mesh of the 4 ranks seen from ``rank``, for the host-side
    ``from_numpy_leaves`` (no collective runs)."""
    return pm.RowMesh(group=None, rank=rank, world_size=WORLD, device=torch.device("cpu"))


def assert_same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        assert np.array_equal(np.asarray(r["eigenvalue"]), np.asarray(first["eigenvalue"]))
        assert r["iterations"] == first["iterations"]
        assert r["converged"] == first["converged"]


class TestMesh:
    def test_rank_world_and_device(self, runs):
        for rank, r in enumerate(runs):
            assert r["mesh"] == (rank, WORLD, {"rows": WORLD}, "cpu", "rows")

    def test_more_devices_than_ranks_raises(self, runs):
        assert "requested 5 devices" in runs[0]["more_devices"]

    def test_cuda_rank_on_a_gloo_group_raises(self, runs):
        assert "needs an NCCL group" in runs[0]["cuda_on_gloo"]

    def test_cpu_rank_on_an_nccl_group_raises(self, runs):
        assert "needs a gloo group" in runs[0]["cpu_on_nccl"]

    def test_no_process_group_raises(self):
        with pytest.raises(RuntimeError, match="no process group"):
            pm.make_row_mesh(device="cpu")

    def test_row_block(self, runs):
        full = np.arange(16).reshape(8, 2)
        np.testing.assert_array_equal(gather(runs, lambda r: r["row_block"]), full)
        assert "do not split" in runs[0]["row_block_uneven"]

    def test_collectives(self, runs):
        for r in runs:
            np.testing.assert_array_equal(r["all_reduce"], [10.0 + 0j, 4j])
            np.testing.assert_array_equal(r["all_gather"],
                                          np.repeat(np.arange(WORLD), 2)[:, None] * np.ones(3))


class TestPartitioning:
    def test_pads_to_multiple(self, runs):
        A = runs[0]["partitions"]["L100"]
        assert A["n_padded"] % WORLD == 0
        assert A["n_orig"] == 100

    def test_halo_detected_for_banded(self, runs):
        assert runs[0]["partitions"]["L128"]["halo_ok"]

    def test_halo_rejected_for_wide(self, runs, jmesh, mats):
        # entry 2 blocks off the diagonal (and not cyclically adjacent)
        assert not runs[0]["partitions"]["wide"]["halo_ok"]
        assert not partition_ell(mats["wide"], jmesh).halo_ok

    def test_halo_ok_for_periodic_corner(self, runs):
        assert runs[0]["partitions"]["corner"]["halo_ok"]

    @pytest.mark.parametrize("name", NAMES)
    def test_rank_blocks_equal_the_jax_partition(self, runs, jmesh, mats, name):
        A = partition_ell(mats[name], jmesh)
        for r in runs:
            got = r["partitions"][name]
            assert (got["n_orig"], got["n_shards"], got["n_padded"], got["halo_ok"],
                    got["nnz"]) == (A.n_orig, A.n_shards, A.n_padded, A.halo_ok, A.nnz)
        np.testing.assert_array_equal(gather(runs, lambda r: r["partitions"][name]["data"]),
                                      np.asarray(A.data))
        np.testing.assert_array_equal(
            gather(runs, lambda r: r["partitions"][name]["indices"]), np.asarray(A.indices))

    @pytest.mark.parametrize("name", ["L96", "cplx", "wide"])
    def test_from_numpy_leaves_gives_the_rank_block(self, runs, jmesh, mats, name):
        leaves, static = jax_leaves(partition_ell(mats[name], jmesh))
        for rank, r in enumerate(runs):
            A = from_numpy_leaves("PartitionedELL", leaves, static, mesh=fake_mesh(rank))
            want = r["partitions"][name]
            np.testing.assert_array_equal(A.data.numpy(), want["data"])
            np.testing.assert_array_equal(A.indices.numpy(), want["indices"])
            assert (A.halo_ok, A.nnz, A.n_padded) == (want["halo_ok"], want["nnz"],
                                                      want["n_padded"])

    def test_from_numpy_leaves_checks_the_mesh(self, jmesh, mats):
        leaves, static = jax_leaves(partition_ell(mats["L96"], jmesh))
        with pytest.raises(ValueError, match="needs the mesh"):
            from_numpy_leaves("PartitionedELL", leaves, static)
        small = pm.RowMesh(group=None, rank=0, world_size=2, device=torch.device("cpu"))
        with pytest.raises(ValueError, match="4 shards, the mesh 2 ranks"):
            from_numpy_leaves("PartitionedELL", leaves, static, mesh=small)


class TestDistributedSpMV:
    @pytest.mark.parametrize("exchange", ["all_gather", "halo"])
    def test_matches_sequential(self, runs, jmesh, mats, inputs, exchange):
        m = mats["L96"]
        A = partition_ell(m, jmesh)
        x = inputs["x96"]
        xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("rows")))
        y_jax = np.asarray(distributed_matvec(A, xs, jmesh, exchange=exchange))
        y = gather(runs, lambda r: r["matvec"][exchange])
        np.testing.assert_allclose(y, y_jax, rtol=1e-13)
        np.testing.assert_allclose(y, np.asarray(m.matvec(jnp.asarray(x))), rtol=1e-13)

    def test_general_matrix_all_gather(self, runs, mats, inputs):
        y = gather(runs, lambda r: r["matvec_general"])
        expected = np.asarray(mats["general"].matvec(jnp.asarray(inputs["x64"])))
        np.testing.assert_allclose(y, expected, rtol=1e-12)

    def test_complex(self, runs, mats, inputs):
        y = gather(runs, lambda r: r["matvec_complex"])
        expected = np.asarray(mats["cplx"].matvec(jnp.asarray(inputs["xc48"])))
        np.testing.assert_allclose(y, expected, rtol=1e-12)

    def test_bad_exchange_and_axis_raise(self, runs):
        assert "unknown exchange 'ring'" in runs[0]["unknown_exchange"]
        assert "cols" in runs[0]["wrong_axis"]


class TestDistributedPower:
    @pytest.mark.parametrize("exchange", ["all_gather", "halo"])
    def test_matches_jax_and_single_device(self, runs, jmesh, mats, inputs, exchange):
        m = mats["L96"]
        x0 = inputs["x0_96"]
        jd = distributed_power_method(partition_ell(m, jmesh), jmesh,
                                      J.SolverOptions(**POWER_OPTS), exchange=exchange, x0=x0)
        seq = T.power_method(T.SparseCSR.from_coo(*coo(m)[:3], (96, 96), device="cpu"),
                             T.SolverOptions(**POWER_OPTS), x0=x0)
        r = runs[0]["power"][exchange]
        for want in (complex(jd.eigenvalue), complex(seq.eigenvalue)):
            np.testing.assert_allclose(complex(r["eigenvalue"]), want, rtol=1e-10)
        assert r["iterations"] == int(jd.iterations) == int(seq.iterations)
        assert r["converged"] == bool(jd.converged) == bool(seq.converged)
        v = gather(runs, lambda q: q["power"][exchange]["eigenvector"])
        np.testing.assert_allclose(np.abs(np.vdot(v, np.asarray(jd.eigenvector))), 1.0,
                                   rtol=1e-8)
        np.testing.assert_allclose(np.abs(np.vdot(v, seq.eigenvector.numpy())), 1.0, rtol=1e-8)
        assert_same_on_every_rank([q["power"][exchange] for q in runs])

    def test_analytic_eigenvalue(self, runs):
        n = 24
        r = runs[0]["power_analytic"]
        assert r["converged"]
        np.testing.assert_allclose(float(np.real(r["eigenvalue"])),
                                   2 - 2 * np.cos(n * np.pi / (n + 1)), rtol=1e-6)
        assert_same_on_every_rank([q["power_analytic"] for q in runs])

    def test_non_divisible_size(self, runs, jmesh, mats, inputs):
        # 50 rows over 4 ranks: the padding path
        m = mats["B50"]
        opts = J.SolverOptions(tolerance=1e-10)
        jd = distributed_power_method(partition_ell(m, jmesh), jmesh, opts, x0=inputs["x0_50"])
        r = runs[0]["power_padded"]
        np.testing.assert_allclose(complex(r["eigenvalue"]), complex(jd.eigenvalue), rtol=1e-10)
        assert r["iterations"] == int(jd.iterations)
        assert r["converged"] == bool(jd.converged)
        pad = gather(runs, lambda q: q["power_padded"]["eigenvector"])[50:]
        np.testing.assert_array_equal(pad, 0.0)
        assert_same_on_every_rank([q["power_padded"] for q in runs])

    def test_generator_start_is_the_same_on_every_rank(self, runs):
        assert_same_on_every_rank([q["power_generator"] for q in runs])
        assert runs[0]["power_generator"]["iterations"] == 5


class TestDistributedKrylovSchur:
    def test_clustered_spectrum_converges_where_fixed_m_fails(self, runs, jmesh, inputs):
        csr = clustered()
        truth = np.sort(np.linalg.eigvals(np.asarray(csr.to_dense())).real)[::-1][:3]
        A = partition_ell(csr, jmesh)
        opts = J.SolverOptions(tolerance=1e-8)
        x0 = inputs["x0_ks"]
        jks = distributed_krylov_schur_eigenvalues(A, jmesh, k=3, m=15, opts=opts, x0=x0)
        jfixed = distributed_arnoldi_eigenvalues(A, jmesh, k=3, m=15, opts=opts, x0=x0)
        fixed, ks = runs[0]["arnoldi_fixed"], runs[0]["krylov_schur"]
        assert np.abs(np.sort(fixed["eigenvalues"].real)[::-1] - truth).max() > 1e-3
        assert ks["converged"] and bool(jks.converged)
        assert np.abs(np.sort(ks["eigenvalues"].real)[::-1] - truth).max() < 1e-7
        np.testing.assert_allclose(np.sort_complex(ks["eigenvalues"]),
                                   np.sort_complex(np.asarray(jks.eigenvalues)), rtol=1e-10)
        np.testing.assert_allclose(np.sort_complex(fixed["eigenvalues"]),
                                   np.sort_complex(np.asarray(jfixed.eigenvalues)), rtol=1e-10)
        assert ks["iterations"] == int(jks.iterations)
        for q in runs:
            np.testing.assert_array_equal(q["krylov_schur"]["eigenvalues"], ks["eigenvalues"])

    def test_argument_errors(self, runs):
        k0, small_m, no_restarts = runs[0]["krylov_schur_errors"]
        assert "k must be >= 1" in k0
        assert "need m >= k + 2" in small_m
        assert "restarts must be >= 1" in no_restarts


MALFORMED = {
    "dense": "dense\n2 2\n1 2 3 4\n",
    "dims": "sparse\n0 3\n1\n0 0 1.0\n",
    "nnz": "sparse\n3 3\n0\n",
    "index": "sparse\n3 3\n1\n0 x 1.0\n",
    "range": "sparse\n3 3\n1\n0 3 1.0\n",
    "value": "sparse\n3 3\n1\n0 1 y\n",
    "short": "sparse\n3 3\n2\n0 1 1.0\n",
}


class TestRowBlockReader:
    @pytest.mark.parametrize("block", [(0, 5), (0, 2), (2, 4), (4, 5), (3, 3)])
    def test_rows_equal_jax(self, block):
        for dtype in (np.complex128, np.complex64):
            got = read_sparse_row_block("data/B.txt", dtype, *block)
            want = j_read("data/B.txt", dtype, *block)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
            assert got[3] == want[3]

    @pytest.mark.parametrize("name", list(MALFORMED))
    def test_malformed_files_raise_as_jax(self, tmp_path, name):
        path = tmp_path / f"{name}.txt"
        path.write_text(MALFORMED[name])
        with pytest.raises(ValueError) as want:
            j_read(str(path), np.float64, 0, 3)
        with pytest.raises(ValueError) as got:
            read_sparse_row_block(str(path), np.float64, 0, 3)
        assert str(got.value) == str(want.value)

    def test_bad_dtype_raises(self):
        with pytest.raises(TypeError):
            read_sparse_row_block("data/B.txt", np.int32, 0, 5)

    def test_load_partitioned(self, runs, jmesh):
        A = j_load("data/B.txt", jmesh, np.complex128)
        np.testing.assert_array_equal(gather(runs, lambda r: r["load_partitioned"]["data"]),
                                      np.asarray(A.data))
        np.testing.assert_array_equal(gather(runs, lambda r: r["load_partitioned"]["indices"]),
                                      np.asarray(A.indices))
        assert "expected a sparse matrix file" in runs[0]["load_dense_file"]
