"""The port's distributed banded operators against the JAX package, on the
CPU: the row-major and interleaved DIA partitions, their SpMVs, codec and
power methods, and the split-plane complex partition (the cases of
tests/test_parallel_dia.py and the split-complex leg of
``__graft_entry__.dryrun_multichip``).

JAX runs on ``make_row_mesh(4)``; the port on 4 gloo ranks spawned once for
the module (``torch_ranks.dia_cases``), on the same numpy inputs and start
vectors. Each rank's block must equal the JAX partition's slice exactly
(bf16 interleaved diagonals included), the interleaved encoding must equal
JAX's, and ``from_numpy_leaves`` must carry each JAX partition across.

Tolerances: float64 eigenvalues within 1e-10 relative with equal iteration
counts (row-major DIA, split planes); float32 eigenvalues within the JAX
test's own 1e-4 (1e-5 for the f32 split planes), counts not compared
(ROADMAP "f32 stopping below f32 eps"); products within 1e-12 in float64
and 1e-5 in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.matrix.dia import SparseDIA
from pcsc_eigenvalue_solver_project_tpu.matrix.split_complex import SplitComplexDIA
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full, laplacian_1d
from pcsc_eigenvalue_solver_project_tpu.parallel import dia as jd
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.parallel.split_complex import (
    distributed_splitc_power_method, partition_splitc_dia)
from pcsc_eigenvalue_solver_project_tpu.utils.prng import random_unit_vector
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.parallel import mesh as pm
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import from_numpy_leaves
from torch_ranks import dia_cases, run_ranks

WORLD = 4


def spec(m):
    return (np.array(m.data), tuple(m.offsets))


def split_operator(n, dtype, seed=3):
    """The split-plane operator of ``dryrun_multichip``'s third leg: three
    random diagonals, the main one shifted by 5 (dominant, well separated)."""
    rng = np.random.default_rng(seed)
    offs = (-1, 0, 1)
    planes = np.zeros((2, 3, n), dtype)
    for d, off in enumerate(offs):
        planes[0, d] = rng.standard_normal(n)
        planes[1, d] = rng.standard_normal(n)
        if off > 0:
            planes[:, d, n - off:] = 0
        elif off < 0:
            planes[:, d, :-off] = 0
    planes[0, 1] += 5.0
    return SplitComplexDIA(planes=jnp.asarray(planes), offsets=offs, shape=(n, n))


SPLIT = {"splitc32": (np.float32, 1e-6), "splitc64": (np.float64, 1e-10)}
# tests/test_parallel_dia.py's power case with a budget of 300 iterations
# (JAX's test: the default 1000; the Laplacian does not converge in either)
POWER_OPTS = dict(tolerance=1e-10, max_iterations=300)


@pytest.fixture(scope="module")
def jmesh():
    return make_row_mesh(WORLD)


@pytest.fixture(scope="module")
def mats():
    return {
        "L96": SparseDIA.from_csr(laplacian_1d(96)),
        "wide": banded_full(128, bandwidth=10, dtype=np.float64, seed=3),
        "too_wide": banded_full(32, bandwidth=10, dtype=np.float64, seed=4),
        "B50": banded_full(50, bandwidth=2, dtype=np.float64, seed=5, diag_boost=4.0),
        "band6000": banded_full(6000, bandwidth=5, dtype=np.float32, seed=6),
        "band5003": banded_full(5003, bandwidth=2, dtype=np.float32, seed=1),
        "band600": banded_full(600, bandwidth=20, dtype=np.float32, seed=0),
        **{name: split_operator(64, dt) for name, (dt, _) in SPLIT.items()},
    }


@pytest.fixture(scope="module")
def inputs(mats):
    key = jax.random.key(42)
    planes_x0 = {name: np.array(jax.random.uniform(jax.random.key(1), (2, 64), dt, -1, 1))
                 for name, (dt, _) in SPLIT.items()}
    return {
        **{name: spec(m) for name, m in mats.items() if not name.startswith("splitc")},
        **{name: (np.array(mats[name].planes), mats[name].offsets) for name in SPLIT},
        "power_opts": POWER_OPTS, "x96": np.random.default_rng(0).random(96),
        "x128": np.random.default_rng(1).random(128),
        "x0_96": np.array(jax.random.uniform(key, (96,), jnp.float64, minval=-1, maxval=1)),
        "x0_50": np.array(random_unit_vector(key, 50, np.float64)),
        "x6000": np.random.default_rng(0).standard_normal(6000).astype(np.float32),
        "x5003": np.random.default_rng(1).standard_normal(5003).astype(np.float32),
        "x0_6000": np.array(random_unit_vector(key, 6000, np.float32)),
        "x0_planes": planes_x0, "splitc_tol": {name: tol for name, (_, tol) in SPLIT.items()},
    }


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return run_ranks(dia_cases, WORLD, tmp_path_factory.mktemp("ranks"), inputs)


def gather(runs, pick, axis=0):
    return np.concatenate([pick(r) for r in runs], axis=axis)


def jax_leaves(A):
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(A)]
    static = {f.name: getattr(A, f.name) for f in dataclasses.fields(A)
              if f.metadata.get("static")}
    return leaves, static


def fake_mesh(rank):
    return pm.RowMesh(group=None, rank=rank, world_size=WORLD, device=torch.device("cpu"))


def assert_same_on_every_rank(results):
    for r in results[1:]:
        assert np.array_equal(np.asarray(r["eigenvalue"]), np.asarray(results[0]["eigenvalue"]))
        assert (r["iterations"], r["converged"]) == (results[0]["iterations"],
                                                     results[0]["converged"])


def sharded(x, jmesh, spec_=P("rows")):
    return jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec_))


class TestPartitionedDIA:
    def test_rank_blocks_equal_the_jax_partition(self, runs, jmesh, mats):
        A = jd.partition_dia(mats["L96"], jmesh)
        np.testing.assert_array_equal(gather(runs, lambda r: r["L96"]["data"], axis=1),
                                      np.asarray(A.data))
        for r in runs:
            got = r["L96"]
            assert (got["halo"], got["n_padded"], got["nnz"], got["offsets"]) == (
                A.halo, A.n_padded, A.nnz, A.offsets)
        leaves, static = jax_leaves(A)
        for rank, r in enumerate(runs):
            B = from_numpy_leaves("PartitionedDIA", leaves, static, mesh=fake_mesh(rank))
            np.testing.assert_array_equal(B.data.numpy(), r["L96"]["data"])
            assert (B.halo, B.offsets, B.nnz) == (A.halo, A.offsets, A.nnz)

    def test_matvec_matches_sequential(self, runs, jmesh, mats, inputs):
        m = mats["L96"]
        A = jd.partition_dia(m, jmesh)
        x = inputs["x96"]
        y = gather(runs, lambda r: r["matvec"])
        np.testing.assert_allclose(y, np.asarray(jd.distributed_dia_matvec(
            A, sharded(x, jmesh), jmesh)), rtol=1e-13)
        np.testing.assert_allclose(y[:96], np.asarray(m.matvec(jnp.asarray(x[:96]))),
                                   rtol=1e-13)

    def test_wide_band(self, runs, mats, inputs):
        # bandwidth close to rows_per_shard exercises deep halos
        y = gather(runs, lambda r: r["matvec_wide"])
        np.testing.assert_allclose(y, np.asarray(mats["wide"].matvec(jnp.asarray(
            inputs["x128"]))), rtol=1e-12)

    def test_bandwidth_exceeds_shard_rejected(self, runs):
        assert "bandwidth (10) exceeds rows per shard (8)" in runs[0]["too_wide"]

    def test_power_matches_jax_and_single_device(self, runs, jmesh, mats, inputs):
        m = mats["L96"]
        jr = jd.distributed_dia_power_method(jd.partition_dia(m, jmesh), jmesh,
                                             J.SolverOptions(**POWER_OPTS), x0=inputs["x0_96"])
        data, offs = inputs["L96"]
        seq = T.power_method(T.SparseDIA(data=torch.from_numpy(data), offsets=offs,
                                         shape=(96, 96)), T.SolverOptions(**POWER_OPTS),
                             x0=inputs["x0_96"])
        r = runs[0]["power"]
        for want in (complex(jr.eigenvalue), complex(seq.eigenvalue)):
            np.testing.assert_allclose(complex(r["eigenvalue"]), want, rtol=1e-10)
        assert r["iterations"] == int(jr.iterations) == int(seq.iterations)
        assert r["converged"] == bool(jr.converged) == bool(seq.converged)
        assert_same_on_every_rank([q["power"] for q in runs])

    def test_non_divisible(self, runs, jmesh, mats, inputs):
        opts = J.SolverOptions(tolerance=1e-10)
        jr = jd.distributed_dia_power_method(jd.partition_dia(mats["B50"], jmesh), jmesh, opts,
                                             x0=inputs["x0_50"])
        r = runs[0]["power_padded"]
        np.testing.assert_allclose(complex(r["eigenvalue"]), complex(jr.eigenvalue), rtol=1e-10)
        assert r["iterations"] == int(jr.iterations)
        np.testing.assert_array_equal(gather(runs, lambda q: q["power_padded"]["eigenvector"])[
            50:], 0.0)
        assert_same_on_every_rank([q["power_padded"] for q in runs])


class TestPartitionedILDIA:
    def test_rank_blocks_equal_the_jax_partition(self, runs, jmesh, mats):
        A = jd.partition_dia_il(mats["band6000"], jmesh)
        np.testing.assert_array_equal(gather(runs, lambda r: r["il"]["data_il"], axis=1),
                                      np.asarray(A.data_il))
        assert (runs[0]["il"]["R"], runs[0]["il"]["tile_s"]) == (A.R, A.tile_s)
        B = jd.partition_dia_il(mats["band6000"], jmesh, dtype=jnp.bfloat16)
        np.testing.assert_array_equal(gather(runs, lambda r: r["il_bf16"], axis=1),
                                      np.asarray(B.data_il).astype(np.float32))

    def test_from_numpy_leaves_gives_the_rank_block(self, runs, jmesh, mats):
        leaves, static = jax_leaves(jd.partition_dia_il(mats["band6000"], jmesh))
        for rank, r in enumerate(runs):
            A = from_numpy_leaves("PartitionedILDIA", leaves, static, mesh=fake_mesh(rank))
            np.testing.assert_array_equal(A.data_il.numpy(), r["il"]["data_il"])
            assert (A.R, A.tile_s, A.n_orig) == (r["il"]["R"], r["il"]["tile_s"], 6000)

    def test_encoding_equals_jax(self, runs, jmesh, mats, inputs):
        A = jd.partition_dia_il(mats["band6000"], jmesh)
        want = np.asarray(jd.encode_vec_il_sharded(inputs["x6000"], A, jmesh))
        np.testing.assert_array_equal(gather(runs, lambda r: r["il_encoded"]), want)

    def test_matvec_matches_single_chip(self, runs, jmesh, mats, inputs):
        m = mats["band6000"]
        A = jd.partition_dia_il(m, jmesh)
        x = inputs["x6000"]
        y_ref = np.asarray(m.matvec(jnp.asarray(x)))
        y_jax = jd.decode_vec_il_sharded(jd.distributed_dia_il_matvec(
            A, jd.encode_vec_il_sharded(x, A, jmesh), jmesh), A)
        for r in runs:
            np.testing.assert_allclose(r["il_matvec"], y_ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r["il_matvec"], y_jax, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(r["il_matvec_default_group"], r["il_matvec"])

    def test_codec_roundtrip(self, runs, inputs):
        for r in runs:
            np.testing.assert_array_equal(r["codec"], inputs["x5003"])

    def test_power_matches_row_major_distributed_and_jax(self, runs, jmesh, mats, inputs):
        m = mats["band6000"]
        opts = J.SolverOptions(max_iterations=2000, tolerance=1e-7)
        jr = jd.distributed_dia_il_power_method(jd.partition_dia_il(m, jmesh), jmesh, opts,
                                                x0=inputs["x0_6000"])
        r_il, r_row = runs[0]["il_power"], runs[0]["row_power"]
        assert r_il["converged"] and r_row["converged"] and bool(jr.converged)
        np.testing.assert_allclose(float(r_il["eigenvalue"]), float(r_row["eigenvalue"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(r_il["eigenvalue"]), float(jr.eigenvalue), rtol=1e-4)
        v = runs[0]["il_power_vector"]
        v_jax = jd.decode_vec_il_sharded(jr.eigenvector, jd.partition_dia_il(m, jmesh))
        assert abs(abs(np.vdot(v, v_jax)) - 1.0) < 1e-3
        assert_same_on_every_rank([q["il_power"] for q in runs])
        assert_same_on_every_rank([q["row_power"] for q in runs])

    def test_halo_exceeding_shard_raises(self, runs):
        # 4 ranks x tile 8 -> R = 8 sublanes a rank < pr = 24
        assert "halo (24) exceeds shard sublanes (8)" in runs[0]["il_too_wide"]


class TestPartitionedSplitComplex:
    @pytest.mark.parametrize("name", list(SPLIT))
    def test_rank_blocks_equal_the_jax_partition(self, runs, jmesh, mats, name):
        A = partition_splitc_dia(mats[name], jmesh)
        np.testing.assert_array_equal(gather(runs, lambda r: r["splitc"][name]["planes"],
                                             axis=2), np.asarray(A.planes))
        assert (runs[0]["splitc"][name]["halo"], runs[0]["splitc"][name]["n_padded"]) == (
            A.halo, A.n_padded)
        leaves, static = jax_leaves(A)
        for rank, r in enumerate(runs):
            B = from_numpy_leaves("PartitionedSplitComplexDIA", leaves, static,
                                  mesh=fake_mesh(rank))
            np.testing.assert_array_equal(B.planes.numpy(), r["splitc"][name]["planes"])

    @pytest.mark.parametrize("name", list(SPLIT))
    def test_power_matches_jax(self, runs, jmesh, mats, inputs, name):
        dt, tol = SPLIT[name]
        sc = mats[name]
        jr = distributed_splitc_power_method(
            partition_splitc_dia(sc, jmesh), jmesh,
            J.SolverOptions(max_iterations=500, tolerance=tol), x0=inputs["x0_planes"][name])
        r = runs[0]["splitc"][name]
        lam = complex(*np.asarray(r["eigenvalue"], np.float64))
        lam_jax = complex(*np.asarray(jr.eigenvalue, np.float64))
        ev = np.linalg.eigvals(sc.to_complex_dense())
        dom = ev[np.argmax(np.abs(ev))]
        assert r["converged"] and bool(jr.converged)
        if dt == np.float64:
            assert abs(lam - lam_jax) <= 1e-10 * abs(lam_jax)
            assert r["iterations"] == int(jr.iterations)
        else:
            assert abs(lam - lam_jax) <= 1e-5 * abs(lam_jax)
        assert abs(lam - dom) < 1e-3 * abs(dom)
        v = gather(runs, lambda q: q["splitc"][name]["eigenvector"], axis=1)
        np.testing.assert_array_equal(v[:, 64:], 0.0)
        assert_same_on_every_rank([q["splitc"][name] for q in runs])

    def test_bad_start_planes_raise(self, runs):
        assert "x0 must be (2, n) planes" in runs[0]["splitc_bad_x0"]

    def test_generator_start_is_the_same_on_every_rank(self, runs):
        assert_same_on_every_rank([q["splitc_generator"] for q in runs])
        assert runs[0]["splitc_generator"]["iterations"] == 4
