"""The port's distributed general-sparse operators against the JAX package,
on the CPU: the GELL partition and the segment-pruned partition, their
SpMVs and power methods, and the ELL halo guard (the cases of
tests/test_parallel_gell.py and tests/test_gell_pruned.py).

JAX runs on ``make_row_mesh(4)``; the port on 4 gloo ranks spawned once for
the module (``torch_ranks.gell_cases``) on the same numpy inputs. The packs
differ by design (the port packs CSR for B6, JAX its TPU layout), so each
rank's pack is compared with the JAX shard's pack through their COO
(``ops/gell_spmv.py::unpack_gell_leaves`` on the JAX leaves, the spill
tails' zero padding dropped): the same entries, exactly. The pruned plan
(the footprint, each distance's send and receive rows, the distances,
``max_fp``, ``has_remote``, the bytes a matvec sends) must equal JAX's.

Tolerances: float32 products within 2e-5 relative (1e-5 of max|y| for the
pruned SpMV, as the JAX tests); float32 eigenvalues within the JAX tests'
1e-4 (counts not compared: ROADMAP "f32 stopping below f32 eps").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.parallel.gell import (
    distributed_gell_matvec, distributed_gell_power_method, partition_gell)
from pcsc_eigenvalue_solver_project_tpu.parallel.gell_pruned import (
    distributed_gell_power_pruned, partition_gell_pruned, pruned_gell_matvec)
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.utils.prng import random_unit_vector
from pcsc_eigenvalue_solver_project_tpu_torch.ops.gell_spmv import unpack_gell_leaves
from torch_ranks import gell_cases, run_ranks

WORLD = 4
LANES = 128


def coo(m):
    return (np.asarray(m.rows), np.asarray(m.indices), np.asarray(m.data), tuple(m.shape))


def random_csr(rng, n, nnz, dtype=np.float32):
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz).astype(dtype)
    return J.SparseCSR.from_coo(r, c, v, (n, n))


def banded_plus_longrange(n, bw, n_far, rng, extra_segments=4):
    """Band of halfwidth bw plus n_far long-range entries a row confined to
    ``extra_segments`` fixed 128-column segments: a footprint that does not
    grow with n (tests/test_gell_pruned.py)."""
    r_b = np.repeat(np.arange(n), 2 * bw + 1)
    c_b = (r_b + np.tile(np.arange(-bw, bw + 1), n)).clip(0, n - 1)
    far = (rng.integers(0, extra_segments, n * n_far) * 128
           + rng.integers(0, 128, n * n_far)).clip(0, n - 1)
    r = np.concatenate([r_b, np.repeat(np.arange(n), n_far)])
    c = np.concatenate([c_b, far])
    v = rng.standard_normal(len(r)).astype(np.float32)
    _, uniq = np.unique(r.astype(np.int64) * n + c, return_index=True)
    return r[uniq], c[uniq], v[uniq]


def dense_of(r, c, v, n):
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (r, c), v)
    return a


@pytest.fixture(scope="module")
def jmesh():
    return make_row_mesh(WORLD)


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(0)
    out = {"rand1100": random_csr(rng, 1100, 20_000)}
    rng = np.random.default_rng(1)
    rr, cc = np.meshgrid(np.arange(128), 128 * np.arange(8), indexing="ij")
    out["spill1024"] = J.SparseCSR.from_coo(rr.ravel(), cc.ravel(),
                                            rng.standard_normal(rr.size).astype(np.float32),
                                            (1024, 1024))
    rng = np.random.default_rng(2)
    a = rng.standard_normal((512, 512)).astype(np.float32) * 0.05
    a[np.diag_indices(512)] += np.linspace(1.0, 4.0, 512, dtype=np.float32)
    out["dense512"] = J.SparseCSR.from_dense((a + a.T) / 2)
    rng = np.random.default_rng(3)
    r = np.arange(256)
    out["far256"] = J.SparseCSR.from_coo(r, (r + 128) % 256, rng.standard_normal(256),
                                         (256, 256))
    rng = np.random.default_rng(1)
    for n in (4096, 16384):
        r, c, v = banded_plus_longrange(n, 8, 2, rng)
        out[f"blr{n}"] = J.SparseCSR.from_coo(r, c, v, (n, n), dtype=np.float32)
    rng = np.random.default_rng(2)
    n, blk = 2048, 2048 // WORLD
    s_of = rng.integers(0, WORLD, 4000)
    out["blockdiag"] = J.SparseCSR.from_coo(
        s_of * blk + rng.integers(0, blk, 4000), s_of * blk + rng.integers(0, blk, 4000),
        rng.standard_normal(4000).astype(np.float32), (n, n), dtype=np.float32)
    rng = np.random.default_rng(3)
    r, c, v = banded_plus_longrange(2048, 4, 1, rng)
    r = np.concatenate([r, np.arange(2048)])
    c = np.concatenate([c, np.arange(2048)])
    v = np.concatenate([v, np.full(2048, 6.0, np.float32)])
    out["oracle2048"] = J.SparseCSR.from_coo(r, c, v, (2048, 2048), dtype=np.float32)
    out["cplx"] = J.SparseCSR.from_coo([0, 1], [1, 0], [1j, 2.0], (2, 2),
                                       dtype=np.complex128)
    return out


PRUNED = ("rand1100", "blr4096", "blr16384", "blockdiag", "oracle2048")


@pytest.fixture(scope="module")
def inputs(mats):
    rng = np.random.default_rng(7)
    xs = {f"x_{name}": rng.standard_normal(mats[name].shape[0]).astype(np.float32)
          for name in PRUNED}
    return {**{name: coo(m) for name, m in mats.items()}, **xs,
            "x1100": xs["x_rand1100"],
            "x1024": np.random.default_rng(1).standard_normal(1024).astype(np.float32),
            "x256": np.random.default_rng(3).standard_normal(256),
            "x0_512": np.array(random_unit_vector(jax.random.key(42), 512, np.float32))}


@pytest.fixture(scope="module")
def jpruned(jmesh, mats):
    """The JAX pruned partitions, built once (the TPU pack is slow to build)."""
    return {name: partition_gell_pruned(mats[name], jmesh, tile_rows=128)
            for name in ("rand1100", "blockdiag", "oracle2048")}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return run_ranks(gell_cases, WORLD, tmp_path_factory.mktemp("ranks"), inputs)


def gather(runs, pick):
    return np.concatenate([pick(r) for r in runs])


def canonical(rows, cols, vals):
    """COO without zero values (spill padding), sorted by (row, col, value)."""
    rows, cols, vals = map(np.asarray, (rows, cols, vals))
    keep = vals != 0
    rows, cols, vals = rows[keep].astype(np.int64), cols[keep].astype(np.int64), vals[keep]
    order = np.lexsort((vals, cols, rows))
    return rows[order], cols[order], vals[order]


def jax_shard_coo(seg, val, inv, sp, s, tile_rows):
    """Shard ``s``'s entries of a stacked JAX GELL pack, as COO."""
    tiles = seg.shape[0] // WORLD
    blk = slice(s * tiles, (s + 1) * tiles)
    return canonical(*unpack_gell_leaves(np.asarray(seg[blk]), np.asarray(val[blk]),
                                         np.asarray(inv[blk]), np.asarray(sp[0][s]),
                                         np.asarray(sp[1][s]), np.asarray(sp[2][s]),
                                         tile_rows, False))


def rel_max(y, ref):
    return np.max(np.abs(y - ref)) / np.max(np.abs(ref))


class TestPartitionedGELL:
    def test_rank_packs_hold_the_jax_shards_entries(self, runs, jmesh, mats):
        A = partition_gell(mats["rand1100"], jmesh, tile_rows=128)
        assert A.n_padded % (WORLD * 128) == 0
        for s, r in enumerate(runs):
            got = canonical(*r["gell"]["coo"])
            want = jax_shard_coo(A.seg_packed, A.val, A.inv,
                                 (A.sp_rows, A.sp_cols, A.sp_vals), s, A.tile_rows)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert r["gell"]["rps"] == A.rows_per_shard
            assert r["gell"]["n_padded"] == A.n_padded
            assert r["gell"]["shape"] == (A.rows_per_shard, A.n_padded)

    def test_default_tile_rows_is_jax_rule(self, runs, jmesh, mats):
        assert runs[0]["gell_auto_tile"] == partition_gell(mats["rand1100"], jmesh).tile_rows

    def test_matches_sequential(self, runs, jmesh, mats, inputs):
        m = mats["rand1100"]
        A = partition_gell(m, jmesh, tile_rows=128)
        x = inputs["x1100"]
        y = gather(runs, lambda r: r["gell"]["y"])
        xp = jax.device_put(jnp.asarray(np.pad(x, (0, A.n_padded - 1100))),
                            NamedSharding(jmesh, P("rows")))
        y_jax = np.asarray(jax.jit(lambda a, v: distributed_gell_matvec(a, v, jmesh))(A, xp))
        np.testing.assert_allclose(y[:1100], np.asarray(m.matvec(jnp.asarray(x))), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y, y_jax, rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(y[1100:], 0.0)

    def test_spill_heavy_pattern(self, runs, mats, inputs):
        # >128 unique entries in one lane bucket of shard 0's first tile: the
        # JAX pack spills them; the port's CSR holds them like any other
        y = gather(runs, lambda r: r["spill_y"])
        np.testing.assert_allclose(y, np.asarray(mats["spill1024"].matvec(
            jnp.asarray(inputs["x1024"]))), rtol=2e-5, atol=1e-5)

    def test_power_method_matches_jax(self, runs, jmesh, mats, inputs):
        m = mats["dense512"]
        opts = J.SolverOptions(tolerance=1e-6, max_iterations=2000)
        jr = distributed_gell_power_method(partition_gell(m, jmesh, tile_rows=128), jmesh, opts,
                                           x0=inputs["x0_512"])
        seq = J.power_method(m, opts, x0=inputs["x0_512"])
        r = runs[0]["gell_power"]
        assert r["converged"]
        for want in (jr.eigenvalue, seq.eigenvalue):
            np.testing.assert_allclose(float(np.real(r["eigenvalue"])), float(np.real(want)),
                                       rtol=1e-4)
        for q in runs:
            assert np.array_equal(q["gell_power"]["eigenvalue"], r["eigenvalue"])
            assert q["gell_power"]["iterations"] == r["iterations"]

    def test_non_square_rejected(self, runs):
        assert "square" in runs[0]["gell_non_square"]
        assert "square" in runs[0]["pruned_non_square"]

    def test_complex_rejected(self, runs):
        assert "split-complex partitions" in runs[0]["gell_complex"]
        assert "split-complex partitions" in runs[0]["pruned_complex"]


class TestHaloGuard:
    def test_halo_misuse_raises(self, runs, mats, inputs):
        # a far off-band entry: halo_ok is False; forcing the halo path must
        # fail loudly instead of returning clamped values
        assert not runs[0]["halo_ok"]
        assert "halo" in runs[0]["halo_misuse"]
        y = gather(runs, lambda r: r["halo_auto_y"])
        np.testing.assert_allclose(y, np.asarray(mats["far256"].matvec(
            jnp.asarray(inputs["x256"]))), rtol=1e-10)


def jax_footprints(A, segs_per_shard):
    """Each shard's footprint, rebuilt from JAX's plan: the segment a
    receive row gets is the sender's owner-local row plus its offset."""
    fps = [[None] * A.max_fp for _ in range(WORLD)]
    for d, (send, recv) in zip(A.distances, A.plan):
        send, recv = np.asarray(send), np.asarray(recv)
        for s in range(WORLD):
            src = (s - d) % WORLD
            for j, pos in enumerate(recv[s]):
                if pos < A.max_fp:
                    fps[s][pos] = src * segs_per_shard + int(send[src, j])
    return [tuple(g for g in fp if g is not None) for fp in fps]


class TestPrunedGELL:
    @pytest.mark.parametrize("name", ["rand1100", "blockdiag", "oracle2048"])
    def test_plan_and_packs_equal_jax(self, runs, jpruned, name):
        A = jpruned[name]
        sps = A.rows_per_shard // LANES
        fps = jax_footprints(A, sps)
        for s, r in enumerate(runs):
            got = r["pruned"][name]
            assert (got["max_fp"], got["distances"], got["has_remote"], got["comm"],
                    got["n_padded"]) == (A.max_fp, A.distances, A.has_remote,
                                         A.comm_bytes_per_matvec, A.n_padded)
            assert got["footprint"] == fps[s]
            assert len(got["plan"]) == len(A.plan)
            for (send, recv), (js, jr) in zip(got["plan"], A.plan):
                np.testing.assert_array_equal(send, np.asarray(js)[s])
                np.testing.assert_array_equal(recv, np.asarray(jr)[s])
            own = jax_shard_coo(A.own_seg, A.own_val, A.own_inv, A.own_sp, s, A.tile_rows)
            for g, w in zip(canonical(*got["own"]), own):
                np.testing.assert_array_equal(g, w)
            if A.has_remote:
                rem = jax_shard_coo(A.rem_seg, A.rem_val, A.rem_inv, A.rem_sp, s, A.tile_rows)
                for g, w in zip(canonical(*got["rem"]), rem):
                    np.testing.assert_array_equal(g, w)
                assert got["rem_shape"] == (A.rows_per_shard, (A.max_fp + 1) * LANES)
            else:
                assert got["rem"] is None

    @pytest.mark.parametrize("name", ["rand1100", "oracle2048"])
    def test_matvec_matches_jax_and_sequential(self, runs, jmesh, jpruned, mats, inputs, name):
        m = mats[name]
        n = m.shape[0]
        A = jpruned[name]
        x = inputs[f"x_{name}"]
        xs = jax.device_put(jnp.asarray(np.pad(x, (0, A.n_padded - n))),
                            NamedSharding(jmesh, P("rows")))
        y_jax = np.asarray(jax.jit(lambda a, v: pruned_gell_matvec(a, v, jmesh))(A, xs))[:n]
        y = gather(runs, lambda r: r["pruned"][name]["y"])[:n]
        ref = dense_of(*coo(m)[:3], n) @ x.astype(np.float64)
        assert rel_max(y, ref) < 1e-5
        assert rel_max(y, y_jax) < 1e-5

    def test_comm_scales_with_footprint_not_n(self, runs, mats, inputs):
        comm = []
        for n in (4096, 16384):
            got = runs[0]["pruned"][f"blr{n}"]
            comm.append(got["comm"])
            y = gather(runs, lambda r: r["pruned"][f"blr{n}"]["y"])[:n]
            ref = dense_of(*coo(mats[f"blr{n}"])[:3], n) @ inputs[f"x_blr{n}"].astype(
                np.float64)
            assert rel_max(y, ref) < 1e-5
            for q in runs:
                assert q["pruned"][f"blr{n}"]["comm"] == got["comm"]
        # the footprint (band halo plus at most 4 far segments) does not grow
        # with n, where all-gather's (S-1)/S n 4 bytes does
        assert comm[0] <= (WORLD - 1) * 4096 // WORLD * 4
        assert comm[1] <= comm[0] + 2 * 128 * 4
        assert comm[1] < (WORLD - 1) * 16384 // WORLD * 4 // 3

    def test_block_diagonal_no_comm(self, runs, mats, inputs):
        got = runs[0]["pruned"]["blockdiag"]
        assert got["comm"] == 0 and not got["has_remote"] and got["distances"] == ()
        y = gather(runs, lambda r: r["pruned"]["blockdiag"]["y"])
        ref = dense_of(*coo(mats["blockdiag"])[:3], 2048) @ inputs["x_blockdiag"].astype(
            np.float64)
        assert rel_max(y, ref) < 1e-5

    def test_power_matches_oracle_and_jax(self, runs, jmesh, jpruned, mats):
        m = mats["oracle2048"]
        jr = distributed_gell_power_pruned(
            jpruned["oracle2048"], jmesh, J.SolverOptions(max_iterations=2000, tolerance=1e-10),
            x0=np.ones(2048, np.float32))
        r = runs[0]["pruned_power"]
        assert r["converged"] and bool(jr.converged)
        ev = np.linalg.eigvals(dense_of(*coo(m)[:3], 2048))
        dom = ev[np.argmax(np.abs(ev))]
        assert abs(complex(r["eigenvalue"]) - dom) / abs(dom) < 1e-4
        assert abs(complex(r["eigenvalue"]) - complex(jr.eigenvalue)) / abs(dom) < 1e-4
        for q in runs:
            assert np.array_equal(q["pruned_power"]["eigenvalue"], r["eigenvalue"])
