"""Checkpoint and resume, and distributed Arnoldi, of the port against the
JAX package on the CPU (the cases of tests/test_checkpoint_and_dist_arnoldi.py).

``power_method_checkpointed`` runs in this process; the distributed cases
run on 4 gloo ranks spawned once for the module
(``torch_ranks.checkpoint_cases``), with JAX on ``make_row_mesh(4)``.

A checkpointed run, uninterrupted or stopped after a chunk and resumed,
must equal the plain run bit for bit: the same iterate, eigenvalue and
iteration count (the checkpoint is the loop carry). Against JAX, on the
same start vectors: float64 eigenvalues within 1e-10 relative with equal
counts, float32 within 1e-5; Arnoldi's Ritz values within the JAX test's
1e-8 relative, with equal QR sweep counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.models.generators import (
    banded_full, banded_random, laplacian_1d)
from pcsc_eigenvalue_solver_project_tpu.parallel import dia as jd
from pcsc_eigenvalue_solver_project_tpu.parallel.arnoldi import distributed_arnoldi_eigenvalues
from pcsc_eigenvalue_solver_project_tpu.parallel.gell_pruned import partition_gell_pruned
from pcsc_eigenvalue_solver_project_tpu.parallel.mesh import make_row_mesh
from pcsc_eigenvalue_solver_project_tpu.parallel.sharded import partition_ell
from pcsc_eigenvalue_solver_project_tpu.utils.prng import random_unit_vector
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.utils import checkpoint as ck
from torch_ranks import checkpoint_cases, run_ranks

WORLD = 4
ARNOLDI_KM = {"B96": (4, 30), "B120": (2, 50), "B50": (2, 50)}


def coo(m):
    return (np.asarray(m.rows), np.asarray(m.indices), np.asarray(m.data), tuple(m.shape))


def port_csr(m):
    return T.SparseCSR.from_coo(*coo(m)[:3], m.shape, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return make_row_mesh(WORLD)


@pytest.fixture(scope="module")
def mats():
    band = banded_full(96, bandwidth=3, dtype=np.float64, seed=4, diag_boost=2.0)
    return {"band6000": banded_full(6000, bandwidth=5, dtype=np.float32, seed=6),
            "B96": banded_random(96, bandwidth=3, nnz_per_row=4, seed=11),
            "B120": banded_random(120, bandwidth=2, nnz_per_row=3, seed=13),
            "B50": banded_random(50, bandwidth=2, nnz_per_row=3, seed=17, diag_boost=3.0),
            "band96": band, "band96_csr": J.SparseCSR.from_dense(np.asarray(band.to_dense()))}


@pytest.fixture(scope="module")
def inputs(mats, tmp_path_factory):
    key = jax.random.key(42)
    return {
        "band6000": (np.array(mats["band6000"].data), mats["band6000"].offsets),
        "band96": (np.array(mats["band96"].data), mats["band96"].offsets),
        **{name: coo(mats[name]) for name in ("B96", "B120", "B50", "band96_csr")},
        "x0_6000": np.array(random_unit_vector(jax.random.key(2), 6000, np.float32)),
        "x0_B96": np.array(jax.random.uniform(key, (96,), jnp.float64, minval=-1, maxval=1)),
        "x0_B120": np.array(random_unit_vector(key, 120, np.float64)),
        "x0_B50": np.array(random_unit_vector(key, 50, np.float64)),
        "x0_band96": np.array(random_unit_vector(jax.random.key(3), 96, np.float64)),
        "arnoldi_km": ARNOLDI_KM, "dir": str(tmp_path_factory.mktemp("checkpoints")),
    }


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    return run_ranks(checkpoint_cases, WORLD, tmp_path_factory.mktemp("ranks"), inputs)


def assert_bitwise(a, b):
    """Two EigenResults (or their host dicts) equal bit for bit."""
    get = (lambda r, f: np.asarray(r[f])) if isinstance(a, dict) else \
        (lambda r, f: getattr(r, f).numpy())
    for field in ("eigenvalue", "eigenvector", "iterations", "converged"):
        assert np.array_equal(get(a, field), get(b, field)), field


X64 = np.random.default_rng(7).uniform(-1, 1, 64)


class TestCheckpointedPower:
    def test_matches_uninterrupted(self, tmp_path):
        m = port_csr(laplacian_1d(64))
        opts = T.SolverOptions(tolerance=1e-10, max_iterations=5000)
        ref = T.power_method(m, opts, x0=X64)
        res = ck.power_method_checkpointed(m, opts, checkpoint_dir=str(tmp_path), chunk=100,
                                           x0=X64)
        assert_bitwise(res, ref)
        jr = J.power_method(laplacian_1d(64), J.SolverOptions(tolerance=1e-10,
                                                              max_iterations=5000), x0=X64)
        np.testing.assert_allclose(complex(res.eigenvalue), complex(jr.eigenvalue), rtol=1e-10)
        assert int(res.iterations) == int(jr.iterations)

    def test_resume_after_interruption(self, tmp_path):
        m = port_csr(laplacian_1d(64))
        ref = T.power_method(m, T.SolverOptions(tolerance=1e-10, max_iterations=5000), x0=X64)
        # phase 1: a budget-capped run leaves a checkpoint behind
        part = ck.power_method_checkpointed(
            m, T.SolverOptions(tolerance=1e-10, max_iterations=300),
            checkpoint_dir=str(tmp_path), chunk=100, x0=X64)
        assert not bool(part.converged) and int(part.iterations) == 300
        state = ck.restore_state(str(tmp_path / "power_state.pt"))
        assert state is not None and int(state[0]) == 300
        # phase 2: the full budget resumes from iteration 300
        res = ck.power_method_checkpointed(
            m, T.SolverOptions(tolerance=1e-10, max_iterations=5000),
            checkpoint_dir=str(tmp_path), chunk=100, x0=X64)
        assert bool(res.converged)
        assert_bitwise(res, ref)

    @pytest.mark.parametrize("chunk", [7, 64, 5000])
    def test_chunk_size_changes_nothing(self, tmp_path, chunk):
        m = port_csr(laplacian_1d(48))
        opts = T.SolverOptions(tolerance=1e-10, max_iterations=3000)
        res = ck.power_method_checkpointed(m, opts, checkpoint_dir=str(tmp_path), chunk=chunk,
                                           x0=X64[:48])
        assert_bitwise(res, T.power_method(m, opts, x0=X64[:48]))

    def test_interleaved_operator(self, tmp_path):
        dia = T.SparseDIA.from_csr(port_csr(laplacian_1d(300))).interleaved(8)
        opts = T.SolverOptions(tolerance=1e-9, max_iterations=400)
        x0 = np.random.default_rng(1).uniform(-1, 1, 300)
        res = ck.power_method_checkpointed(dia, opts, checkpoint_dir=str(tmp_path), chunk=50,
                                           x0=x0)
        assert res.eigenvector.shape == (300,)
        assert_bitwise(res, T.power_method(dia, opts, x0=x0))

    def test_non_square_raises(self, tmp_path):
        m = T.SparseCSR.from_coo([0], [1], [1.0], (2, 3), device="cpu")
        with pytest.raises(ValueError, match="square"):
            ck.power_method_checkpointed(m, checkpoint_dir=str(tmp_path))


class TestSaveRestore:
    def test_round_trip(self, tmp_path):
        state = (torch.tensor(3, dtype=torch.int32), torch.tensor(True),
                 torch.arange(5.0), {"world_size": 4, "carry": [torch.zeros(2, 2)]})
        path = str(tmp_path / "a" / "state.pt")
        ck.save_state(path, state)
        back = ck.restore_state(path)
        assert int(back[0]) == 3 and bool(back[1])
        assert torch.equal(back[2], state[2]) and back[3]["world_size"] == 4
        assert torch.equal(back[3]["carry"][0], torch.zeros(2, 2))

    def test_missing_is_none(self, tmp_path):
        assert ck.restore_state(str(tmp_path / "nothing.pt")) is None

    def test_interrupted_save_keeps_the_old_checkpoint(self, tmp_path, monkeypatch):
        path = str(tmp_path / "state.pt")
        ck.save_state(path, (torch.ones(3),))

        def torn(obj, f):
            f.write(b"partial")
            raise KeyboardInterrupt

        monkeypatch.setattr(torch, "save", torn)
        with pytest.raises(KeyboardInterrupt):
            ck.save_state(path, (torch.zeros(3),))
        monkeypatch.undo()
        assert torch.equal(ck.restore_state(path)[0], torch.ones(3))
        assert sorted(os.listdir(tmp_path)) == ["state.pt"]


class TestDistributedCheckpointedPower:
    def test_uninterrupted_equals_the_plain_distributed_run(self, runs):
        for r in runs:
            assert_bitwise(r["uninterrupted"], r["reference"])

    def test_resumed_equals_the_uninterrupted_run(self, runs):
        for r in runs:
            assert r["stopped"]["iterations"] == 60 and not r["stopped"]["converged"]
            assert_bitwise(r["resumed"], r["uninterrupted"])
        assert runs[0]["saved"]

    def test_matches_jax(self, runs, jmesh, mats, inputs):
        A = jd.partition_dia_il(mats["band6000"], jmesh)
        opts = J.SolverOptions(max_iterations=500, tolerance=1e-7)
        jr = jd.distributed_dia_il_power_method(A, jmesh, opts, x0=inputs["x0_6000"])
        r = runs[0]["resumed"]
        assert r["converged"] and bool(jr.converged)
        np.testing.assert_allclose(float(r["eigenvalue"]), float(jr.eigenvalue), rtol=1e-5)
        v = jd.decode_vec_il_sharded(jr.eigenvector, A)
        assert abs(abs(np.vdot(runs[0]["decoded"], v)) - 1.0) < 1e-4

    def test_restore_at_another_world_size_raises(self, runs):
        for r in runs[:2]:
            assert "saved at world size 4, this run has 2" in r["other_world"]


class TestDistributedArnoldi:
    def test_matches_single_chip(self, runs, jmesh, mats, inputs):
        m = mats["B96"]
        x0 = inputs["x0_B96"]
        seq = T.arnoldi_eigenvalues(port_csr(m), k=4, m=30, x0=x0)
        jr = distributed_arnoldi_eigenvalues(partition_ell(m, jmesh), jmesh, k=4, m=30, x0=x0)
        got = np.sort_complex(runs[0]["arnoldi"]["B96"]["eigenvalues"])
        np.testing.assert_allclose(got, np.sort_complex(seq.eigenvalues.numpy()), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(got, np.sort_complex(np.asarray(jr.eigenvalues)), rtol=1e-8,
                                   atol=1e-10)
        assert runs[0]["arnoldi"]["B96"]["iterations"] == int(jr.iterations)
        for q in runs:
            np.testing.assert_array_equal(q["arnoldi"]["B96"]["eigenvalues"],
                                          runs[0]["arnoldi"]["B96"]["eigenvalues"])

    @pytest.mark.parametrize("name", ["B120", "B50"])
    def test_against_dense_oracle(self, runs, jmesh, mats, inputs, name):
        # B50: 50 rows over 4 ranks, the padded rows must not pollute the Ritz values
        k, m_ = ARNOLDI_KM[name]
        exact = np.linalg.eigvals(np.asarray(mats[name].to_dense()))
        exact = exact[np.argsort(-np.abs(exact))]
        got = runs[0]["arnoldi"][name]["eigenvalues"]
        for e in exact[:k]:
            assert min(abs(got - e)) < 1e-6
        jr = distributed_arnoldi_eigenvalues(partition_ell(mats[name], jmesh), jmesh, k=k, m=m_,
                                             x0=inputs[f"x0_{name}"])
        np.testing.assert_allclose(np.sort_complex(got),
                                   np.sort_complex(np.asarray(jr.eigenvalues)), rtol=1e-8)

    @pytest.mark.parametrize("kind", ["dia", "il", "pruned"])
    def test_other_partitions(self, runs, jmesh, mats, inputs, kind):
        x0 = inputs["x0_band96"]
        if kind == "pruned":
            A = partition_gell_pruned(mats["band96_csr"], jmesh, tile_rows=128)
        else:  # JAX's distributed Arnoldi takes no interleaved partition
            A = jd.partition_dia(mats["band96"], jmesh)
        jr = distributed_arnoldi_eigenvalues(A, jmesh, k=3, m=20, x0=x0)
        got = runs[0]["arnoldi"][kind]["eigenvalues"]
        np.testing.assert_allclose(np.sort_complex(got),
                                   np.sort_complex(np.asarray(jr.eigenvalues)), rtol=1e-8)

    def test_argument_errors(self, runs):
        k0, big_k = runs[0]["arnoldi_errors"]
        assert "k must be >= 1" in k0
        assert "k (30) must be <= m (20)" in big_k
