"""``dryrun_multichip`` through the PyTorch port: the eight distributed legs
of ``__graft_entry__.dryrun_multichip(8)`` at 8 gloo ranks, with the same
sizes, seeds and options, against the same numpy oracles and bounds.

1. ELL partition, cyclic halo exchange, power method;
2. interleaved DIA partition (seam-lane halos), power method;
3. split-plane complex partition, power method;
4. segment-pruned GELL partition, power method;
5. distributed Arnoldi on the pruned operator;
6. distributed Krylov-Schur on a clustered spectrum;
7. distributed Lanczos on an interleaved symmetric band;
8. distributed block iteration on it.

The operators come from the JAX package's generators and numpy with the
entry point's seeds; the start vectors from ``torch.Generator`` seeds in
place of ``jax.random`` keys (and the same all-ones vector where the entry
point passes one). Every leg must report ``converged``; every leg's result
must be equal on all 8 ranks.
"""

import numpy as np
import pytest

from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_full, banded_random
from torch_ranks import dryrun_cases, run_ranks

N_DEVICES = 8


def coo_of(r, c, v, n):
    return (np.asarray(r), np.asarray(c), np.asarray(v), (n, n))


def operators(nd=N_DEVICES):
    """The legs' operators (numpy) and their oracles, as the entry point
    builds them."""
    ops, oracles = {}, {}
    # 1) ELL
    n = 32 * nd
    m = banded_random(n, bandwidth=2, nnz_per_row=3, dtype=np.float32, seed=1, diag_boost=4.0)
    ops["ell"] = coo_of(m.rows, m.indices, m.data, n)
    ev = np.linalg.eigvals(np.asarray(m.to_dense()))
    oracles["ell"] = ev[np.argmax(np.abs(ev))]
    # 2) interleaved DIA
    nd_ = 64 * nd
    d = banded_full(nd_, bandwidth=2, dtype=np.float32, seed=2, diag_boost=6.0)
    ops["il"] = (np.array(d.data), d.offsets)
    ev = np.linalg.eigvals(np.asarray(d.to_dense()))
    oracles["il"] = ev[np.argmax(np.abs(ev))]
    # 3) split-plane complex
    rng = np.random.default_rng(3)
    nc = 32 * nd
    offs = (-1, 0, 1)
    planes = np.zeros((2, 3, nc), np.float32)
    for k, off in enumerate(offs):
        planes[0, k] = rng.standard_normal(nc)
        planes[1, k] = rng.standard_normal(nc)
        if off > 0:
            planes[:, k, nc - off:] = 0
        elif off < 0:
            planes[:, k, :-off] = 0
    planes[0, 1] += 5.0
    ops["splitc"] = (planes, offs)
    dense = np.zeros((nc, nc), np.complex128)
    z = planes[0].astype(np.float64) + 1j * planes[1]
    for k, off in enumerate(offs):
        i = np.arange(max(0, -off), min(nc, nc - off))
        dense[i, i + off] = z[k, i]
    ev = np.linalg.eigvals(dense)
    oracles["splitc"] = ev[np.argmax(np.abs(ev))]
    # 4-5) pruned GELL with a planted diagonal spike
    ng = 128 * nd
    rng2 = np.random.default_rng(5)
    rg = rng2.integers(0, ng, 6 * ng)
    cg = rng2.integers(0, ng, 6 * ng)
    vg = (rng2.standard_normal(6 * ng) * 0.3).astype(np.float32)
    rg = np.concatenate([rg, np.arange(ng)])
    cg = np.concatenate([cg, np.arange(ng)])
    vg = np.concatenate([vg, np.full(ng, 3.0, np.float32)])
    vg[-1] = 25.0
    ops["pruned"] = coo_of(rg, cg, vg, ng)
    dense_g = np.zeros((ng, ng), np.float64)
    np.add.at(dense_g, (rg, cg), vg)
    ev = np.linalg.eigvals(dense_g)
    oracles["pruned"] = ev[np.argmax(np.abs(ev))]
    # 6) clustered Krylov-Schur operator
    rng6 = np.random.default_rng(6)
    nk = 40 * nd
    dk = np.concatenate([[5.0, 4.999], rng6.uniform(0.0, 4.0, nk - 2)])
    r6, c6, v6 = [], [], []
    for i in range(nk):
        r6.append(i)
        c6.append(i)
        v6.append(dk[i])
        if i + 1 < nk:
            r6.append(i)
            c6.append(i + 1)
            v6.append(0.005 * rng6.standard_normal())
    ops["ks"] = coo_of(r6, c6, np.array(v6, np.float32), nk)
    oracles["ks"] = np.sort(dk)[::-1][:2]
    # 7-8) symmetric tridiagonal with planted extremes
    rng7 = np.random.default_rng(7)
    nl = 64 * nd
    diag = rng7.uniform(0.5, 2.0, nl).astype(np.float32)
    diag[0], diag[1], diag[2] = 14.0, 10.0, 8.0
    off = np.full(nl, 0.1, np.float32)
    data = np.stack([off.copy(), diag, off.copy()])
    data[0, 0] = 0.0
    data[2, nl - 1:] = 0
    ops["lanczos"] = (data, (-1, 0, 1))
    sym = np.diag(diag.astype(np.float64)) + np.diag(off[:-1], 1) + np.diag(off[:-1], -1)
    oracles["lanczos"] = np.sort(np.linalg.eigvalsh(sym))[::-1][:3]
    return ops, oracles


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    ops, oracles = operators()
    return run_ranks(dryrun_cases, N_DEVICES, tmp_path_factory.mktemp("ranks"), ops), oracles


def dominant(values):
    values = np.asarray(values)
    return complex(values[np.argmax(np.abs(values))])


@pytest.mark.parametrize("leg", ["ell", "il", "splitc", "pruned"])
def test_power_legs_converge_to_the_oracle(legs, leg):
    runs, oracles = legs
    r = runs[0][leg]
    assert r["converged"], f"{leg} distributed power did not converge"
    lam = np.asarray(r["eigenvalue"])
    lam = complex(lam[0], lam[1]) if leg == "splitc" else complex(lam)
    assert abs(lam - oracles[leg]) < 1e-3 * abs(oracles[leg])
    for q in runs:
        assert np.array_equal(q[leg]["eigenvalue"], r["eigenvalue"])
        assert (q[leg]["iterations"], q[leg]["converged"]) == (r["iterations"], True)


def test_ell_leg_takes_the_halo_exchange(legs):
    assert all(q["halo_ok"] for q in legs[0])


def test_interleaved_eigenvector_decodes_on_every_rank(legs):
    runs, _ = legs
    for q in runs:
        assert q["il_vector"].shape == (64 * N_DEVICES,)
        np.testing.assert_array_equal(q["il_vector"], runs[0]["il_vector"])


def test_arnoldi_leg(legs):
    runs, oracles = legs
    r = runs[0]["arnoldi"]
    assert r["converged"]
    assert abs(dominant(r["eigenvalues"]) - oracles["pruned"]) < 1e-3 * abs(oracles["pruned"])


def test_krylov_schur_leg(legs):
    runs, oracles = legs
    r = runs[0]["krylov_schur"]
    assert r["converged"], "distributed Krylov-Schur did not converge"
    top = np.sort(r["eigenvalues"].real)[::-1]
    assert np.abs(top - oracles["ks"]).max() < 1e-3


def test_lanczos_leg(legs):
    runs, oracles = legs
    r = runs[0]["lanczos"]
    assert r["converged"], "distributed Lanczos did not converge"
    assert np.abs(np.sort(r["eigenvalues"].real)[::-1] - oracles["lanczos"]).max() < 1e-3


def test_subspace_leg(legs):
    runs, oracles = legs
    r = runs[0]["subspace"]
    assert r["converged"], "distributed subspace iteration did not converge"
    got = np.sort(np.abs(r["eigenvalues"]))[::-1]
    truth = oracles["lanczos"]
    assert np.abs(got - truth[:2]).max() < 1e-2 * truth[0]


@pytest.mark.parametrize("leg", ["arnoldi", "krylov_schur", "lanczos", "subspace"])
def test_solver_legs_equal_on_every_rank(legs, leg):
    runs, _ = legs
    for q in runs:
        np.testing.assert_array_equal(q[leg]["eigenvalues"], runs[0][leg]["eigenvalues"])
        assert (q[leg]["iterations"], q[leg]["converged"]) == (runs[0][leg]["iterations"],
                                                               runs[0][leg]["converged"])
