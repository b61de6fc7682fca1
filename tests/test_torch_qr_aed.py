"""Aggressive early deflation (``ops/qr_aed.py``) against the JAX package, on
the CPU.

The cases of ``tests/test_qr_aed.py`` at its sizes (n <= 220, w = 64,
``sweeps_per_round = 8``). The JAX side runs its Pallas kernels in interpret
mode, once per module (module-scoped fixtures); the port runs the plain
versions of B7, B8 and B13 on CPU tensors, in complex64 (the Pallas kernels
compute in float32 planes). Both start from the same numpy matrices; where a
Hessenberg form is the input, from the JAX package's own reduction.

Tolerances, those of the JAX tests:
- one round is a similarity: the Hessenberg mask exact (no entry below the
  subdiagonal), the spectrum within 5e-5 under nearest-neighbour matching,
  the schedule non-empty; the deflation count is printed beside JAX's;
- the full-rank uniform-[1, 2] spectrum within 1e-4, imaginary parts within
  1e-4, and fewer sweeps than n (the sweep cut);
- the complex spectrum and the pre-reduced entry within 5e-4 of numpy and of
  JAX, matched by nearest neighbour (not ``sort_complex``);
- the Schur invariant: ``||Q T Q^H - H||`` within 5e-4, ``||Q^H Q - I||``
  and ``tril(T, -1)`` within 1e-4; in complex128 one round keeps
  ``q h q^H`` to 1e-12;
- the ``schur_driver`` and ``AED_MIN_N`` / ``SCHUR_AED_MIN_N`` dispatch by
  monkeypatching, as the JAX test pins its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu.ops.pallas.hessenberg_blocked import (
    hessenberg_blocked_planes)
from pcsc_eigenvalue_solver_project_tpu.ops.pallas.qr_aed import (
    _aed_round, qr_eig_blocked_aed_planes, qr_eig_blocked_aed_schur_planes,
    qr_eigenvalues_pallas_blocked_aed)
from pcsc_eigenvalue_solver_project_tpu.ops.pallas.qr_eig_blocked import pad_for_blocked
from pcsc_eigenvalue_solver_project_tpu_torch import DenseMatrix, QROptions
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_aed
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as qe

TOL = 3e-6
W, S = 64, 8


def nn_err(ea, eb):
    """Nearest-neighbour spectrum distance, both ways, relative to
    max(1, max|ea|) (the JAX test's ``_nn_eig_err``)."""
    d = np.abs(np.asarray(ea)[:, None] - np.asarray(eb)[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max()) / max(1.0, np.abs(ea).max())


def planted(n, seed):
    """The full-rank uniform-[1, 2] symmetric operator and its spectrum."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.uniform(1.0, 2.0, n))[::-1]
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Qo * d) @ Qo.T).astype(np.float32), d


def jax_hessenberg(a):
    """JAX's Hessenberg form of a real float32 matrix: (2, n, n) planes and
    the same as a complex64 tensor."""
    n = a.shape[0]
    h = hessenberg_blocked_planes(jnp.asarray(a[None]), n, interpret=True)
    h = jnp.concatenate([h, jnp.zeros_like(h)])
    hn = np.asarray(h)
    return h, torch.from_numpy((hn[0] + 1j * hn[1]).astype(np.complex64))


def eig_of(e):
    return np.asarray(e).astype(np.complex128)


@pytest.fixture(scope="module")
def one_round():
    n = 200
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    h, ht = jax_hessenberg(a)
    p, _ = pad_for_blocked(h)
    p2, d, hi_w, _shifts, ns = _aed_round(p, jnp.asarray(n, jnp.int32),
                                          jnp.asarray(TOL, jnp.float32), w=W, interpret=True)
    Hj = (np.asarray(p2[0]) + 1j * np.asarray(p2[1]))[:n, :n]
    return ht, Hj, int(d), int(hi_w), int(ns)


@pytest.fixture(scope="module")
def full_rank():
    n = 220
    a, d = planted(n, 0)
    return a, d, qr_eigenvalues_pallas_blocked_aed(a, 40 * n, TOL, w=W, sweeps_per_round=S,
                                                   interpret=True)


@pytest.fixture(scope="module")
def complex_case():
    n = 150
    rng = np.random.default_rng(3)
    a = ((rng.standard_normal((n, n))
          + 1j * rng.standard_normal((n, n))) / np.sqrt(n)).astype(np.complex64)
    return a, qr_eigenvalues_pallas_blocked_aed(a, 40 * n, TOL, w=W, sweeps_per_round=S,
                                                interpret=True)


@pytest.fixture(scope="module")
def pre_reduced():
    n = 180
    rng = np.random.default_rng(7)
    d = np.concatenate([np.full(30, 2.0) + 1e-3 * rng.standard_normal(30),
                        rng.uniform(0.5, 1.5, n - 30)])
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((Qo * d) @ Qo.T).astype(np.float32)
    h, ht = jax_hessenberg(a)
    eig, sweeps, hi = qr_eig_blocked_aed_planes(h, n, 40 * n, TOL, w=W, sweeps_per_round=S,
                                                interpret=True)
    e = np.asarray(eig)
    return ht, d, (e[0] + 1j * e[1])[:n], int(sweeps), int(hi)


@pytest.fixture(scope="module")
def schur_case():
    n = 180
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    h, ht = jax_hessenberg(a)
    eig, sweeps, hi, _t, _q = qr_eig_blocked_aed_schur_planes(h, n, 40 * n, TOL, w=W,
                                                              sweeps_per_round=S,
                                                              interpret=True)
    e = np.asarray(eig)
    return a, ht, (e[0] + 1j * e[1])[:n], int(sweeps), int(hi)


def test_round_preserves_spectrum_and_hessenberg(one_round):
    ht, Hj, d_j, hi_w_j, ns_j = one_round
    n = ht.shape[0]
    assert np.abs(np.tril(ht.numpy(), -2)).max() == 0.0  # the input is exactly Hessenberg
    h2, d, hi_w, shifts = qr_aed.aed_round(ht, n, TOL, W)
    Hc = h2.numpy()
    print(f"deflated: port {d}, JAX {d_j}; window hi: port {int(hi_w)}, JAX {hi_w_j}; "
          f"shifts: port {shifts.shape[0]}, JAX {ns_j}")
    assert h2.dtype == torch.complex64 and h2.shape == (n, n)
    assert np.abs(np.tril(Hc, -2)).max() == 0.0  # exact Hessenberg mask
    before = np.linalg.eigvals(ht.numpy().astype(np.complex128))
    after = np.linalg.eigvals(Hc.astype(np.complex128))
    assert nn_err(before, after) < 5e-5
    assert nn_err(np.linalg.eigvals(Hj.astype(np.complex128)), after) < 5e-5
    assert shifts.shape[0] >= 1 and shifts.shape[0] == min(W - d, qr_aed.MAX_SHIFTS)
    assert 0 <= d < W


def test_full_rank_spectrum_and_sweep_cut(full_rank):
    a, d, (ej, sweeps_j, conv_j) = full_rank
    n = a.shape[0]
    e, sweeps, conv = qr_aed.qr_eigenvalues_blocked_aed(torch.from_numpy(a), 40 * n, TOL, w=W,
                                                        sweeps_per_round=S)
    print(f"sweeps: port {sweeps}, JAX {sweeps_j}; rounds {qr_aed.last_run}")
    e = e.numpy()
    assert conv and conv_j
    assert np.abs(np.sort(e.real) - np.sort(d)).max() < 1e-4
    assert np.abs(e.imag).max() < 1e-4
    assert nn_err(ej, e) < 1e-4
    assert sweeps < n  # the sweep cut: plain single-shift sweeps need ~2n
    assert qr_aed.last_run["rounds"] > 0 and qr_aed.last_run["deflated"] > 0


def test_complex_spectrum(complex_case):
    a, (ej, sweeps_j, conv_j) = complex_case
    n = a.shape[0]
    e, sweeps, conv = qr_aed.qr_eigenvalues_blocked_aed(torch.from_numpy(a), 40 * n, TOL, w=W,
                                                        sweeps_per_round=S)
    print(f"sweeps: port {sweeps}, JAX {sweeps_j}")
    assert conv and conv_j
    assert e.dtype == torch.complex64
    assert nn_err(np.linalg.eigvals(a.astype(np.complex128)), e.numpy()) < 5e-4
    assert nn_err(eig_of(ej), e.numpy()) < 5e-4


def test_pre_reduced_entry(pre_reduced):
    ht, d, ej, sweeps_j, hi_j = pre_reduced
    n = ht.shape[0]
    e, sweeps, hi = qr_aed.qr_eig_blocked_aed(ht, 40 * n, TOL, w=W, sweeps_per_round=S)
    print(f"sweeps: port {sweeps}, JAX {sweeps_j}")
    assert hi <= 1 and hi_j <= 1
    assert np.abs(np.sort(e.numpy().real) - np.sort(d)).max() < 5e-4
    assert nn_err(ej, e.numpy()) < 5e-4


def test_schur_mode_invariant(schur_case):
    a, ht, ej, sweeps_j, hi_j = schur_case
    n = ht.shape[0]
    e, sweeps, hi, T, Q = qr_aed.qr_eig_blocked_aed_schur(ht, 40 * n, TOL, w=W,
                                                          sweeps_per_round=S)
    print(f"sweeps: port {sweeps}, JAX {sweeps_j}")
    assert hi <= 1 and hi_j <= 1
    T, Q, H = T.numpy(), Q.numpy(), ht.numpy()
    assert np.abs(Q @ T @ Q.conj().T - H).max() < 5e-4
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() < 1e-4
    assert np.abs(np.tril(T, -1)).max() < 1e-4
    np.testing.assert_array_equal(e.numpy(), np.diagonal(T))
    assert nn_err(np.linalg.eigvals(a.astype(np.complex128)), e.numpy()) < 5e-4
    assert nn_err(ej, e.numpy()) < 5e-4


def test_schur_round_is_an_exact_similarity():
    # complex128, one round with Q: q h q^H = q' h' q'^H to rounding
    n, w = 100, 32
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = tq.hessenberg_plain(torch.from_numpy(a))
    h = torch.triu(h, -1)
    q0 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, n)) + 0j))[0]
    h2, q2, d, hi_w, shifts = qr_aed.aed_round(h, n, 1e-10, w, q0)
    lhs, rhs = q0 @ h @ q0.conj().T, q2 @ h2 @ q2.conj().T
    assert float((lhs - rhs).abs().max()) <= 1e-12 * float(h.abs().max()) * n
    assert float((q2.conj().T @ q2 - torch.eye(n)).abs().max()) < 1e-12
    assert float(torch.tril(h2, -2).abs().max()) == 0.0
    assert shifts.dtype == torch.complex128 and shifts.shape[0] == w - d


def test_round_needs_a_spike_column():
    h = torch.zeros((70, 70), dtype=torch.complex64)
    for hi in (65, 71):
        with pytest.raises(ValueError, match="aed_round: hi"):
            qr_aed.aed_round(h, hi, TOL, 64)


def test_window_solve_takes_the_blocked_route_beyond_the_boundary(monkeypatch):
    # w beyond UNBLOCKED_MAX_N: the window's Schur form comes from B13 in
    # Schur mode (blocked_sweeps), as an n = w solve does; the round is the
    # same similarity
    n = 90
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((n, n)) / np.sqrt(n)).to(torch.complex128)
    h = torch.triu(tq.hessenberg_plain(a), -1)
    calls = []
    real = qr_aed.blocked_sweeps

    def recorder(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(qr_aed, "blocked_sweeps", recorder)
    monkeypatch.setattr(qe, "UNBLOCKED_MAX_N", 16)
    h2, d, hi_w, shifts = qr_aed.aed_round(h, n, 1e-10, 32)
    assert calls == [32]
    before = np.linalg.eigvals(h.numpy())
    assert nn_err(before, np.linalg.eigvals(h2.numpy())) < 1e-10


def driver_of(sweeps):
    """The driver that ``blocked_eigenvalues`` handed to the accelerated
    solve: "aed", "mono" (B13 alone), "B8" (the default) or the callable
    itself."""
    if sweeps is None:
        return "B8"
    if sweeps in (qr_aed.qr_eig_blocked_aed, qr_aed.qr_eig_blocked_aed_schur):
        return "aed"
    if getattr(sweeps, "func", sweeps) is qb.blocked_sweeps:
        return "mono"
    return sweeps


class TestDispatch:
    def test_constants_follow_the_rules(self):
        # set from chip_smoke.py --aed-table (PERF.md): AED_MIN_N one of the
        # measured sizes or None, SCHUR_AED_MIN_N likewise
        assert qb.AED_MIN_N in (None, 1024, 2048, 4096)
        assert qb.SCHUR_AED_MIN_N in (None, 2048, 4096)
        assert qb.SCHUR_DRIVERS == ("auto", "monolithic", "aed")

    @pytest.fixture
    def recorded(self, monkeypatch):
        calls = []

        def fake(a, max_sweeps, tol, sweeps=None):
            calls.append(driver_of(sweeps))
            raise RuntimeError("probe")

        monkeypatch.setattr(tq, "accelerated_eigenvalues", fake)
        monkeypatch.setattr(tq, "accelerated_eigenpairs", fake)
        return calls

    def run(self, n, **kw):
        with pytest.raises(RuntimeError, match="probe"):
            qb.blocked_eigenvalues(torch.zeros((n, n), dtype=torch.complex64), 10, 1e-5, **kw)

    @pytest.mark.parametrize("vectors", [False, True])
    def test_auto_switches_at_its_constant(self, recorded, monkeypatch, vectors):
        monkeypatch.setattr(qb, "AED_MIN_N", 12)
        monkeypatch.setattr(qb, "SCHUR_AED_MIN_N", 20)
        edge = 20 if vectors else 12
        for n, want in ((edge - 1, "mono"), (edge, "aed")):
            recorded.clear()
            self.run(n, compute_vectors=vectors)
            assert recorded == [want]
        # explicit drivers win at any size
        for driver, n in (("aed", edge - 1), ("monolithic", edge)):
            recorded.clear()
            self.run(n, compute_vectors=vectors, schur_driver=driver)
            assert recorded == [driver[:4]]

    def test_none_means_never_by_auto(self, recorded, monkeypatch):
        monkeypatch.setattr(qb, "AED_MIN_N", None)
        monkeypatch.setattr(qb, "SCHUR_AED_MIN_N", None)
        for vectors in (False, True):
            recorded.clear()
            self.run(64, compute_vectors=vectors)
            assert recorded == ["mono"]

    @pytest.mark.parametrize("vectors", [False, True])
    def test_unknown_driver_raises(self, recorded, vectors):
        with pytest.raises(ValueError, match="unknown schur_driver 'bogus'"):
            qb.blocked_eigenvalues(torch.zeros((8, 8)), 10, 1e-5, compute_vectors=vectors,
                                   schur_driver="bogus")
        assert recorded == []

    def test_qr_eigenvalues_beyond_the_boundary_takes_the_driver(self, monkeypatch):
        # on a non-CPU tensor beyond UNBLOCKED_MAX_N qr_eigenvalues hands the
        # solve to blocked_eigenvalues, whose "auto" picks AED from AED_MIN_N
        monkeypatch.setattr(qe, "UNBLOCKED_MAX_N", 4)
        monkeypatch.setattr(qb, "AED_MIN_N", 6)
        monkeypatch.setattr(qb, "SCHUR_AED_MIN_N", 6)
        calls = []

        def recorder(vectors):
            def solve(a, max_sweeps, tol, sweeps=None):
                calls.append((a.shape[0], driver_of(sweeps)))
                eig = torch.zeros(a.shape[0], dtype=torch.complex64, device=a.device)
                return (eig, 1, True) + ((torch.diag(eig),) if vectors else ())
            return solve

        monkeypatch.setattr(tq, "accelerated_eigenvalues", recorder(False))
        monkeypatch.setattr(tq, "accelerated_eigenpairs", recorder(True))
        for n in (4, 5, 6):
            qe.qr_eigenvalues(DenseMatrix(torch.empty((n, n), device="meta")),
                              QROptions(mode="accelerated"))
        assert calls == [(4, "B8"), (5, "mono"), (6, "aed")]
