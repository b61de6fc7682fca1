"""B13's plain version (blocked shifted Givens sweeps) against the JAX package
and against B8's plain version.

The same numpy matrices go through the Pallas kernel of
``ops/pallas/qr_eig_blocked.py`` in interpret mode (as tests/test_qr_blocked.py
runs it) and through the port's ``ops/qr_eig_blocked.py``, which on a CPU
tensor runs the plain version. The Pallas kernel computes in float32 planes.

Tolerances:
- Eigenvalues against the Pallas kernel: 5e-4 under nearest-neighbour
  matching, relative to max(1, max|lambda|), the JAX test's own bound
  (tests/test_qr_blocked.py:76; measured up to 2.8e-6). The sweep counts
  agree within one: the kernels decide deflation on float32 values summed in
  another order (equal in every case here).
- Against B8's plain version ``qr_eig_plain``, in complex128 at block sizes
  1, 3, 7 and 16: the same sweep count and eigenvalues to 1e-12 absolute
  (|lambda| up to ~8; blocking only reorders the sums, measured up to 2e-13).
- The shift schedule against ``qr_eig_blocked_step`` after 4 sweeps with
  deflation off: H entry by entry to 1e-6 * n of max|H| (one unit of float32
  rounding per row, the unit of tests/test_torch_qr_kernels.py; measured
  0.011 units), the port in complex128.
- An empty schedule (JAX ``n_shifts = 0``) against ``qr_eig_blocked_step``
  and ``qr_eig_blocked_step_q``: Wilkinson sweeps, the same sweep count and
  hi, H as for the schedule after 4 sweeps at tol 0 and eigenvalues as above
  at convergence; ``||H - Q T Q^H||`` to one unit.
- Schur mode: eigenvalues as above; ``||H - Q T Q^H||`` and ``||Q^H Q - I||``
  to 1e-6 * n (one unit; measured 0.03-0.04); T upper triangular below the
  deflation rule, every entry under the diagonal within
  ``tol * max(2 max|T_ii|, 1)`` (measured 0.27 of it).
- Resumed steps equal one call bit for bit (the window is re-derived from H).
- The sweep's tasks (the kernel's chain steps, slab column tiles, right-pass
  row tiles of H and Q, ``_sweep_tasks``) in 20 random orders that respect
  their dependencies give T, Q, the diagonal, the sweep count and hi bit for
  bit equal to the tasks in sequence, so a dependency the kernel would miss
  fails here; and within 1e-14 of max|H| (Q: 1e-14) of today's block-by-block
  order, whose products have other shapes, which the CPU's BLAS sums in
  another order (measured up to 3.2e-16).
- ``blocked_eigenvalues`` against ``qr_eigenvalues_pallas_blocked``:
  eigenvalues as above, residual ``max|A V - V diag(lambda)|`` to 5e-3, the
  JAX test's bound (tests/test_qr_blocked.py:134-144), and unit columns to 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcsc_eigenvalue_solver_project_tpu.ops.pallas.qr_eig_blocked import (
    pad_for_blocked, pad_q_identity, qr_eig_blocked_planes, qr_eig_blocked_step,
    qr_eig_blocked_step_q, qr_eigenvalues_pallas_blocked)
from pcsc_eigenvalue_solver_project_tpu.ops.pallas.qr_kernels import hessenberg_planes
from pcsc_eigenvalue_solver_project_tpu_torch import DenseMatrix, QROptions
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_eig_blocked as qb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import qr_eigenvalues as qe

TOL = 1e-6
EIG_LIMIT = 5e-4


def random_matrix(n, complex_values, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    if complex_values:
        a = a + 1j * rng.standard_normal((n, n)) / np.sqrt(n)
        return a.astype(np.complex64 if dtype == np.float32 else np.complex128)
    return a.astype(dtype)


def pallas_hessenberg(a):
    """The complex Hessenberg form of ``a`` from the Pallas B7, as (2, n, n)
    float32 planes and as a complex64 numpy matrix."""
    planes = np.stack([a.real, a.imag]).astype(np.float32)
    h = hessenberg_planes(jnp.asarray(planes), a.shape[0], interpret=True)
    hn = np.asarray(h)
    return h, (hn[0] + 1j * hn[1]).astype(np.complex64)


def nn_err(ea, eb):
    d = np.abs(np.asarray(ea)[:, None] - np.asarray(eb)[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max()) / max(1.0, np.abs(ea).max())


def from_planes(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1]


@pytest.mark.parametrize("complex_values", [False, True])
@pytest.mark.parametrize("n", [1, 4, 33])
def test_plain_matches_pallas_eigenvalues(n, complex_values):
    a = random_matrix(n, complex_values, seed=n)
    h, H = pallas_hessenberg(a)
    ej, sj, hij = qr_eig_blocked_planes(h, n, 40 * n + 100, TOL, interpret=True)
    e, s, hi = qb.qr_eig_blocked_plain(torch.from_numpy(H), 40 * n + 100, TOL)
    assert int(hij) <= 1 and int(hi) <= 1
    assert abs(int(s) - int(sj)) <= 1
    assert e.dtype == torch.complex64
    assert nn_err(from_planes(ej)[:n], e.numpy()) <= EIG_LIMIT
    assert nn_err(np.linalg.eigvals(a.astype(np.complex128)), e.numpy()) <= EIG_LIMIT


@functools.lru_cache(maxsize=None)
def unblocked_reference(n):
    """A complex128 Hessenberg matrix and B8's plain sweeps on it."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = tq.hessenberg_plain(torch.from_numpy(a))
    return (h,) + tq.qr_eig_plain(h, 60 * n, 1e-13)


@pytest.mark.parametrize("block", [1, 3, 7, 16])
@pytest.mark.parametrize("n", [2, 3, 17, 40, 65])
def test_plain_matches_unblocked_sweeps(n, block):
    h, e8, s8, hi8 = unblocked_reference(n)
    e, s, hi = qb.qr_eig_blocked_plain(h, 60 * n, 1e-13, block=block)
    assert int(hi) <= 1 and int(hi8) <= 1
    assert int(s) == int(s8)
    assert nn_err(e8.numpy(), e.numpy()) * max(1.0, float(e8.abs().max())) <= 1e-12


def test_shift_schedule_matches_pallas_step():
    n, sweeps = 33, 4
    a = random_matrix(n, True, seed=5)
    h, H = pallas_hessenberg(a)
    shifts = np.array([0.3 + 0.1j, -0.2, 0.5 - 0.4j])
    sh = np.zeros((2, 1, 128), np.float32)
    sh[0, 0, :3], sh[1, 0, :3] = shifts.real, shifts.imag
    p, _ = pad_for_blocked(h)
    pj, _, sj, hij = qr_eig_blocked_step(p, n, sweeps, 0.0, jnp.asarray(sh), 3, interpret=True)
    Hj = from_planes(np.asarray(pj)[:, :n, :n])
    hp, e, s, hi = qb.qr_eig_blocked_step(torch.from_numpy(H.astype(np.complex128)), sweeps, 0.0,
                                          torch.from_numpy(shifts))
    assert int(s) == int(sj) == sweeps and int(hi) == int(hij) == n
    scale = np.abs(H).max()
    assert np.abs(hp.numpy() - Hj).max() <= 1e-6 * n * scale
    np.testing.assert_array_equal(e.numpy(), np.diagonal(hp.numpy()))
    # and the schedule is what moved it: Wilkinson shifts give another H
    hw, _, _, _ = qb.qr_eig_blocked_step(torch.from_numpy(H.astype(np.complex128)), sweeps, 0.0)
    assert np.abs(hw.numpy() - Hj).max() > 1e-2 * scale


@pytest.mark.parametrize("sweeps,tol", [(4, 0.0), (40 * 33, TOL)], ids=["budget", "converge"])
def test_empty_schedule_is_wilkinson_like_pallas_step(sweeps, tol):
    # JAX n_shifts = 0 (an AED round that deflated its whole window): Wilkinson
    # shifts, in the plain step and in Schur mode
    n = 33
    a = random_matrix(n, True, seed=11)
    h, H = pallas_hessenberg(a)
    p, np_ = pad_for_blocked(h)
    empty = jnp.zeros((2, 1, 128), jnp.float32)
    pj, ej, sj, hij = qr_eig_blocked_step(p, n, sweeps, tol, empty, 0, interpret=True)
    pq, _ = pad_for_blocked(h)
    _, qj, ejq, sjq, hijq = qr_eig_blocked_step_q(pq, pad_q_identity(np_), n, sweeps, tol,
                                                  empty, 0, interpret=True)
    h_t = torch.from_numpy(H.astype(np.complex128))
    none = torch.zeros(0, dtype=torch.complex128)
    hp, e, s, hi = qb.qr_eig_blocked_step(h_t, sweeps, tol, none)
    tq_, qq, eq, sq, hiq = qb.qr_eig_blocked_step_q(h_t, torch.eye(n, dtype=h_t.dtype), sweeps,
                                                    tol, none)
    assert int(s) == int(sj) == int(sq) == int(sjq)
    assert int(hi) == int(hij) == int(hiq) == int(hijq)
    hw, ew, sw, _ = qb.qr_eig_blocked_step(h_t, sweeps, tol)  # no schedule at all
    assert torch.equal(hp, hw) and int(s) == int(sw)
    if tol == 0.0:
        assert int(s) == sweeps and int(hi) == n
        scale = np.abs(H).max()
        assert np.abs(hp.numpy() - from_planes(np.asarray(pj)[:, :n, :n])).max() \
            <= 1e-6 * n * scale
    else:
        assert int(hi) <= 1
        assert nn_err(from_planes(ej)[0, :n], e.numpy()) <= EIG_LIMIT
        assert nn_err(from_planes(ejq)[0, :n], eq.numpy()) <= EIG_LIMIT
    T, Q = tq_.numpy(), qq.numpy()
    assert np.abs(Q @ T @ Q.conj().T - H).max() <= 1e-6 * n * np.abs(H).max()


def test_schur_mode_matches_pallas():
    n = 33
    a = random_matrix(n, True, seed=9)
    h, H = pallas_hessenberg(a)
    ej, sj, hij, _, _ = qr_eig_blocked_planes(h, n, 40 * n, TOL, interpret=True,
                                              accumulate_q=True)
    e, s, hi, T, Q = qb.qr_eig_blocked_plain(torch.from_numpy(H), 40 * n, TOL,
                                             accumulate_q=True)
    assert int(hij) <= 1 and int(hi) <= 1 and abs(int(s) - int(sj)) <= 1
    assert nn_err(from_planes(ej)[:n], e.numpy()) <= EIG_LIMIT
    T, Q = T.numpy().astype(np.complex128), Q.numpy().astype(np.complex128)
    scale = np.abs(H).max()
    assert np.abs(Q @ T @ Q.conj().T - H).max() <= 1e-6 * n * scale
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() <= 1e-6 * n
    rule = TOL * max(2 * np.abs(np.diagonal(T)).max(), 1.0)
    assert np.abs(np.tril(T, -1)).max() <= rule
    np.testing.assert_array_equal(e.numpy(), np.diagonal(T).astype(np.complex64))


@pytest.mark.parametrize("schedule", [False, True])
def test_resumed_steps_equal_one_call(schedule):
    n, k = 40, 3
    h = tq.hessenberg_plain(torch.from_numpy(random_matrix(n, True, seed=3, dtype=np.float64)))
    shifts = torch.tensor([0.4 + 0.2j, -0.1j, 0.7], dtype=torch.complex128) if schedule else None
    h1, e1, s1, _ = qb.qr_eig_blocked_step(h, k, 1e-13, shifts, block=7)
    h2, e2, s2, hi2 = qb.qr_eig_blocked_step(h1, k, 1e-13, shifts, block=7)
    h_one, e_one, s_one, hi_one = qb.qr_eig_blocked_step(h, 2 * k, 1e-13, shifts, block=7)
    assert int(s1) + int(s2) == int(s_one) == 2 * k and int(hi2) == int(hi_one)
    assert torch.equal(h2, h_one) and torch.equal(e2, e_one)
    # Schur mode: resume with the Q of the first call
    q0 = torch.eye(n, dtype=h.dtype)
    t1, q1, _, _, _ = qb.qr_eig_blocked_step_q(h, q0, k, 1e-13, shifts, block=7)
    t2, q2, _, _, _ = qb.qr_eig_blocked_step_q(t1, q1, k, 1e-13, shifts, block=7)
    t_one, q_one, _, _, _ = qb.qr_eig_blocked_step_q(h, q0, 2 * k, 1e-13, shifts, block=7)
    assert torch.equal(t2, t_one) and torch.equal(q2, q_one)
    assert float((q2 @ t2 @ q2.conj().T - h).abs().max()) <= 1e-14 * n * float(h.abs().max())


ORDER_SWEEPS = 2
ORDER_TILES = (8, 8)  # slab columns and right-pass rows a task: several tiles at n = 33


@functools.lru_cache(maxsize=None)
def order_operand(n, inner):
    """A complex128 Hessenberg matrix; ``inner`` zeroes subdiagonal entries
    (H[41, 40] and those from H[91, 90] on) so that the active window is
    [41, 91), away from both edges."""
    rng = np.random.default_rng(100 + n)
    h = tq.hessenberg_plain(torch.from_numpy(rng.standard_normal((n, n))
                                             + 1j * rng.standard_normal((n, n))))
    if inner:
        h[41, 40] = 0
        h[torch.arange(91, n), torch.arange(90, n - 1)] = 0
    return h


@pytest.mark.parametrize("schur", [False, True], ids=["eigenvalues", "schur"])
@pytest.mark.parametrize("block", [1, 2, 3, 7, 32])
@pytest.mark.parametrize("n,inner", [(33, False), (65, False), (100, False), (100, True)])
def test_random_task_orders_equal_the_sequential_order(n, inner, block, schur):
    h = order_operand(n, inner)
    shifts = torch.tensor([0.3 + 0.1j, -0.2, 0.5 - 0.4j], dtype=torch.complex128)

    def run(order):
        return qb._sweeps_plain(h, ORDER_SWEEPS, 0.0, shifts, schur, None, block, order=order,
                                tiles=ORDER_TILES)

    seq = run("sequential")
    assert (int(seq[1]), int(seq[2])) == (ORDER_SWEEPS, 91 if inner else n)
    for seed in range(20):
        out = run(seed)
        assert (int(out[1]), int(out[2])) == (int(seq[1]), int(seq[2]))
        assert torch.equal(out[0], seq[0]) and torch.equal(out[3], seq[3]), seed
        if schur:
            assert torch.equal(out[4], seq[4]), seed
    today = run(None)
    assert (int(today[1]), int(today[2])) == (int(seq[1]), int(seq[2]))
    scale = float(h.abs().max())
    assert float((seq[3] - today[3]).abs().max()) <= 1e-14 * scale
    if schur:
        assert float((seq[4] - today[4]).abs().max()) <= 1e-14
        if inner:  # Schur mode updates the columns beyond hi, eigenvalues only does not
            assert not torch.equal(seq[3][:91, 91:], h[:91, 91:])
    elif inner:
        assert torch.equal(seq[3][:, 91:], h[:, 91:])


@pytest.mark.parametrize("compute_vectors", [False, True])
def test_blocked_eigenvalues_matches_pallas(compute_vectors):
    n = 33
    a = random_matrix(n, False, seed=7)
    out_j = qr_eigenvalues_pallas_blocked(a, 40 * n, TOL, interpret=True,
                                          compute_vectors=compute_vectors)
    out = qb.blocked_eigenvalues(torch.from_numpy(a), 40 * n, TOL,
                                 compute_vectors=compute_vectors)
    assert out[2] and out_j[2] and abs(out[1] - out_j[1]) <= 1
    e = out[0].numpy()
    assert out[0].dtype == torch.complex64
    assert nn_err(out_j[0], e) <= EIG_LIMIT
    assert nn_err(np.linalg.eigvals(a.astype(np.complex128)), e) <= EIG_LIMIT
    if compute_vectors:
        V = out[3].numpy().astype(np.complex128)
        assert np.abs(a @ V - V * e[None, :]).max() < 5e-3
        np.testing.assert_allclose(np.linalg.norm(V, axis=0), 1.0, atol=1e-5)


def test_arguments_are_checked():
    h = torch.zeros((8, 8), dtype=torch.complex64)
    for block in (0, qb.MAX_BLOCK + 1):
        with pytest.raises(ValueError, match="block"):
            qb.qr_eig_blocked_step(h, 5, TOL, block=block)
    with pytest.raises(ValueError, match="accumulate_q"):
        qb.qr_eig_blocked_plain(h, 5, TOL, q=torch.eye(8, dtype=h.dtype))
    with pytest.raises(ValueError, match="max_sweeps"):
        qb.qr_eig_blocked_step(h, -1, TOL)


class TestDispatch:
    def test_dispatch_table(self):
        boundary = qe.UNBLOCKED_MAX_N
        assert qe.qr_dispatch(4096, "cpu") == qe.qr_dispatch(8, torch.device("cpu")) == "torch"
        cuda = torch.device("cuda")
        if boundary is None:
            assert qe.qr_dispatch(65536, cuda) == "cuda_unblocked"
        else:
            assert qe.qr_dispatch(boundary, cuda) == "cuda_unblocked"
            assert qe.qr_dispatch(boundary + 1, cuda) == "cuda_blocked"
            assert qe.qr_dispatch(65536, cuda) == "cuda_blocked"

    def test_default_boundary(self):
        # measured on the H100: B8 ahead of B13 on every measure at 128, B13
        # ahead on every measure from 256 on
        assert 128 <= qe.UNBLOCKED_MAX_N < 256

    def test_non_cpu_tensors_never_take_the_plain_path(self):
        c = torch.empty((8, 8), dtype=torch.complex64, device="meta")
        calls = (lambda: qb.qr_eig_blocked_step(c, 5, TOL),
                 lambda: qb.qr_eig_blocked_step_q(c, c, 5, TOL),
                 lambda: qb.qr_eig_blocked_kernel(c, 5, TOL, accumulate_q=True))
        for call in calls:
            with pytest.raises(ValueError, match="^qr_eig_blocked_kernel: .*CUDA device"):
                call()
        with pytest.raises(ValueError, match="^hessenberg_kernel: .*CUDA device"):
            qb.blocked_eigenvalues(torch.empty((8, 8), device="meta"), 5, TOL)
        assert _build._lib is None
        assert qb.qr_eig_blocked_kernel.launches == 0

    def test_beyond_the_boundary_the_sweeps_are_blocked(self, monkeypatch):
        # qr_eigenvalues asks qr_dispatch once: beyond UNBLOCKED_MAX_N on a
        # non-CPU tensor it hands the accelerated solves blocked=True (B13),
        # at or below it blocked=False (B8)
        monkeypatch.setattr(qe, "UNBLOCKED_MAX_N", 4)
        calls = []

        def recorder(vectors):
            def solve(a, max_sweeps, tol, blocked=False):
                calls.append((a.shape[0], vectors, blocked))
                eig = torch.zeros(a.shape[0], dtype=torch.complex64, device=a.device)
                return (eig, 1, True) + ((torch.diag(eig),) if vectors else ())
            return solve

        monkeypatch.setattr(tq, "accelerated_eigenvalues", recorder(False))
        monkeypatch.setattr(tq, "accelerated_eigenpairs", recorder(True))
        for n in (4, 5):
            for vectors in (False, True):
                qe.qr_eigenvalues(DenseMatrix(torch.empty((n, n), device="meta")),
                                  QROptions(mode="accelerated", compute_vectors=vectors))
        assert calls == [(4, False, False), (4, True, False), (5, False, True), (5, True, True)]

    def test_blocked_eigenvalues_is_the_accelerated_solve_with_b13(self):
        # on a CPU tensor both run the plain versions of B7 and B13
        a = torch.from_numpy(random_matrix(6, True, seed=1))
        e, s, c = tq.accelerated_eigenvalues(a, 60 * 6, TOL, blocked=True)
        e2, s2, c2 = qb.blocked_eigenvalues(a, 60 * 6, TOL)
        assert c and (s, c) == (s2, c2) and torch.equal(e, e2)
        assert nn_err(np.linalg.eigvals(a.numpy().astype(np.complex128)), e.numpy()) <= EIG_LIMIT
        with pytest.raises(ValueError, match="^hessenberg_kernel: "):
            tq.accelerated_eigenvalues(torch.empty((4, 4), device="meta"), 5, TOL, blocked=True)
