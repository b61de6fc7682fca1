"""B11's plain version (blocked compact-WY Hessenberg) against the JAX package.

The same numpy matrices go through the Pallas kernels of
``ops/pallas/hessenberg_blocked.py`` in interpret mode (as
tests/test_qr_blocked.py runs them) and through the port's dispatcher
``hessenberg_blocked``, which on a CPU tensor runs the plain version. Both
compute in float32 (complex64). Complex input is also held against
``hessenberg_blocked_embedded``, the TPU's B12 (complex reflectors on the
real 2n x 2n embedding), whose job the complex instantiation of B11 does.

H and Q are unique only up to a diagonal unitary D (signs for real data):
each entry of D is the phase of a pivot, which moves by about eps / |pivot|
with the summation order. D is read off the subdiagonals and divided out
(``H = D^H Hp D``, ``Q = Qp D``) before the entries are compared, and D
itself is held to 1 within 0.2, the single-precision limit of
tests/test_torch_cuda_kernels.py (measured up to 4.4e-3 at n = 200 in
complex64; a wrong phase convention moves it by O(1)).

Tolerances, relative to max|A| (Q: to 1), in units of 1e-6 * n: 3 for H
and 1 for Q, the limits of tests/test_torch_qr_kernels.py for B7 (the same
algorithm reorganised; the blocked and unblocked sums differ in order;
measured up to 0.27 and 0.084 units). The
residuals ``||A - Q H Q^H||`` and ``||Q^H Q - I||`` are held to 1 unit, and
the entries below the subdiagonal are exact zeros, as in the Pallas kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcsc_eigenvalue_solver_project_tpu.ops.pallas.hessenberg_blocked import (
    hessenberg_blocked_embedded, hessenberg_blocked_planes)
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import hessenberg_blocked as hb
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq
from pcsc_eigenvalue_solver_project_tpu_torch.solvers import hessenberg as hs


def random_matrix(n, complex_values, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    if complex_values:
        return (a + 1j * rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.complex64)
    return a.astype(np.float32)


def to_planes(a):
    if np.iscomplexobj(a):
        return jnp.asarray(np.stack([a.real, a.imag]).astype(np.float32))
    return jnp.asarray(a[None])


def from_planes(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1] if p.shape[0] == 2 else p[0]


def unit_phase(z):
    m = np.abs(z)
    return np.where(m > 0, z / np.where(m > 0, m, 1), 1)


def phases(h, hp):
    """D with h = D^H hp D and D[0] = 1, from the subdiagonals."""
    r = unit_phase(np.diagonal(hp, -1)) / unit_phase(np.diagonal(h, -1))
    return np.concatenate([[1], np.cumprod(r)])


def assert_same_reduction(a, h, q, hp, qp):
    """h, q against the reference hp, qp with D divided out, plus residuals."""
    n = a.shape[0]
    unit, scale = 1e-6 * n, np.abs(a).max()
    d = phases(h, hp)
    assert np.abs(d - 1).max() <= 0.2
    assert np.abs(h - d.conj()[:, None] * hp * d).max() <= 3 * unit * scale
    assert np.abs(q - qp * d).max() <= unit
    qc = q.astype(np.complex128)
    assert np.abs(qc @ h @ qc.conj().T - a).max() <= unit * scale
    assert np.abs(qc.conj().T @ qc - np.eye(n)).max() <= unit
    assert np.abs(np.tril(h, -2)).max(initial=0) == 0.0


@pytest.mark.parametrize("complex_values", [False, True])
@pytest.mark.parametrize("n", [4, 33, 65, 129, 150])
def test_matches_pallas(n, complex_values):
    a = random_matrix(n, complex_values, seed=n)
    hj, qj = hessenberg_blocked_planes(to_planes(a), n, interpret=True, accumulate_q=True)
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True)
    assert h.dtype == q.dtype == torch.from_numpy(a).dtype
    assert_same_reduction(a, h.numpy(), q.numpy(), from_planes(hj), from_planes(qj))
    assert torch.equal(hb.hessenberg_blocked(torch.from_numpy(a)), h)


@pytest.mark.parametrize("n", [150, 200])
def test_complex_matches_the_embedded_reduction(n):
    # B12: on the TPU the complex reduction beyond 1024 rows runs on the real
    # embedding; here B11 on complex data must give its H and Q
    a = random_matrix(n, True, seed=500 + n)
    hj, qj = hessenberg_blocked_embedded(to_planes(a), n, interpret=True, chunk=128,
                                         accumulate_q=True)
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True)
    assert_same_reduction(a, h.numpy(), q.numpy(), from_planes(hj), from_planes(qj))


@pytest.mark.parametrize("nb", [1, 7, 32, 64])
@pytest.mark.parametrize("complex_values", [False, True])
def test_matches_the_unblocked_reduction(nb, complex_values):
    # the blocked and unblocked reductions build the same reflectors; panel
    # widths that do and do not divide n - 2 = 98 (tail panels)
    a = random_matrix(100, complex_values, seed=3)
    h, q = hb.hessenberg_blocked_plain(torch.from_numpy(a), accumulate_q=True, nb=nb)
    hp, qp = tq.hessenberg_plain(torch.from_numpy(a), accumulate_q=True)
    assert_same_reduction(a, h.numpy(), q.numpy(), hp.numpy(), qp.numpy())


def block_triangular(n, p, complex_values, seed):
    """A random matrix with A[p:, :p] = 0: columns p - 2 and p - 1 are
    already zero below the subdiagonal after the earlier reflectors (which
    act on rows and columns < p only), so both take the tail-zero skip
    (tau = 0), the second with a zero pivot as well."""
    a = random_matrix(n, complex_values, seed)
    a[p:, :p] = 0
    return a


@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("complex_values", [False, True])
def test_tau_zero_inside_a_panel(nb, complex_values):
    # columns 4 and 5 skip: inside the first panel at nb = 8, at the start
    # of the second at nb = 4; the later columns of the panel reflect
    n = 40
    a = block_triangular(n, 6, complex_values, seed=11)
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True, nb=nb)
    assert float(h[6, 5].abs()) == 0.0 and float(h[7:, :6].abs().max()) == 0.0
    hj, qj = hessenberg_blocked_planes(to_planes(a), n, interpret=True, accumulate_q=True, nb=nb)
    assert_same_reduction(a, h.numpy(), q.numpy(), from_planes(hj), from_planes(qj))
    hp, qp = tq.hessenberg_plain(torch.from_numpy(a), accumulate_q=True)
    assert_same_reduction(a, h.numpy(), q.numpy(), hp.numpy(), qp.numpy())


@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("complex_values", [False, True])
def test_whole_panel_skipped(nb, complex_values):
    # the first nb columns are already upper Hessenberg: every reflector of
    # the first panel is zero, the trailing update leaves A as it was, and
    # the panels after it reduce the rest
    n = 36
    a = random_matrix(n, complex_values, seed=12)
    below = np.arange(n)[:, None] >= np.arange(n)[None, :] + 2
    a[:, :nb][below[:, :nb]] = 0
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True, nb=nb)
    np.testing.assert_array_equal(q.numpy()[:, :nb + 1], np.eye(n)[:, :nb + 1])
    hj, qj = hessenberg_blocked_planes(to_planes(a), n, interpret=True, accumulate_q=True, nb=nb)
    assert_same_reduction(a, h.numpy(), q.numpy(), from_planes(hj), from_planes(qj))
    hp, qp = tq.hessenberg_plain(torch.from_numpy(a), accumulate_q=True)
    assert_same_reduction(a, h.numpy(), q.numpy(), hp.numpy(), qp.numpy())


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_tiny_sizes(n):
    a = random_matrix(n, True, seed=1)
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True)
    hp, qp = tq.hessenberg_plain(torch.from_numpy(a), accumulate_q=True)
    np.testing.assert_allclose(h.numpy(), hp.numpy(), atol=1e-6)
    np.testing.assert_allclose(q.numpy(), qp.numpy(), atol=1e-6)


def test_already_hessenberg_passes_unchanged():
    # the tail-zero skip: tau = 0 and v = 0 on every column
    a = np.triu(random_matrix(40, True, seed=2), -1)
    h, q = hb.hessenberg_blocked(torch.from_numpy(a), accumulate_q=True, nb=8)
    np.testing.assert_array_equal(h.numpy(), a)
    np.testing.assert_array_equal(q.numpy(), np.eye(40))


def test_panel_width_is_checked():
    a = torch.zeros((8, 8))
    for nb in (0, 65):
        with pytest.raises(ValueError, match="panel width"):
            hb.hessenberg_blocked(a, nb=nb)


class TestDispatch:
    def test_non_cpu_tensors_never_take_the_plain_path(self):
        for dt in (torch.float32, torch.complex64):
            a = torch.empty((8, 8), dtype=dt, device="meta")
            for call in (lambda: hb.hessenberg_blocked(a), lambda: hb.hessenberg_blocked(a, True)):
                with pytest.raises(ValueError, match="hessenberg_blocked_kernel: .*CUDA device"):
                    call()
        assert _build._lib is None
        assert hb.hessenberg_blocked_kernel.launches == 0

    @pytest.mark.parametrize("dt", [torch.float32, torch.complex64])
    def test_boundary_picks_the_blocked_reduction(self, monkeypatch, dt):
        monkeypatch.setattr(hs, "HESSENBERG_BLOCKED_MIN_N", 8)
        below = torch.empty((7, 7), dtype=dt, device="meta")
        at = torch.empty((8, 8), dtype=dt, device="meta")
        with pytest.raises(ValueError, match="^hessenberg_kernel: "):
            tq.hessenberg_reduce(below)
        with pytest.raises(ValueError, match="^hessenberg_blocked_kernel: "):
            tq.hessenberg_reduce(at, accumulate_q=True)
        # on the CPU the same boundary picks the plain versions
        a = torch.from_numpy(random_matrix(12, dt.is_complex, seed=4))
        np.testing.assert_array_equal(tq.hessenberg_reduce(a).numpy(),
                                      hb.hessenberg_blocked_plain(a).numpy())

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.complex64,
                                    torch.complex128])
    def test_default_boundary_dispatch(self, dt):
        # at the boundary the sweep set (B7, one cluster kernel, ahead to 768;
        # B11 from 1024): one row below it B7, with a plan for either cluster
        # size, and B11 from it on, with Q and without
        n = hs.HESSENBERG_BLOCKED_MIN_N
        for q in (False, True):
            assert all(tq.hessenberg_cluster_plan(n - 1, dt, q, c) is not None
                       for c in tq.HESSENBERG_CLUSTERS)
            with pytest.raises(ValueError, match="^hessenberg_kernel: "):
                tq.hessenberg_reduce(torch.empty((n - 1, n - 1), dtype=dt, device="meta"), q)
            with pytest.raises(ValueError, match="^hessenberg_blocked_kernel: "):
                tq.hessenberg_reduce(torch.empty((n, n), dtype=dt, device="meta"), q)
        assert _build._lib is None

    def test_default_boundary(self):
        # measured on the H100: B7 ahead at 512, B11 from 1024 on; the
        # full-size path (4096) always runs B11
        assert 512 < hs.HESSENBERG_BLOCKED_MIN_N <= 4096
