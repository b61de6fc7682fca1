"""The QR kernels' plain versions (B7-B10) against the JAX Pallas kernels.

The same numpy inputs go through the Pallas kernels of
``ops/pallas/qr_kernels.py`` in interpret mode (as tests/test_qr_kernels.py
runs them) and through the port's dispatchers in ``ops/qr_kernels.py``,
which on CPU tensors run the plain versions. Both sides compute in float32
(complex64); only the summation order differs.

Tolerances, relative to max|A|:
- B7 Hessenberg ``H``: 3e-6 * n. The reduction is backward stable, but a
  single entry of ``H`` moves by up to ~n * eps * ||A|| when the sums are
  taken in another order (measured up to 4.8e-5 at n = 33 in complex64).
  ``Q``, and B9's ``R`` and ``Q``: 1e-6 * n.
- B8 eigenvalues: 5e-5 (nearest-neighbour matching). The sweep counts agree
  within 2: a deflation decision taken at the f32 rounding level may fall one
  sweep apart.
- B10: sweep counts and flags equal; ``H`` and eigenvalues to 1e-4 and
  ``maxsub`` to 1e-3 relative, after up to hundreds of f32 sweeps. The plain
  version of the card's B10 (Givens sweeps, ``qr_parity_blocked_plain``)
  runs an iterate that is the Pallas one's up to a diagonal unitary D: its
  diagonal and ``|H|`` are held to 1e-4, maxsub to 1e-3 relative; against
  ``qr_parity_plain`` in float64 and complex128 the entries with D divided
  out to 1e-12 of max|H| (its spectrum lies in (0, 1]).
- Eigenpairs (B7 + B8 with Q, then B14): eigenvalues as B8; each column of
  V, paired with the Pallas column of the nearest eigenvalue and its phase
  aligned, to 1e-4 (single precision times the eigenvector conditioning of
  a random 33 x 33 matrix; measured up to 3.5e-6); residual
  ``max_k ||A v_k - lambda_k v_k|| / ||A||`` to 1e-5 (measured up to
  1.6e-6) and unit columns to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcsc_eigenvalue_solver_project_tpu.ops.pallas import qr_kernels as jq
from pcsc_eigenvalue_solver_project_tpu_torch import DenseMatrix, QROptions
from pcsc_eigenvalue_solver_project_tpu_torch import qr_decompose, qr_eigenvalues, to_hessenberg
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq
from pcsc_eigenvalue_solver_project_tpu_torch.solvers.qr_eigenvalues import qr_dispatch


def random_matrix(n, complex_values, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if complex_values:
        return (a + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    return a.astype(np.float32)


def geometric_symmetric(n, ratio, seed):
    """Q diag(ratio**i) Q^T: the unshifted iteration converges on it."""
    rng = np.random.default_rng(seed)
    Qo, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Qo * ratio ** np.arange(n)) @ Qo.T).astype(np.float32)


def to_planes(a):
    if np.iscomplexobj(a):
        return jnp.asarray(np.stack([a.real, a.imag]).astype(np.float32))
    return jnp.asarray(a[None])


def from_planes(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1] if p.shape[0] == 2 else p[0]


def match_err(expected, got):
    """Max distance under optimal one-to-one matching, relative to max|expected|."""
    from scipy.optimize import linear_sum_assignment
    C = np.abs(np.asarray(expected)[:, None] - np.asarray(got)[None, :])
    r, c = linear_sum_assignment(C)
    return C[r, c].max() / max(np.abs(expected).max(), 1.0)


def rel(got, want, scale):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / scale


SIZES = [2, 5, 16, 33]
KINDS = [False, True]  # complex values


class TestHessenbergB7:
    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", SIZES)
    def test_matches_pallas(self, n, complex_values):
        a = random_matrix(n, complex_values, seed=n)
        hj, qj = jq.hessenberg_planes(to_planes(a), n, interpret=True, accumulate_q=True)
        h, q = tq.hessenberg_reduce(torch.from_numpy(a), accumulate_q=True)
        scale = np.abs(a).max()
        assert rel(h.numpy(), from_planes(hj), scale) <= 3e-6 * n
        assert rel(q.numpy(), from_planes(qj), 1.0) <= 1e-6 * n
        assert torch.equal(tq.hessenberg_reduce(torch.from_numpy(a)), h)
        # and the similarity A = Q H Q^H holds
        res = q.numpy().astype(np.complex128) @ h.numpy() @ q.numpy().conj().T - a
        assert np.abs(res).max() <= 1e-6 * n * scale

    @pytest.mark.parametrize("complex_values", KINDS)
    def test_already_hessenberg_passes_unchanged(self, complex_values):
        # the tail-zero skip (to_hessenberg.hpp:46-48): factor 0 on every column
        a = np.triu(random_matrix(9, complex_values, seed=1), -1)
        h, q = tq.hessenberg_reduce(torch.from_numpy(a), accumulate_q=True)
        np.testing.assert_array_equal(h.numpy(), a)
        np.testing.assert_array_equal(q.numpy(), np.eye(9))
        hj = from_planes(jq.hessenberg_planes(to_planes(a), 9, interpret=True))
        np.testing.assert_array_equal(hj, a)


class TestHessenbergClusterPlan:
    """B7's route on the card as a pure function of (n, dtype, Q, cluster
    size, shared memory): csrc/hessenberg_cluster.cu reckons the same layout,
    and the card tests hold the two to each other."""

    @pytest.mark.parametrize("n,dtype,q,cluster,h_smem,q_smem", [
        (512, torch.float32, True, 16, True, True),       # H and Q on chip: 2 MB over 16 blocks
        (512, torch.float32, False, 16, True, False),
        (512, torch.complex64, True, 16, True, False),    # Q through L2
        (512, torch.float64, True, 16, True, False),
        (512, torch.complex128, True, 16, False, False),  # a 256 KB slab: both through L2
        (656, torch.float32, True, 16, True, True),       # H and Q fit to n = 656 in float32
        (657, torch.float32, True, 16, True, False),
        (912, torch.float32, False, 16, True, False),     # H alone to n = 912
        (913, torch.float32, False, 16, False, False),
        (628, torch.complex64, False, 16, True, False),   # to 628 in complex64 and float64
        (629, torch.float64, False, 16, False, False),
        (432, torch.complex128, False, 16, True, False),  # to 432 in complex128
        (433, torch.complex128, False, 16, False, False),
        (512, torch.float32, True, 8, True, False),       # eight blocks: twice the slab
        (1, torch.float32, True, 16, True, True),
        (33, torch.complex128, True, 8, True, True),
    ])
    def test_layout(self, n, dtype, q, cluster, h_smem, q_smem):
        plan = tq.hessenberg_cluster_plan(n, dtype, q, cluster)
        item = torch.empty((), dtype=dtype).element_size()
        width = -(-n // cluster)
        assert (plan.cluster, plan.width, plan.h_smem, plan.q_smem) == \
            (cluster, width, h_smem, q_smem)
        slab = width * n * item
        assert plan.smem == 6 * (n + 1) * item + slab * (int(h_smem) + int(q_smem))
        assert plan.smem <= tq.HESSENBERG_SMEM_BUDGET

    def test_shared_memory_budget(self):
        # a smaller budget moves H, then the vectors, off chip
        vectors = 6 * 257 * 4
        full = tq.hessenberg_cluster_plan(256, torch.float32, True, 16)
        assert full.h_smem and full.q_smem and full.smem == vectors + 2 * 16 * 256 * 4
        plan = tq.hessenberg_cluster_plan(256, torch.float32, True, 16, smem_budget=full.smem - 1)
        assert plan.h_smem and not plan.q_smem
        plan = tq.hessenberg_cluster_plan(256, torch.float32, True, 16, smem_budget=vectors)
        assert not plan.h_smem and not plan.q_smem and plan.smem == vectors
        assert tq.hessenberg_cluster_plan(256, torch.float32, True, 16,
                                          smem_budget=vectors - 1) is None

    def test_no_room_for_the_vectors(self):
        # six vectors of n + 1 complex128 scalars exceed 226 KB from n = 2410
        assert tq.hessenberg_cluster_plan(2409, torch.complex128, False, 8) is not None
        assert tq.hessenberg_cluster_plan(2410, torch.complex128, False, 16) is None
        assert tq.hessenberg_cluster_plan(2410, torch.float32, False, 16) is not None

    def test_cluster_choice(self):
        seen = []

        def capacity(clusters_of):
            def cap(cluster, smem):
                seen.append((cluster, smem))
                return clusters_of[cluster]
            return cap

        plan = tq.choose_hessenberg_plan(512, torch.float32, True, capacity({16: 1, 8: 2}))
        assert plan.cluster == 16 and seen == [(16, plan.smem)]
        seen.clear()
        plan = tq.choose_hessenberg_plan(512, torch.float32, True, capacity({16: 0, 8: 3}))
        assert plan.cluster == 8 and [c for c, _ in seen] == [16, 8]
        assert plan == tq.hessenberg_cluster_plan(512, torch.float32, True, 8)
        with pytest.raises(ValueError, match="no cluster of \\(16, 8\\) blocks fits"):
            tq.choose_hessenberg_plan(512, torch.float32, True, capacity({16: 0, 8: 0}))
        with pytest.raises(ValueError, match="no cluster"):
            tq.choose_hessenberg_plan(4096, torch.complex128, True, capacity({16: 9, 8: 9}))

    def test_plan_is_decided_before_any_build(self):
        with pytest.raises(ValueError, match="^hessenberg_kernel: .*CUDA device"):
            tq.hessenberg_kernel(torch.empty((8, 8), device="meta"))
        assert _build._lib is None


class TestQRDecomposeB9:
    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", SIZES)
    def test_matches_pallas(self, n, complex_values):
        a = random_matrix(n, complex_values, seed=50 + n)
        rj, qj = jq.qr_decompose_planes(to_planes(a), n, interpret=True)
        r, q = tq.householder_qr(torch.from_numpy(a))
        scale = np.abs(a).max()
        assert rel(r.numpy(), from_planes(rj), scale) <= 1e-6 * n
        assert rel(q.numpy(), from_planes(qj), 1.0) <= 1e-6 * n
        assert rel(q.numpy() @ r.numpy(), a, scale) <= 1e-6 * n

    def test_kmax_steps(self):
        a = random_matrix(8, False, seed=3)
        rj, qj = jq.qr_decompose_planes(to_planes(a), 3, interpret=True)
        r, q = tq.householder_qr(torch.from_numpy(a), kmax=3)
        assert rel(r.numpy(), from_planes(rj), np.abs(a).max()) <= 1e-5
        assert rel(q.numpy(), from_planes(qj), 1.0) <= 1e-5
        assert np.abs(np.tril(r.numpy()[:, :3], -1)).max() <= 1e-6  # 3 columns eliminated
        assert np.abs(np.tril(r.numpy()[:, 3:], -1)).max() > 1e-2   # the rest untouched


class TestEigRoute:
    """B8's plan on the card as a pure function of (n, dtype, Q, block),
    decided before any build: the kernel takes the layout ``eig_layout``
    reckons, and its entry point checks the layout's order and size."""

    @pytest.mark.parametrize("dtype,q,edge", [
        (torch.complex64, False, 165),    # H on chip to 165 rows (row stride n | 1)
        (torch.complex64, True, 154),     # Q's staged row tiles take room
        (torch.complex128, False, 118),
        (torch.complex128, True, 109),
    ])
    def test_route_edge(self, dtype, q, edge):
        on_chip, beyond = tq.qr_eig_route(edge, dtype, q), tq.qr_eig_route(edge + 1, dtype, q)
        assert on_chip.h_smem and not beyond.h_smem
        assert on_chip.smem <= tq.EIG_SMEM_BUDGET < tq.eig_layout(
            edge + 1, beyond.block, True, q, torch.empty((), dtype=dtype).element_size()).bytes
        assert beyond.smem < 70 * 1024  # in global memory the block keeps only its tiles

    @pytest.mark.parametrize("n,block,h_smem,q,item", [
        (128, 8, True, False, 8), (128, 8, True, True, 8), (300, 16, False, True, 8),
        (64, 16, True, False, 16), (1, 1, True, False, 8)])
    def test_layout_bytes(self, n, block, h_smem, q, item):
        us = block + 1
        staged = (7 if q else 0) if h_smem else (11 if q else 8)
        h = n * (n | 1) if h_smem else us * (2 * (block + 2) + block)
        elems = h + 4 * (us * us + block) + us + staged * 32 * (us | 1)
        layout = tq.eig_layout(n, block, h_smem, q, item)
        assert layout.bytes == elems * item + 4 * (1 + 16 + -(-n // 32))
        assert layout.off_ints == elems * item and layout.us == us and layout.sst == us | 1
        assert layout.staged0 == 16 - staged and layout.nslab + layout.nright + layout.nq == 15
        assert layout.off_ring == (n * (n | 1) * item if h_smem else 0)

    def test_default_block(self):
        assert [tq.eig_block(n, torch.complex64) for n in (2, 64, 128, 129, 256)] == \
            [8, 8, 8, 16, 16]
        assert {tq.eig_block(n, torch.complex128) for n in (2, 128, 256, 4096)} == {8}
        assert tq.qr_eig_route(256, torch.complex64, True).block == 16
        assert tq._eig_plan(256, torch.complex64, True, 5).block == 5

    def test_block_range_and_size(self):
        for block in (0, 17):
            with pytest.raises(ValueError, match="block"):
                tq._eig_plan(64, torch.complex64, False, block)
        # in global memory the counters (one a column tile) grow with n
        assert not tq.qr_eig_route(1 << 20, torch.complex128, True).h_smem
        with pytest.raises(ValueError, match="does not fit"):
            tq.qr_eig_route(1 << 21, torch.complex128, True)

    def test_plan_is_decided_before_any_build(self):
        c = torch.empty((8, 8), dtype=torch.complex64, device="meta")
        with pytest.raises(ValueError, match="^qr_eig_kernel: .*CUDA device"):
            tq.qr_eig_kernel(c, 5, 1e-6)
        with pytest.raises(ValueError, match="^qr_parity_kernel: .*CUDA device"):
            tq.qr_parity_kernel(torch.empty((8, 8), device="meta"), 5, 1e-6)
        assert _build._lib is None


def hessenberg_of(a):
    return tq.hessenberg_plain(torch.from_numpy(a)).numpy()


def eig_both(h, max_sweeps, tol, **kw):
    """B8 on the complex Hessenberg h: (Pallas eig, sweeps, hi), (port ...)."""
    hc = h.astype(np.complex64)  # real input widens to two planes, as on the TPU
    out_j = jq.qr_hessenberg_eig_planes(to_planes(hc), h.shape[0], max_sweeps, tol,
                                        interpret=True, **kw)
    return out_j, tq.qr_eig_sweeps(torch.from_numpy(hc), max_sweeps, tol, **kw)


class TestQREigB8:
    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", SIZES)
    def test_matches_pallas(self, n, complex_values):
        h = hessenberg_of(random_matrix(n, complex_values, seed=100 + n))
        (ej, sj, hij), (e, s, hi) = eig_both(h, 60 * n, 1e-6)
        assert int(hij) <= 1 and int(hi) <= 1
        assert abs(int(s) - int(sj)) <= 2
        assert match_err(from_planes(ej), e.numpy()) <= 5e-5
        assert match_err(np.linalg.eigvals(h.astype(np.complex128)), e.numpy()) <= 5e-5

    def test_symmetric(self):
        b = random_matrix(12, False, seed=7)
        h = hessenberg_of((b + b.T) / 2)
        (ej, sj, hij), (e, s, hi) = eig_both(h, 600, 1e-6)
        assert int(hi) <= 1 and abs(int(s) - int(sj)) <= 2
        assert np.abs(e.numpy().imag).max() < 1e-4
        np.testing.assert_allclose(np.sort(e.numpy().real), np.sort(from_planes(ej).real),
                                   atol=5e-5 * np.abs(b).max())

    @pytest.mark.parametrize("complex_values", KINDS)
    def test_max_sweeps_cap(self, complex_values):
        # a budget of 2 sweeps: both stop there, unconverged, with the same
        # window and the same diagonal to rounding
        h = hessenberg_of(random_matrix(8, complex_values, seed=5))
        (ej, sj, hij), (e, s, hi) = eig_both(h, 2, 1e-12)
        assert int(s) == int(sj) == 2
        assert int(hi) == int(hij) > 1
        assert rel(e.numpy(), from_planes(ej), np.abs(h).max()) <= 1e-5

    def test_schur_vectors_match_pallas(self):
        # accumulate_q: h = Q T Q^H, after a fixed budget of 6 sweeps
        h = hessenberg_of(random_matrix(10, True, seed=9))
        (ej, sj, hij, tj, qj), (e, s, hi, t, q) = eig_both(h, 6, 1e-12, accumulate_q=True)
        scale = np.abs(h).max()
        assert int(s) == int(sj) == 6
        assert rel(t.numpy(), from_planes(tj), scale) <= 1e-5
        assert rel(q.numpy(), from_planes(qj), 1.0) <= 1e-5
        assert rel(q.numpy() @ t.numpy() @ q.numpy().conj().T, h, scale) <= 1e-5

    @pytest.mark.parametrize("n", [64, 200])
    def test_schur_vectors_match_pallas_at_window_sizes(self, n):
        # AED's window sizes: T and Q after a budget of 4 sweeps, to one unit
        # of 1e-6 n (max|h|; Q: 1)
        h = hessenberg_of(random_matrix(n, True, seed=n))
        (ej, sj, hij, tj, qj), (e, s, hi, t, q) = eig_both(h, 4, 1e-12, accumulate_q=True)
        scale = np.abs(h).max()
        assert int(s) == int(sj) == 4 and int(hi) == int(hij) == n
        assert rel(t.numpy(), from_planes(tj), scale) <= 1e-6 * n
        assert rel(q.numpy(), from_planes(qj), 1.0) <= 1e-6 * n
        qn = q.numpy().astype(np.complex128)
        assert rel(qn @ t.numpy() @ qn.conj().T, h, scale) <= 1e-6 * n

    def test_window_sweeps_from_lo(self):
        # a negligible subdiagonal in the middle splits the window: the kernel
        # sweeps only the trailing block [lo, hi), rows above stay untouched
        h = hessenberg_of(random_matrix(8, False, seed=11)).astype(np.complex64)
        h[4, 3] = 0
        (ej, sj, hij), (e, s, hi) = eig_both(h, 1, 1e-6)
        assert int(s) == int(sj) == 1
        np.testing.assert_array_equal(e.numpy()[:4], np.diagonal(h)[:4])
        assert rel(e.numpy(), from_planes(ej), np.abs(h).max()) <= 1e-5


class TestParityB10:
    @pytest.mark.parametrize("n", [5, 8])
    def test_converges_like_pallas(self, n):
        h = hessenberg_of(geometric_symmetric(n, 0.8, seed=n))
        hj, itj, cj, mj = jq.qr_parity_planes(to_planes(h), n, 2000, 1e-5, interpret=True)
        H, it, c, m = tq.parity_sweeps(torch.from_numpy(h), 2000, 1e-5)
        assert bool(c) and bool(cj)
        assert int(it) == int(itj)
        assert rel(H.numpy(), from_planes(hj), 1.0) <= 1e-4
        assert abs(float(m) - float(mj)) <= 1e-3 * max(float(mj), 1e-30) + 1e-7

    @pytest.mark.parametrize("complex_values", KINDS)
    def test_budget_without_convergence(self, complex_values):
        h = hessenberg_of(random_matrix(6, complex_values, seed=2))
        hj, itj, cj, mj = jq.qr_parity_planes(to_planes(h), 6, 3, 1e-12, interpret=True)
        H, it, c, m = tq.parity_sweeps(torch.from_numpy(h), 3, 1e-12)
        assert int(it) == int(itj) == 3 and not bool(c) and not bool(cj)
        assert rel(H.numpy(), from_planes(hj), np.abs(h).max()) <= 1e-5
        assert abs(float(m) - float(mj)) <= 1e-4 * float(mj)

    def test_zero_budget(self):
        h = hessenberg_of(random_matrix(4, False, seed=0))
        H, it, c, m = tq.parity_sweeps(torch.from_numpy(h), 0, 1e-6)
        assert int(it) == 0 and not bool(c) and float(m) == 0.0
        np.testing.assert_array_equal(H.numpy(), h)


def parity_both(h, max_iterations, tol):
    """B10 on the Hessenberg h: the Pallas kernel (Householder sweeps, in
    interpret mode) and the plain version of the card's B10 (Givens sweeps),
    each as (H, it, converged, maxsub) in numpy and Python scalars."""
    hj, itj, cj, mj = jq.qr_parity_planes(to_planes(h), h.shape[0], max_iterations, tol,
                                          interpret=True)
    H, it, c, m = tq.qr_parity_blocked_plain(torch.from_numpy(h), max_iterations, tol)
    return ((from_planes(hj), int(itj), bool(cj), float(mj)),
            (H.numpy(), int(it), bool(c), float(m)))


def assert_same_up_to_phases(H, hj, scale, limit):
    """The two iterates agree up to a diagonal unitary D (H = D^H hj D): the
    diagonal and the moduli of the entries, which D does not change."""
    assert rel(np.diagonal(H), np.diagonal(hj), scale) <= limit
    assert rel(np.abs(H), np.abs(hj), scale) <= limit


class TestParityB10Blocked:
    """``qr_parity_blocked_plain``, the card's B10 in its order (unshifted
    Givens sweeps on the whole window), against the Pallas kernel's
    Householder sweeps: on a Hessenberg matrix the iterates agree up to a
    diagonal unitary D, so the diagonal and ``|H|`` are held to 1e-4 of
    max|h|, maxsub to 1e-3 relative, and the counts and flags exactly."""

    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", [1, 2, 5, 33, 64])
    def test_budget_matches_pallas(self, n, complex_values):
        h = hessenberg_of(random_matrix(n, complex_values, seed=400 + n))
        (hj, itj, cj, mj), (H, it, c, m) = parity_both(h, 6, 0.0)
        assert H.dtype == h.dtype  # real input stays real
        assert (it, c) == (itj, cj) == ((1, True) if n == 1 else (6, False))
        assert_same_up_to_phases(H, hj, np.abs(h).max(), 1e-4)
        assert abs(m - mj) <= 1e-3 * mj

    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", [5, 8])
    def test_converges_like_pallas(self, n, complex_values):
        h = hessenberg_of(geometric_symmetric(n, 0.8, seed=n))
        if complex_values:
            h = h.astype(np.complex64)
        (hj, itj, cj, mj), (H, it, c, m) = parity_both(h, 2000, 1e-5)
        assert c and cj and it == itj
        assert_same_up_to_phases(H, hj, 1.0, 1e-4)
        assert abs(m - mj) <= 1e-3 * max(mj, 1e-30) + 1e-7

    @pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
    def test_matches_householder_plain_in_double(self, dtype):
        # the bench operand's construction at 40 (complex: a unitary Q), to
        # tol 1e-10 in double: the same count, the entries equal once D is
        # divided out
        n = 40
        rng = np.random.default_rng(3)
        g = rng.standard_normal((n, n))
        if dtype.is_complex:
            g = g + 1j * rng.standard_normal((n, n))
        Qo, _ = np.linalg.qr(g)
        a = torch.from_numpy((Qo * 0.8 ** np.arange(n)) @ Qo.conj().T).to(dtype)
        h = tq.hessenberg_plain(a)
        H, it, c, m = tq.qr_parity_blocked_plain(h, 2000, 1e-10)
        Hp, itp, cp, mp = tq.qr_parity_plain(h, 2000, 1e-10)
        assert bool(c) and bool(cp) and int(it) == int(itp)
        H, Hp = H.numpy(), Hp.numpy()
        sub, subp = np.diagonal(H, -1), np.diagonal(Hp, -1)
        d = np.concatenate([[1], np.cumprod(np.sign(subp) / np.sign(sub) if not dtype.is_complex
                                            else (subp / abs(subp)) / (sub / abs(sub)))])
        assert rel(H, d.conj()[:, None] * Hp * d, 1.0) <= 1e-12
        assert abs(float(m) - float(mp)) <= 1e-6 * float(mp)

    @pytest.mark.parametrize("complex_values", KINDS)
    def test_exact_zero_subdiagonal_keeps_iterating(self, complex_values):
        # an exact zero on the subdiagonal splits nothing: both blocks keep
        # iterating as a whole, as the Pallas kernel does (its tail-zero skip
        # and the identity rotation of a zero pair), and the zero stays
        h = np.triu(hessenberg_of(random_matrix(8, complex_values, seed=21)), -1)
        h[4, 3] = 0
        (hj, itj, cj, mj), (H, it, c, m) = parity_both(h, 4, 0.0)
        assert (it, c) == (itj, cj) == (4, False)
        assert H[4, 3] == 0 and hj[4, 3] == 0
        assert np.abs(H[:4, :4] - h[:4, :4]).max() > 1e-2
        assert np.abs(H[4:, 4:] - h[4:, 4:]).max() > 1e-2
        assert_same_up_to_phases(H, hj, np.abs(h).max(), 1e-4)
        assert abs(m - mj) <= 1e-3 * mj


class TestWholeStack:
    """``accelerated_eigenvalues`` and ``parity_eigenvalues`` against
    ``qr_eigenvalues_pallas`` and ``qr_parity_pallas``."""

    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", [5, 16])
    def test_accelerated(self, n, complex_values):
        a = random_matrix(n, complex_values, seed=200 + n)
        ej, sj, cj = jq.qr_eigenvalues_pallas(a, 60 * n, 1e-6, interpret=True)
        e, s, c = tq.accelerated_eigenvalues(torch.from_numpy(a), 60 * n, 1e-6)
        assert c and cj and abs(s - sj) <= 2
        assert e.dtype == torch.complex64
        assert match_err(ej, e.numpy()) <= 5e-5

    def test_accelerated_max_sweeps(self):
        a = random_matrix(8, False, seed=5)
        _, sj, cj = jq.qr_eigenvalues_pallas(a, 2, 1e-12, interpret=True)
        _, s, c = tq.accelerated_eigenvalues(torch.from_numpy(a), 2, 1e-12)
        assert s == sj == 2 and not c and not cj

    @pytest.mark.parametrize("complex_values", KINDS)
    def test_parity(self, complex_values):
        a = geometric_symmetric(6, 0.7, seed=1)
        if complex_values:
            a = a.astype(np.complex64)
        ej, ij, cj, mj = jq.qr_parity_pallas(a, 2000, 1e-5, interpret=True)
        e, i, c, m = tq.parity_eigenvalues(torch.from_numpy(a), 2000, 1e-5)
        assert c and cj and i == ij
        assert e.dtype == torch.from_numpy(a).dtype  # real input keeps its dtype
        np.testing.assert_allclose(np.sort(e.numpy().real), np.sort(ej.real), atol=1e-4)
        np.testing.assert_allclose(np.sort(e.numpy().real), np.sort(0.7 ** np.arange(6)),
                                   atol=1e-4)

    @pytest.mark.parametrize("complex_values", KINDS)
    @pytest.mark.parametrize("n", [16, 33])
    def test_accelerated_eigenpairs(self, n, complex_values):
        a = random_matrix(n, complex_values, seed=300 + n)
        ej, sj, cj, Vj = jq.qr_eigenvalues_pallas(a, 60 * n, 1e-6, interpret=True,
                                                  compute_vectors=True)
        e, s, c, V = tq.accelerated_eigenpairs(torch.from_numpy(a), 60 * n, 1e-6)
        assert c and cj and abs(s - sj) <= 2
        assert e.dtype == V.dtype == torch.complex64 and V.shape == (n, n)
        assert match_err(ej, e.numpy()) <= 5e-5
        e, V = e.numpy().astype(np.complex128), V.numpy().astype(np.complex128)
        np.testing.assert_allclose(np.linalg.norm(V, axis=0), 1.0, atol=1e-5)
        worst = 0.0
        for k in range(n):  # pair by eigenvalue, align the phase
            j = int(np.argmin(np.abs(ej - e[k])))
            p = np.vdot(V[:, k], Vj[:, j])
            worst = max(worst, np.abs(V[:, k] * p / abs(p) - Vj[:, j]).max())
        assert worst <= 1e-4
        res = np.linalg.norm(a @ V - V * e[None, :], axis=0).max() / np.linalg.norm(a, 2)
        assert res <= 1e-5

    def test_parity_nonconvergence_reports_max_plus_one(self):
        # reference quirk: iterations == max_iterations + 1 (qr_eigenvalues.hpp:69,104)
        a = random_matrix(6, False, seed=2)
        _, ij, cj, _ = jq.qr_parity_pallas(a, 3, 1e-12, interpret=True)
        _, i, c, _ = tq.parity_eigenvalues(torch.from_numpy(a), 3, 1e-12)
        assert i == ij == 4 and not c and not cj


class TestDispatch:
    """The plain versions run only for CPU tensors; anything else goes to a
    kernel wrapper, which launches or raises."""

    def test_non_cpu_tensors_never_take_the_plain_path(self):
        a = torch.empty((8, 8), device="meta")
        c = torch.empty((8, 8), dtype=torch.complex64, device="meta")
        calls = [lambda: tq.hessenberg_reduce(a), lambda: tq.hessenberg_reduce(a, True),
                 lambda: tq.qr_eig_sweeps(c, 10, 1e-6), lambda: tq.householder_qr(a),
                 lambda: tq.parity_sweeps(a, 10, 1e-6),
                 lambda: tq.accelerated_eigenvalues(a, 10, 1e-6),
                 lambda: tq.accelerated_eigenpairs(c, 10, 1e-6),
                 lambda: qr_eigenvalues(DenseMatrix(a),
                                        QROptions(mode="accelerated", compute_vectors=True)),
                 lambda: tq.parity_eigenvalues(c, 10, 1e-6),
                 lambda: to_hessenberg(DenseMatrix(a)),
                 lambda: qr_decompose(DenseMatrix(c)),
                 lambda: qr_eigenvalues(DenseMatrix(a), QROptions(mode="accelerated")),
                 lambda: qr_eigenvalues(DenseMatrix(c), QROptions(mode="parity"))]
        for call in calls:
            with pytest.raises(ValueError, match="expected a CUDA device"):
                call()
        assert _build._lib is None  # rejected before any build
        assert all(k.launches == 0 for k in tq.KERNELS)

    def test_dispatch_table(self):
        from pcsc_eigenvalue_solver_project_tpu_torch.solvers.qr_eigenvalues import (
            UNBLOCKED_MAX_N)
        assert qr_dispatch(512, "cpu") == "torch"
        for n in (1, 512, 4096, 65536):  # the unblocked sweeps up to UNBLOCKED_MAX_N, then B13
            blocked = UNBLOCKED_MAX_N is not None and n > UNBLOCKED_MAX_N
            assert qr_dispatch(n, torch.device("cuda")) == \
                ("cuda_blocked" if blocked else "cuda_unblocked")

    def test_reset_launch_counts(self):
        for k in tq.KERNELS:
            k.launches = 3
        tq.reset_launch_counts()
        assert [k.launches for k in tq.KERNELS] == [0] * 7
        assert {k.__name__ for k in tq.KERNELS} >= {"hessenberg_blocked_kernel",
                                                   "triangular_eigenvectors_kernel",
                                                   "qr_eig_blocked_kernel"}
