"""The blocked Householder QR (B9's card algorithm) in its plain version,
``qr_decompose_blocked_plain``, against the JAX Pallas kernel and against
the unblocked plain version, on the CPU.

The card runs B9 by panels of ``nb`` columns (csrc/qr_kernels.cu): each
column's reflector with the rule of the unblocked step, the panel's compact
WY factor T, the trailing update ``R -= V T^H V^H R`` and Q accumulated
backward, ``Q[k0:, k0:] -= V T V^H Q[k0:, k0:]``. Its plain version follows
that order, so these tests exercise the blocked algebra the card runs, with
ragged panels (nb = 4, 8, 32 at n up to 100), ``kmax`` inside a panel and
the exact skips (factor 0) of a column already zero below its pivot.

Operands against the Pallas kernel are well conditioned (cond <= 2), and R
and Q, unique up to the diagonal unitary D of pivot phases, are compared
entry by entry once D is divided out (D itself to 1 within 1e-3), as the
card tests compare the kernels. Tolerances, relative to max|A| (Q: to 1): 1e-6 * n, as
``tests/test_torch_qr_kernels.py::TestQRDecomposeB9`` holds the unblocked
plain version to the Pallas kernel (float32 and complex64 on both sides;
the sums run in another order); 1e-13 * n between the blocked and the
unblocked plain versions in float64 and complex128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu.ops.pallas import qr_kernels as jq
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq


def random_matrix(n, complex_values, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if complex_values:
        a = a + 1j * rng.standard_normal((n, n))
        return a.astype(np.complex64 if dtype == np.float32 else np.complex128)
    return a.astype(dtype)


def well_conditioned(n, complex_values, seed):
    """U diag(uniform[1, 2]) V^H with random unitary U and V (cond <= 2): R
    and Q are unique up to the pivot phases, which stay well determined."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, n, n))
    if complex_values:
        g = g + 1j * rng.standard_normal((2, n, n))
    u, _ = np.linalg.qr(g[0])
    v, _ = np.linalg.qr(g[1])
    a = (u * rng.uniform(1, 2, n)) @ v.conj().T
    return a.astype(np.complex64 if complex_values else np.float32)


def to_planes(a):
    if np.iscomplexobj(a):
        return jnp.asarray(np.stack([a.real, a.imag]).astype(np.float32))
    return jnp.asarray(a[None])


def from_planes(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1] if p.shape[0] == 2 else p[0]


def rel(got, want, scale):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / scale


def phases(r, r_ref, k=None):
    """The diagonal unitary D with R = D R_ref (and Q = Q_ref D^H) over the
    first k pivots: a QR decomposition of full rank is unique up to it. In
    complex64 each pivot's phase moves by about eps / |pivot| between two
    summation orders, which shifts whole rows of R by up to ~1e-4 at n = 100;
    D is held to 1 within 1e-3 (a wrong phase convention is off by O(1))."""
    d, d_ref = np.diag(r)[:k], np.diag(r_ref)[:k]
    return (d / np.abs(d)) / (d_ref / np.abs(d_ref))


def assert_qr_close(r, q, r_ref, q_ref, scale, limit, k=None):
    d = phases(r, r_ref, k)
    assert np.abs(d - 1).max() <= 1e-3
    k = len(d)
    assert rel(r[:k], d[:, None] * r_ref[:k], scale) <= limit
    assert rel(q[:, :k], q_ref[:, :k] * d.conj(), 1.0) <= limit


KINDS = [False, True]  # complex values


@pytest.mark.parametrize("complex_values", KINDS)
@pytest.mark.parametrize("n,nb", [(5, 4), (33, 4), (33, 8), (33, 32), (100, 8), (100, 32)])
def test_blocked_plain_matches_pallas(n, nb, complex_values):
    a = well_conditioned(n, complex_values, seed=60 + n + nb)
    rj, qj = jq.qr_decompose_planes(to_planes(a), n, interpret=True)
    r, q = tq.qr_decompose_blocked_plain(torch.from_numpy(a), nb=nb)
    scale = np.abs(a).max()
    assert_qr_close(r.numpy(), q.numpy(), from_planes(rj), from_planes(qj), scale, 1e-6 * n)
    assert rel(q.numpy() @ r.numpy(), a, scale) <= 1e-6 * n
    assert np.abs(np.tril(r.numpy(), -1)).max() == 0  # the blocked R has exact zeros


@pytest.mark.parametrize("complex_values", KINDS)
@pytest.mark.parametrize("n,nb", [(1, 32), (2, 32), (31, 8), (32, 32), (33, 32), (64, 16),
                                  (100, 4), (100, 32)])
def test_blocked_plain_matches_unblocked(n, nb, complex_values):
    a = torch.from_numpy(random_matrix(n, complex_values, seed=n, dtype=np.float64))
    r, q = tq.qr_decompose_blocked_plain(a, nb=nb)
    rp, qp = tq.qr_decompose_plain(a)
    scale = float(a.abs().max())
    eye = torch.eye(n, dtype=a.dtype)
    assert float((r - rp).abs().max()) / scale <= 1e-13 * n
    assert float((q - qp).abs().max()) <= 1e-13 * n
    assert float((q.conj().T @ q - eye).abs().max()) <= 1e-13 * n
    assert float((q @ r - a).abs().max()) / scale <= 1e-13 * n


@pytest.mark.parametrize("complex_values", KINDS)
def test_kmax_inside_a_panel(complex_values):
    n, kmax = 100, 45  # the second panel of 32 is cut at 13 columns
    a = well_conditioned(n, complex_values, seed=7)
    rj, qj = jq.qr_decompose_planes(to_planes(a), kmax, interpret=True)
    r, q = tq.qr_decompose_blocked_plain(torch.from_numpy(a), kmax=kmax, nb=32)
    rp, qp = tq.qr_decompose_plain(torch.from_numpy(a), kmax=kmax)
    scale = np.abs(a).max()
    for got_r, got_q in ((from_planes(rj), from_planes(qj)), (rp.numpy(), qp.numpy())):
        # the first kmax rows of R and columns of Q up to D; the rest through
        # the product Q R
        assert_qr_close(r.numpy(), q.numpy(), got_r, got_q, scale, 1e-6 * n, k=kmax)
    r = r.numpy()
    assert np.abs(np.tril(r[:, :kmax], -1)).max() == 0  # kmax columns eliminated
    assert np.abs(np.tril(r[:, kmax:], -1)).max() > 1e-2   # the rest not
    assert rel(q.numpy() @ r, a, scale) <= 1e-6 * n


@pytest.mark.parametrize("complex_values", KINDS)
@pytest.mark.parametrize("nb", [4, 32])
def test_upper_triangular_input_skips_every_column_exactly(complex_values, nb):
    # each column is zero below its pivot: factor 0 (the tail-zero skip), so
    # R is A and Q is I bit for bit, as in the unblocked version
    a = np.triu(random_matrix(9, complex_values, seed=1))
    r, q = tq.qr_decompose_blocked_plain(torch.from_numpy(a), nb=nb)
    np.testing.assert_array_equal(r.numpy(), a)
    np.testing.assert_array_equal(q.numpy(), np.eye(9))
    rj, qj = jq.qr_decompose_planes(to_planes(a), 9, interpret=True)
    np.testing.assert_array_equal(from_planes(rj), a)


@pytest.mark.parametrize("complex_values", KINDS)
def test_zero_column_and_degenerate_reflector(complex_values):
    # column 3 zero from the start and column 0 zero at and below its pivot
    # (the degenerate skip): both take factor 0, and the QR still holds
    a = random_matrix(12, complex_values, seed=4)
    a[:, 3] = 0
    a[:, 0] = 0
    rj, qj = jq.qr_decompose_planes(to_planes(a), 12, interpret=True)
    r, q = tq.qr_decompose_blocked_plain(torch.from_numpy(a), nb=4)
    rp, qp = tq.qr_decompose_plain(torch.from_numpy(a))
    scale = np.abs(a).max()
    for got_r, got_q in ((from_planes(rj), from_planes(qj)), (rp.numpy(), qp.numpy())):
        assert rel(r.numpy(), got_r, scale) <= 1e-6 * 12
        assert rel(q.numpy(), got_q, 1.0) <= 1e-6 * 12
    assert r[0, 0] == 0
    assert rel(q.numpy() @ r.numpy(), a, scale) <= 1e-6 * 12


def test_panel_reflector_follows_the_column_step_rule():
    # the phase sign (1 when x0 = 0), unit v zero above the pivot, factor 2,
    # and r_jj = -sign ||x||, as reflector() and the unblocked step give
    x = torch.tensor([5.0, 0.0, 3.0, 4.0], dtype=torch.float64)
    v, f, d = tq._panel_reflector(x, 1)
    v_ref, f_ref = tq.reflector(x, 1)
    assert float(f) == float(f_ref) == 2.0
    torch.testing.assert_close(v, v_ref, rtol=0, atol=1e-15)
    assert v[0] == 0 and abs(float(d) + 5.0) < 1e-15  # sign 1 at x0 = 0
    xc = torch.tensor([1.0, -3j, 4.0], dtype=torch.complex128)
    v, f, d = tq._panel_reflector(xc, 1)
    assert abs(complex(d) - 5j) < 1e-15  # -(x0/|x0|) ||x|| = -(-1j) 5
    assert abs(float((v.abs() ** 2).sum()) - 1) < 1e-15
    _, f, d = tq._panel_reflector(torch.tensor([2.0, 7.0, 0.0]), 1)
    assert float(f) == 0 and float(d) == 7.0  # tail zero: skipped, r_jj = x0


@pytest.mark.parametrize("n,dtype,nb", [(512, torch.float32, 32), (2048, torch.float32, 16),
                                        (512, torch.float64, 32), (512, torch.complex64, 32),
                                        (512, torch.complex128, 16), (1760, torch.float32, 32),
                                        (1761, torch.float32, 16)])
def test_panel_width_keeps_the_first_panel_in_shared_memory(n, dtype, nb):
    # 32 columns where n x 32 elements fit in the panel kernel's 220 KB
    assert tq.qr_panel_width(n, dtype) == nb
