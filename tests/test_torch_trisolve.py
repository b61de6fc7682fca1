"""B14's plain version (triangular eigenvectors) against the JAX package.

The same numpy triangular matrices go through the Pallas kernel of
``ops/pallas/trisolve_vec.py`` in interpret mode (as tests/test_trisolve.py
runs it) and through the port's dispatcher ``triangular_eigenvectors_device``,
which on a CPU tensor runs the plain version. Both compute in complex64 with
the same eps, block by block, with the same clamp and the same 1e18/1e-18
rescale counts.

Tolerances:
- Column k of Y is fixed by ``y[k] = 1`` times the column's rescale factor,
  a positive real, so the columns need no phase alignment: normalised
  columns are compared entry by entry. The random triangular operands of
  tests/test_trisolve.py grow Y by up to ~1e18 over the recurrence, which
  amplifies the f32 summation-order differences; measured up to 6.7e-6 (at
  n = 250), held to 1e-4. The overflow case rescales: its raw Y (not
  normalised, so the rescale counts must agree too) is held to 1e-5
  relative to max|Y|.
- Residual ``max|T y - lambda y|`` of the normalised columns: 5e-3 on the
  random operands and 5e-6 on a Schur factor, the limits of
  tests/test_trisolve.py.
- complex128 against the numpy oracle ``triangular_eigenvectors`` (f64 eps):
  1e-9 on normalised columns (measured 2.4e-11 at n = 250).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcsc_eigenvalue_solver_project_tpu.ops.pallas import qr_kernels as jq
from pcsc_eigenvalue_solver_project_tpu.ops.pallas.trisolve_vec import (
    triangular_eigenvectors_planes)
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import qr_kernels as tq
from pcsc_eigenvalue_solver_project_tpu_torch.ops import trisolve_vec as tv

F32_EPS = float(np.finfo(np.float32).eps)


def random_triangular(n, seed, dtype=np.complex64):
    """tests/test_trisolve.py's operand: a random upper triangle with the
    spectrum spread over [1, 3]."""
    rng = np.random.default_rng(seed)
    T = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return (T + np.diag(np.linspace(1.0, 3.0, n))).astype(dtype)


def schur_factor(n, seed):
    """The upper triangle of Q^H A Q for a random A: what the pipeline feeds."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)
    _, vec = np.linalg.eig(A)
    Q, _ = np.linalg.qr(vec)
    return np.triu(Q.conj().T @ A @ Q).astype(np.complex64)


def pallas(T, eps):
    planes = jnp.asarray(np.stack([T.real, T.imag]).astype(np.float32))
    Y = np.asarray(triangular_eigenvectors_planes(planes, T.shape[0], eps, interpret=True))
    return Y[0] + 1j * Y[1]


def port(T, eps):
    return tv.triangular_eigenvectors_device(torch.from_numpy(T), eps).numpy()


def normalised(Y):
    return Y / np.maximum(np.linalg.norm(Y, axis=0), 1e-30)


def residual(T, Y):
    Yn = normalised(Y.astype(np.complex128))
    return np.abs(T.astype(np.complex128) @ Yn - Yn * np.diagonal(T)[None, :]).max()


@pytest.mark.parametrize("n", [33, 129, 250])
def test_matches_pallas(n):
    T = random_triangular(n, seed=n)
    eps = F32_EPS * float(np.abs(T).max())
    Yj, Y = pallas(T, eps), port(T, eps)
    assert Y.dtype == np.complex64
    assert np.abs(np.tril(Y, -1)).max() == 0.0
    dg = np.diagonal(Y)  # the column scale: 1 or 1e-18^events, positive real
    assert (dg.real > 0).all() and np.abs(dg.imag).max() == 0.0
    np.testing.assert_array_equal(dg, np.diagonal(Yj))
    assert np.abs(normalised(Y) - normalised(Yj)).max() <= 1e-4
    assert residual(T, Y) < 5e-3


def test_schur_factor_matches_pallas():
    T = schur_factor(180, seed=0)
    eps = F32_EPS * float(np.abs(T).max())
    Yj, Y = pallas(T, eps), port(T, eps)
    assert np.abs(normalised(Y) - normalised(Yj)).max() <= 1e-4
    assert residual(T, Y) < 5e-6


def test_repeated_eigenvalues_rescale_like_pallas():
    # all eigenvalues equal: every pivot hits the eps clamp, the recurrence
    # overflows f32 without the rescale, and the counts must carry across
    # blocks exactly as in the Pallas kernel
    n = 40
    rng = np.random.default_rng(2)
    T = np.triu(0.1 * rng.standard_normal((n, n)), 1).astype(np.complex64)
    T += np.eye(n, dtype=np.complex64) * 2.0
    eps = F32_EPS * 2.0
    Yj, Y = pallas(T, eps), port(T, eps)
    assert np.isfinite(Y).all() and (np.linalg.norm(Y, axis=0) > 0).all()
    assert np.abs(Y).max() > 1e15  # the rescale was exercised
    assert np.abs(Y - Yj).max() <= 1e-5 * np.abs(Yj).max()


def test_repeated_eigenvalues_across_blocks():
    # 150 rows: more than one block of BLOCK_ROWS, so rescale events recorded
    # in a lower block scale its rows in the product of the blocks above
    n = 150
    rng = np.random.default_rng(4)
    T = np.triu(0.3 * rng.standard_normal((n, n)), 1).astype(np.complex64)
    T += np.eye(n, dtype=np.complex64) * 2.0
    eps = F32_EPS * 2.0
    Yj, Y = pallas(T, eps), port(T, eps)
    assert np.isfinite(Y).all()
    assert np.abs(normalised(Y) - normalised(Yj)).max() <= 1e-4


@pytest.mark.parametrize("n", [33, 129, 250])
def test_complex128_matches_numpy_oracle(n):
    T = random_triangular(n, seed=n, dtype=np.complex128)
    eps = float(np.finfo(np.float64).eps) * float(np.abs(T).max())
    Y = port(T, eps)
    assert Y.dtype == np.complex128
    oracle = tq.triangular_eigenvectors(T, source_real_dtype=np.float64)
    assert np.abs(normalised(Y) - normalised(oracle)).max() <= 1e-9


@pytest.mark.parametrize("source", [np.float32, np.float64])
def test_numpy_oracle_is_the_jax_one(source):
    T = random_triangular(20, seed=1, dtype=np.complex128)
    np.testing.assert_array_equal(tq.triangular_eigenvectors(T, source),
                                  jq.triangular_eigenvectors(T, source))


def test_non_cpu_tensors_never_take_the_plain_path():
    T = torch.empty((8, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tv.triangular_eigenvectors_device(T, 1e-6)
    assert _build._lib is None
    assert tv.triangular_eigenvectors_kernel.launches == 0
