"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. On a machine
with an H100 (no JAX needed there):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

``--noconftest`` skips the suite's conftest, which imports JAX. The first
test builds the kernels with nvcc. Errors are measured relative to
``max|y|``: 1e-5 for float32, bfloat16 (both sides read the same bf16
values and accumulate in float32) and complex64; 1e-12 for float64 and
complex128. The sums differ from the plain versions only in FMA rounding.
"""

import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as ds

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5, torch.complex64: 1e-5,
       torch.float64: 1e-12, torch.complex128: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def band(n, offsets, dtype, seed, device):
    """(k, n) diagonals with zeros outside the matrix, and an (n,) vector of
    the accumulation dtype, from numpy."""
    rng = np.random.default_rng(seed)
    k = len(offsets)
    vals = rng.uniform(-1, 1, (k, n))
    x = rng.uniform(-1, 1, n)
    if dtype.is_complex:
        vals = vals + 1j * rng.uniform(-1, 1, (k, n))
        x = x + 1j * rng.uniform(-1, 1, n)
    for d, off in enumerate(offsets):
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    vals_t = torch.from_numpy(vals).to(device=device, dtype=dtype)
    x_t = torch.from_numpy(x).to(device=device, dtype=ds.acc_dtype(dtype))
    return vals_t, x_t


def rel_err(y, y_ref):
    scale = y_ref.abs().max().clamp_min(1e-30)
    return float((y - y_ref).abs().max() / scale)


ROWMAJOR_CASES = [
    (16384, (-1, 0, 1)),
    (16500, (-16, -3, 0, 7, 16)),
    (20000, tuple(range(-16, 17))),
    (16384, (-130, 0, 129)),
    (1_000_003, (-130, 0, 129)),          # ragged n at full size
    (1_000_000, tuple(range(-16, 17))),   # the 1M x 33 bench operator
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,offsets", ROWMAJOR_CASES)
def test_rowmajor_kernel_matches_plain(cuda, n, offsets, dtype):
    vals, x = band(n, offsets, dtype, seed=42, device=cuda)
    kernel = ds.dia_complex_kernel if dtype.is_complex else ds.dia_kernel
    before = kernel.launches
    y = ds.dia_matvec(vals, offsets, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y_ref = ds.dia_matvec_plain(vals, offsets, x)
    assert y.dtype == y_ref.dtype == ds.acc_dtype(dtype)
    assert rel_err(y, y_ref) <= TOL[dtype]


IL_CASES = [
    (20000, tuple(range(-16, 17)), 64),
    (16500, (-16, -3, 0, 7, 16), 64),
    (20000, (-100, -3, 0, 5, 99), 64),
    (9000, (-1, 0, 1), 8),
    (1_000_000, tuple(range(-16, 17)), 64),
    (1_000_000, tuple(range(-16, 17)), 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64,
                                   torch.complex64])
@pytest.mark.parametrize("n,offsets,tile_s", IL_CASES)
def test_il_kernel_matches_plain(cuda, n, offsets, tile_s, dtype):
    vals, x = band(n, offsets, dtype, seed=7, device=cuda)
    R = ds.il_rows(n, tile_s)
    vals_il = ds.interleave_dia_vals(vals, R)
    x_il = ds.interleave_vec(x, R)
    before = ds.dia_il_kernel.launches
    y = ds.dia_matvec_il(vals_il, offsets, x_il)
    torch.cuda.synchronize()
    assert ds.dia_il_kernel.launches == before + 1
    y_ref = ds.dia_matvec_il_plain(vals_il, offsets, x_il)
    assert rel_err(y, y_ref) <= TOL[dtype]
    # and against the row-major plain version through the codec
    y_nat = ds.dia_matvec_plain(vals, offsets, x)
    assert rel_err(ds.deinterleave_vec(y, n), y_nat) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offsets", [(20000, (-9, 0, 3, 9)),
                                       (1_000_000, tuple(range(-16, 17)))])
def test_il_window_kernel_with_halo_values(cuda, n, offsets, dtype):
    # halo rows carry arbitrary values (a neighbouring shard's entries)
    vals, _ = band(n, offsets, dtype, seed=3, device=cuda)
    R = ds.il_rows(n, 64)
    pr = ds.il_window_halo(offsets)
    vals_il = ds.interleave_dia_vals(vals, R)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.rand((R + 2 * pr, ds.LANES), generator=gen, device=cuda) * 2 - 1
    assert w[:pr].abs().sum() > 0
    y = ds.dia_matvec_il_window(vals_il, offsets, w)
    y_ref = ds.dia_matvec_il_window_plain(vals_il, offsets, w)
    assert rel_err(y, y_ref) <= TOL[dtype]


def test_kernels_reject_what_they_do_not_take(cuda):
    vals, x = band(1000, (-1, 0, 1), torch.float32, seed=0, device=cuda)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        ds.dia_kernel(vals, (-1, 0, 1), x.cpu())
    with pytest.raises(TypeError, match="does not match"):
        ds.dia_kernel(vals, (-1, 0, 1), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ds.dia_kernel(vals.T.contiguous().T, (-1, 0, 1), x)
    with pytest.raises(ValueError, match="3 offsets for 2 diagonals"):
        ds.dia_kernel(vals[:2].contiguous(), (-1, 0, 1), x)
    with pytest.raises(TypeError, match="dia_complex_kernel"):
        ds.dia_kernel(vals.to(torch.complex64), (-1, 0, 1), x.to(torch.complex64))
