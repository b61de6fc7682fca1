"""The 27-point operator: the program's diagonals, the plain reference and
the closed-form spectrum agree with a dense matrix built point by point."""

import itertools

import numpy as np
import pytest
import torch

from eigbench.builders import stencil27 as builder
from eigbench.reference import stencil27 as reference

CFG = {"grid": 4, "diagonal": 26.0, "neighbour": -1.0, "dtype": "float64"}


def dense_27_point(g: int) -> np.ndarray:
    """HPCG's matrix row by row: 26 on the diagonal, -1 to each neighbour."""
    a = np.zeros((g ** 3, g ** 3))
    for z, y, x in itertools.product(range(g), repeat=3):
        row = (z * g + y) * g + x
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            zz, yy, xx = z + dz, y + dy, x + dx
            if 0 <= zz < g and 0 <= yy < g and 0 <= xx < g:
                a[row, (zz * g + yy) * g + xx] = 26.0 if (dz, dy, dx) == (0, 0, 0) else -1.0
    return a


def test_diagonals_are_the_dense_27_point_matrix():
    g = CFG["grid"]
    n = g ** 3
    data = builder.diagonals(CFG, "cpu").numpy()
    a = np.zeros((n, n))
    for d, off in enumerate(builder.offsets(g)):
        for i in range(n):
            if 0 <= i + off < n:
                a[i, i + off] = data[d, i]
            else:
                assert data[d, i] == 0
    np.testing.assert_array_equal(a, dense_27_point(g))


def test_closed_form_eigenvalues():
    got = np.sort(reference.eigenvalues(CFG))
    want = np.linalg.eigvalsh(dense_27_point(CFG["grid"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_reference_apply_is_the_dense_product():
    x = torch.randn(CFG["grid"] ** 3, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    want = dense_27_point(CFG["grid"]) @ x.numpy()
    np.testing.assert_allclose(reference.apply(x, CFG).numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("g", [6, 7])
def test_program_operator_is_the_reference(g):
    """The interleaved operator the program serves, applied in its own
    layout, equals the plain natural-order operator."""
    cfg = dict(CFG, grid=g, dtype="float32")
    op = builder.operators(cfg, 0, 1, "cpu")[0]
    x = torch.rand(g ** 3, generator=torch.Generator().manual_seed(g)) * 2 - 1
    got = op.decode_vec(op.matvec(op.encode_vec(x)))
    want = reference.apply(x.double(), cfg)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
