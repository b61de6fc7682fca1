"""Synthetic matrix generators — the framework's "model zoo".

The reference ships only two tiny data files (data/A.txt, data/B.txt);
its tests build <=3x3 matrices inline. The benchmark configs in
BASELINE.json need 100K-row and 1M-row sparse operators and 512x512 dense
ones, so generation is a first-class component here. All generators build
on the host with NumPy, deterministic in ``seed`` (the same numbers as the
JAX package's generators), and place the result on ``device`` (default:
the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import numpy_dtype
from ..matrix.dense import DenseMatrix
from ..matrix.dia import SparseDIA
from ..matrix.sparse import SparseCSR


def dense_random(n: int, *, dtype=np.float64, seed: int = 0,
                 scale: float = 1.0, device=None) -> DenseMatrix:
    """Uniform [-1,1) dense matrix (complex dtypes get re+im parts)."""
    rng = np.random.default_rng(seed)
    dt = numpy_dtype(dtype)
    if dt.kind == "c":
        a = (rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n)))
    else:
        a = rng.uniform(-1, 1, (n, n))
    return DenseMatrix.from_array(scale * a.astype(dt), dtype=dt, device=resolve_device(device))


def dense_diagonal(diag, *, dtype=np.float64, device=None) -> DenseMatrix:
    """The diagonal matrix of ``diag``."""
    dt = numpy_dtype(dtype)
    return DenseMatrix.from_array(np.diag(np.asarray(diag, dtype=dt)), dtype=dt,
                                  device=resolve_device(device))


def laplacian_1d(n: int, *, dtype=np.float64, device=None) -> SparseCSR:
    """Tridiagonal [-1, 2, -1] operator — the classic banded test matrix
    with known spectrum ``2 - 2 cos(k pi / (n+1))``."""
    dt = numpy_dtype(dtype)
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[:-1] + 1, i[1:] - 1])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)]).astype(dt)
    return SparseCSR.from_coo(rows, cols, vals, (n, n), dtype=dt, device=resolve_device(device))


def laplacian_2d(side: int, *, dtype=np.float64, device=None) -> SparseCSR:
    """5-point stencil on a side x side grid (n = side^2 rows)."""
    dt = numpy_dtype(dtype)
    n = side * side
    idx = np.arange(n)
    r, c, v = [idx], [idx], [np.full(n, 4.0)]
    gx, gy = idx // side, idx % side
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nx, ny = gx + dx, gy + dy
        ok = (nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)
        r.append(idx[ok])
        c.append((nx * side + ny)[ok])
        v.append(np.full(ok.sum(), -1.0))
    return SparseCSR.from_coo(np.concatenate(r), np.concatenate(c),
                              np.concatenate(v).astype(dt), (n, n), dtype=dt,
                              device=resolve_device(device))


def banded_random(n: int, *, bandwidth: int = 8, nnz_per_row: int = 8,
                  dtype=np.float64, seed: int = 0, diag_boost: float = 0.0,
                  device=None) -> SparseCSR:
    """Random banded matrix: ``nnz_per_row`` entries per row, column offsets
    within ``[-bandwidth, bandwidth]``. ``diag_boost`` adds to the diagonal
    (diagonal dominance for Krylov).
    """
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), nnz_per_row)
    off = rng.integers(-bandwidth, bandwidth + 1, size=n * nnz_per_row)
    j = np.clip(i + off, 0, n - 1)
    dt = numpy_dtype(dtype)
    if dt.kind == "c":
        v = rng.uniform(-1, 1, n * nnz_per_row) + 1j * rng.uniform(-1, 1, n * nnz_per_row)
    else:
        v = rng.uniform(-1, 1, n * nnz_per_row)
    if diag_boost:
        i = np.concatenate([i, np.arange(n)])
        j = np.concatenate([j, np.arange(n)])
        v = np.concatenate([v, np.full(n, diag_boost)])
    return SparseCSR.from_coo(i, j, v.astype(dt), (n, n), dtype=dt, device=resolve_device(device))


def banded_full(n: int, *, bandwidth: int = 16, dtype=np.float32,
                seed: int = 0, diag_boost: float = 0.0,
                device=None) -> SparseDIA:
    """Fully-populated band (every diagonal in [-bandwidth, bandwidth]) as a
    ``SparseDIA`` operator — the DIA-kernel bench workload where stored
    elements == nnz, so the nnz/s metric is honest."""
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-bandwidth, bandwidth + 1))
    k = len(offsets)
    dt = numpy_dtype(dtype)
    if dt.kind == "c":
        data = (rng.uniform(-1, 1, (k, n)) + 1j * rng.uniform(-1, 1, (k, n))).astype(dt)
    else:
        data = rng.uniform(-1, 1, (k, n)).astype(dt)
    if diag_boost:
        data[bandwidth] += diag_boost
    # zero out-of-matrix tails per convention
    for d, off in enumerate(offsets):
        if off > 0:
            data[d, n - off:] = 0
        elif off < 0:
            data[d, :-off] = 0
    return SparseDIA(data=torch.from_numpy(data).to(resolve_device(device)), offsets=offsets,
                     shape=(n, n))


def spd_tridiagonal_spectrum(n: int) -> np.ndarray:
    """Analytic eigenvalues of ``laplacian_1d(n)``."""
    k = np.arange(1, n + 1)
    return 2.0 - 2.0 * np.cos(k * np.pi / (n + 1))
