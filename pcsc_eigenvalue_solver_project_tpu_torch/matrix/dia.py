"""DIA (diagonal) sparse format for banded operators.

Storing the diagonals densely turns SpMV into shifted multiply-accumulates:
no gathers, unit-stride reads, one pass over the data. On the card the
whole band is one kernel launch (ops/dia_spmv.py, csrc/dia_spmv.cu), and so
is a block of vectors (``InterleavedDIA.matmat``; the block solvers call
``dia_matmat`` on a ``SparseDIA``'s data).

Convention (row-indexed): ``data[d, i] = A[i, i + offsets[d]]`` with zeros
where the index leaves the matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import as_torch_dtype, numpy_dtype
from ..ops.dia_spmv import (DEFAULT_IL_TILE, _shifted, deinterleave_vec,
                            dia_matmat_il, dia_matvec, dia_matvec_il, il_rows,
                            interleave_dia_vals, interleave_vec)
from .protocol import AbstractMatrix
from .sparse import SparseCSR


@dataclasses.dataclass(frozen=True)
class SparseDIA(AbstractMatrix):
    """Banded matrix stored by diagonals."""

    data: torch.Tensor  # (k, n) — data[d, i] = A[i, i + offsets[d]]
    offsets: tuple
    shape: tuple

    @staticmethod
    def from_csr(m: SparseCSR) -> "SparseDIA":
        """Host-side conversion; any (row, col) populates its diagonal."""
        n, nc = m.shape
        if n != nc:
            raise ValueError("SparseDIA.from_csr: matrix must be square")
        rows = m.rows.cpu().numpy()
        cols = m.indices.cpu().numpy()
        vals = m.data.cpu().numpy()
        diffs = cols.astype(np.int64) - rows.astype(np.int64)
        offs = np.unique(diffs)
        data = np.zeros((len(offs), n), dtype=vals.dtype)
        d_ids = np.searchsorted(offs, diffs)
        data[d_ids, rows] = vals
        return SparseDIA(data=torch.from_numpy(data).to(m.device),
                         offsets=tuple(int(o) for o in offs), shape=(n, n))

    @staticmethod
    def from_diagonals(diagonals, offsets, n, dtype=None, device=None) -> "SparseDIA":
        """Build from per-diagonal arrays (row-indexed, length n each) on
        ``device`` (default: the card)."""
        dtype = numpy_dtype(dtype)
        data = np.zeros((len(offsets), n), dtype=dtype)
        for d, diag in enumerate(diagonals):
            data[d] = np.asarray(diag, dtype=dtype)
            off = offsets[d]
            if off > 0:
                data[d, n - off:] = 0
            elif off < 0:
                data[d, :-off] = 0
        return SparseDIA(data=torch.from_numpy(data).to(resolve_device(device)),
                         offsets=tuple(int(o) for o in offsets), shape=(n, n))

    # --- queries ---
    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.data))

    # --- compute ---
    def matvec(self, x):
        return dia_matvec(self.data, self.offsets, x)

    def rmatvec(self, x):
        # A^H: the diagonal at offset o contributes conj(data[o][i]) x[i] to
        # row i + o
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + _shifted(self.data[d].conj() * x, -off)
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)

    def to_dense(self):
        n = self.shape[0]
        out = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        i = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            out.index_put_((i[valid], i[valid] + off), self.data[d][valid],
                           accumulate=True)
        return out

    def as_csr(self):
        raise TypeError("SparseDIA: stored matrix is not sparse CSR (convert explicitly)")

    def adjoint(self) -> "SparseDIA":
        """A^H as a SparseDIA (one-time transform): the diagonal at offset
        ``o`` becomes offset ``-o`` with conjugated values shifted by ``o``."""
        new_offsets = tuple(sorted(-o for o in self.offsets))
        rows = [_shifted(self.data[self.offsets.index(-no)].conj(), no)
                for no in new_offsets]
        data = torch.stack(rows) if rows else self.data.new_zeros((0, self.shape[0]))
        return SparseDIA(data=data, offsets=new_offsets, shape=self.shape)

    def spectral_bound(self):
        """Gershgorin bound on the spectral radius: max_i sum_j |A[i, j]|
        (the induced inf-norm) — deterministic, one pass over diagonals."""
        return torch.max(torch.sum(torch.abs(self.data), dim=0))

    def gershgorin_interval(self):
        """(lo, hi) enclosing the spectrum of a SYMMETRIC operator:
        ``lo = min_i (a_ii - r_i)``, ``hi = max_i (a_ii + r_i)`` with
        ``r_i`` the off-diagonal absolute row sum."""
        diag = torch.real(self.diagonal())
        r = torch.sum(torch.abs(self.data), dim=0) - torch.abs(self.diagonal())
        return torch.min(diag - r), torch.max(diag + r)

    def interleaved(self, tile_s: int | None = None,
                    dtype=None) -> "InterleavedDIA":
        """Convert to the lane-major interleaved layout. ``dtype``
        optionally re-types the stored diagonals (``torch.bfloat16`` halves
        the bytes the SpMV reads; accumulation stays f32)."""
        ts = DEFAULT_IL_TILE if tile_s is None else tile_s
        data = self.data if dtype is None else self.data.to(as_torch_dtype(dtype))
        R = il_rows(self.shape[0], ts)
        return InterleavedDIA(data_il=interleave_dia_vals(data, R),
                              offsets=self.offsets, shape=self.shape,
                              tile_s=ts)


@dataclasses.dataclass(frozen=True)
class InterleavedDIA(AbstractMatrix):
    """Banded matrix in the lane-major interleaved layout.

    ``matvec`` consumes and produces vectors in the SAME layout ((R, 128)
    tensors via ``encode_vec``), so whole solver loops run without any
    layout conversion; norms and inner products are permutation-invariant,
    so the generic solver loops (solvers/power.py) work unchanged. Padding
    positions carry zero diagonal values and therefore stay zero.
    """

    data_il: torch.Tensor  # (k, R, 128)
    offsets: tuple
    shape: tuple
    tile_s: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data_il.dtype

    @property
    def device(self) -> torch.device:
        return self.data_il.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def R(self) -> int:
        return self.data_il.shape[1]

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    # --- layout codec (protocol hooks used by the solvers) ---
    def encode_vec(self, x):
        return interleave_vec(x, self.R)

    def decode_vec(self, x_il):
        return deinterleave_vec(x_il, self.shape[0])

    # --- compute (interleaved domain) ---
    def matvec(self, x_il):
        return dia_matvec_il(self.data_il, self.offsets, x_il)

    def matmat(self, xs_il):
        """Block SpMM in the interleaved domain: (nvec, R, 128) ->
        (nvec, R, 128), B5 on the card."""
        return dia_matmat_il(self.data_il, self.offsets, xs_il)

    def rmatvec(self, x_il):
        # correctness path: transpose via the natural layout; adjoint-heavy
        # algorithms should pre-build ``self.adjoint()`` and call its matvec
        return self.encode_vec(self.to_natural().rmatvec(self.decode_vec(x_il)))

    def adjoint(self) -> "InterleavedDIA":
        """A^H in the interleaved layout (one-time transform)."""
        return self.to_natural().adjoint().interleaved(self.tile_s)

    def spectral_bound(self):
        """Gershgorin bound on the spectral radius (inf-norm)."""
        return torch.max(torch.sum(torch.abs(self.data_il), dim=0))

    def gershgorin_interval(self):
        """(lo, hi) spectrum enclosure for symmetric operators, from the
        natural layout (padding rows would add the point 0)."""
        return self.to_natural().gershgorin_interval()

    def to_natural(self) -> SparseDIA:
        k = self.data_il.shape[0]
        n = self.shape[0]
        data = self.data_il.transpose(1, 2).reshape(k, -1)[:, :n].contiguous()
        return SparseDIA(data=data, offsets=self.offsets, shape=self.shape)

    def diagonal(self):
        return self.to_natural().diagonal()

    def to_dense(self):
        return self.to_natural().to_dense()

    def as_csr(self):
        raise TypeError(
            "InterleavedDIA: stored matrix is not sparse CSR (convert explicitly)")
