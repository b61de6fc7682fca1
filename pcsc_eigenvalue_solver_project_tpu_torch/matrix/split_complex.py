"""Split-plane complex banded operators.

The port of the JAX package's ``matrix/split_complex.py``: a complex banded
matrix stored as real re/im diagonal planes ``(2, k, n)`` whose vectors are
``(2, n)`` real tensors. The JAX package has them because its TPU has no
complex dtypes; the card has, but the operators are public names, and the
bench's complex leg stores its planes in bf16, which no complex dtype can.
``matvec`` runs the split-plane kernels (``ops/dia_spmv.py``: B3's planes
entry row-major, B4 interleaved), and ``solvers.power.power_method``
routes these operators to the plane loop ``power_method_split_complex``.
Tensors stay on the device of the operand they were built from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dtypes import as_torch_dtype
from ..ops.dia_spmv import (DEFAULT_IL_TILE, deinterleave_vec, dia_matvec_il_planes,
                            dia_matvec_planes, il_rows, interleave_dia_vals,
                            interleave_vec)
from .dia import SparseDIA


def _dense_complex(planes: torch.Tensor, offsets, n: int) -> np.ndarray:
    """Host-side dense complex128 matrix of (2, k, n) diagonal planes."""
    p = planes.detach().cpu().to(torch.float64).numpy()
    out = np.zeros((n, n), np.complex128)
    i = np.arange(n)
    for d, off in enumerate(offsets):
        valid = (i + off >= 0) & (i + off < n)
        out[i[valid], i[valid] + off] = p[0, d, valid] + 1j * p[1, d, valid]
    return out


@dataclasses.dataclass(frozen=True)
class SplitComplexDIA:
    """Complex banded matrix as real diagonal planes (2, k, n)."""

    planes: torch.Tensor  # (2, k, n) real
    offsets: tuple
    shape: tuple

    @staticmethod
    def from_complex_dia(m: SparseDIA, *, precision=np.float32) -> "SplitComplexDIA":
        """The planes of ``m``'s diagonals in ``precision`` (float32, float64
        or bfloat16), on ``m``'s device."""
        data = m.data if m.data.is_complex() else m.data.to(torch.complex128)
        planes = torch.stack([data.real, data.imag]).to(as_torch_dtype(precision))
        return SplitComplexDIA(planes=planes.contiguous(), offsets=m.offsets, shape=m.shape)

    @staticmethod
    def from_csr(m, *, precision=np.float32) -> "SplitComplexDIA":
        return SplitComplexDIA.from_complex_dia(SparseDIA.from_csr(m), precision=precision)

    @property
    def dtype(self) -> torch.dtype:
        return self.planes.dtype

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero((self.planes[0] != 0) | (self.planes[1] != 0)))

    def matvec(self, x_planes):
        """(2, n) real planes -> (2, n) real planes."""
        return dia_matvec_planes(self.planes, self.offsets, x_planes)

    def diagonal_planes(self):
        """Main diagonal as (2, n) planes (zeros if the offset is absent)."""
        if 0 in self.offsets:
            return self.planes[:, self.offsets.index(0), :]
        return torch.zeros((2, self.shape[0]), dtype=self.dtype, device=self.device)

    def to_dense_planes(self):
        """Dense materialisation as (2, n, n) re/im planes."""
        n = self.shape[0]
        out = torch.zeros((2, n, n), dtype=self.dtype, device=self.device)
        i = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            valid = (i + off >= 0) & (i + off < n)
            rows = i[valid]
            out[:, rows, rows + off] += self.planes[:, d, valid]
        return out

    # identity codec (protocol symmetry with the interleaved variant)
    def encode_vec(self, x_planes):
        return x_planes

    def decode_vec(self, x_planes):
        return x_planes

    def interleaved(self, tile_s: int | None = None) -> "InterleavedSplitComplexDIA":
        """The lane-major layout of each plane (``SparseDIA.interleaved``)."""
        ts = DEFAULT_IL_TILE if tile_s is None else tile_s
        R = il_rows(self.shape[0], ts)
        planes_il = torch.stack([interleave_dia_vals(p, R) for p in self.planes])
        return InterleavedSplitComplexDIA(planes_il=planes_il, offsets=self.offsets,
                                          shape=self.shape, tile_s=ts)

    def to_complex_dense(self) -> np.ndarray:
        """Host-side dense complex materialisation (tests/oracles)."""
        return _dense_complex(self.planes, self.offsets, self.shape[0])


@dataclasses.dataclass(frozen=True)
class InterleavedSplitComplexDIA:
    """Split-plane complex banded matrix in the lane-major interleaved
    layout: planes (2, k, R, 128); vectors are (2, R, 128) plane tensors.
    The split-complex power loop iterates entirely in this domain: its
    reductions are permutation-invariant."""

    planes_il: torch.Tensor  # (2, k, R, 128) real
    offsets: tuple
    shape: tuple
    tile_s: int

    @property
    def dtype(self) -> torch.dtype:
        return self.planes_il.dtype

    @property
    def device(self) -> torch.device:
        return self.planes_il.device

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def R(self) -> int:
        return self.planes_il.shape[2]

    def encode_vec(self, x_planes):
        """(2, n) plane vector -> (2, R, 128)."""
        return torch.stack([interleave_vec(v, self.R) for v in x_planes])

    def decode_vec(self, x_il_planes):
        """(2, R, 128) -> (2, n) natural planes."""
        return torch.stack([deinterleave_vec(v, self.shape[0]) for v in x_il_planes])

    def matvec(self, x_il_planes):
        return dia_matvec_il_planes(self.planes_il, self.offsets, x_il_planes)

    def to_natural(self) -> SplitComplexDIA:
        _, k, R, L = self.planes_il.shape
        n = self.shape[0]
        planes = self.planes_il.transpose(2, 3).reshape(2, k, R * L)[:, :, :n].contiguous()
        return SplitComplexDIA(planes=planes, offsets=self.offsets, shape=self.shape)

    def diagonal_planes(self):
        """Main diagonal as NATURAL (2, n) planes (encode for the solver
        domain with ``encode_vec``)."""
        if 0 in self.offsets:
            return self.decode_vec(self.planes_il[:, self.offsets.index(0)])
        return torch.zeros((2, self.shape[0]), dtype=self.dtype, device=self.device)

    def to_complex_dense(self) -> np.ndarray:
        return self.to_natural().to_complex_dense()
