"""Dense matrix type.

Replaces the dense arm of ``EigSol::Matrix`` (``Matrix::Dense<Scalar>``;
reference src/matrix/matrix.hpp:39-44,70-76). Construction paths mirror the
reference:

- from any 2-D array (matrix.hpp:70-76),
- from a flat row-major sequence plus (rows, cols) with a size-mismatch
  ``ValueError`` (matrix.hpp:109-116, throw at 213-215).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import canonical_dtype
from ..ops.matvec import dense_matvec, dense_rmatvec
from ..utils.interop import to_tensor
from .protocol import AbstractMatrix


@dataclasses.dataclass(frozen=True)
class DenseMatrix(AbstractMatrix):
    """A dense matrix backed by a single 2-D tensor."""

    array: torch.Tensor

    def __post_init__(self):
        if self.array.ndim != 2:
            raise ValueError(f"DenseMatrix: expected a 2-D array, got ndim={self.array.ndim}")

    # --- constructors ---
    @staticmethod
    def from_array(a, dtype=None, device=None) -> "DenseMatrix":
        """A copy of the 2-D array-like ``a`` on ``device`` (default: the card)."""
        if dtype is not None:
            dtype = canonical_dtype(dtype)
        arr = to_tensor(a, dtype=dtype, device=resolve_device(device))
        if arr.ndim != 2:
            raise ValueError(f"DenseMatrix: expected a 2-D array, got ndim={arr.ndim}")
        canonical_dtype(arr.dtype)
        return DenseMatrix(arr)

    @staticmethod
    def from_flat(values, rows: int, cols: int, dtype=None, device=None) -> "DenseMatrix":
        """Row-major flat construction; size mismatch raises (matrix.hpp:213-215)."""
        vals = np.asarray(values)
        if vals.size != rows * cols:
            raise ValueError(
                f"DenseMatrix: data size ({vals.size}) does not match "
                f"rows*cols ({rows}*{cols}={rows * cols})")
        return DenseMatrix.from_array(vals.reshape(rows, cols), dtype=dtype,
                                      device=resolve_device(device))

    # --- queries ---
    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.array.dtype

    @property
    def device(self) -> torch.device:
        return self.array.device

    @property
    def is_dense(self) -> bool:
        return True

    # --- compute ---
    def matvec(self, x):
        return dense_matvec(self.array, x)

    def rmatvec(self, x):
        return dense_rmatvec(self.array, x)

    def diagonal(self):
        return torch.diagonal(self.array)

    def to_dense(self):
        return self.array

    # --- checked access ---
    def as_dense(self):
        return self.array
