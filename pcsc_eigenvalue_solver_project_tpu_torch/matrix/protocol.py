"""The matrix protocol — the port's replacement for ``EigSol::Matrix``.

The reference wraps Eigen matrices in a runtime type-erased ``Matrix`` class
(reference src/matrix/matrix.hpp:36-246). Here the equivalent is a small
protocol shared by plain dataclasses holding tensors: ``shape``, ``dtype``,
``device``, ``is_dense``, ``matvec``. The *behavioral contract* is
preserved, not the mechanism:

- ``scalar_type()`` queries (matrix.hpp:133-135)  -> ``.dtype``
- ``isDense()`` (matrix.hpp:123)                  -> ``.is_dense``
- ``cast<T>()`` throwing ``std::bad_cast`` on the wrong stored kind
  (matrix.hpp:160-183,235-240)                    -> ``.as_dense()`` /
  ``.as_csr()`` raising ``TypeError``.
- construction size mismatch throwing (matrix.hpp:213-215) -> ``ValueError``.
"""

from __future__ import annotations

import dataclasses


class AbstractMatrix:
    """Common interface for the matrix kinds."""

    # Subclasses provide: ``shape`` (tuple), ``dtype`` (torch.dtype),
    # ``device`` (torch.device), ``is_dense`` (bool) — as fields or
    # properties. No stubs are declared here because dataclass subclasses
    # would inherit them as spurious field defaults.

    @property
    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1]

    # --- compute protocol ---
    def matvec(self, x):
        """``A @ x`` — the hot op (power_method.hpp:69)."""
        raise NotImplementedError

    def rmatvec(self, x):
        """``A^H @ x`` (conjugate-transpose matvec)."""
        raise NotImplementedError

    def diagonal(self):
        """The main diagonal as a length-min(m,n) vector."""
        raise NotImplementedError

    def to_dense(self):
        """Materialise as a dense tensor."""
        raise NotImplementedError

    # --- vector-domain codec ---
    # Operators whose fast path uses another vector layout (InterleavedDIA's
    # lane-major (R, 128) tensors) override these; solvers encode the
    # start vector once, iterate entirely in the operator's domain
    # (norms/dots are permutation-invariant), and decode the final
    # eigenvector once.
    def encode_vec(self, x):
        return x

    def decode_vec(self, x):
        return x

    # --- checked access (cast<T>() parity) ---
    def as_dense(self):
        raise TypeError(f"{type(self).__name__}: stored matrix is not dense")

    def as_csr(self):
        raise TypeError(f"{type(self).__name__}: stored matrix is not sparse CSR")


def decode_result(m: AbstractMatrix, result):
    """Decode a solver result's eigenvector from the operator's vector
    domain back to the natural (n,) layout (identity for most kinds)."""
    return dataclasses.replace(result,
                               eigenvector=m.decode_vec(result.eigenvector))


def require_square(m: AbstractMatrix, what: str) -> None:
    """Parity with the 'matrix must be square' guards (power_method.hpp:52-55)."""
    if m.shape[0] != m.shape[1]:
        raise ValueError(f"{what}: matrix must be square")


def require_nonempty(m: AbstractMatrix, what: str) -> None:
    """Parity with the 'matrix has zero size' guards (power_method.hpp:56-58)."""
    if m.shape[0] == 0 or m.shape[1] == 0:
        raise ValueError(f"{what}: matrix has zero size")
