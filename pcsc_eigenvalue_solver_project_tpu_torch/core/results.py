"""Solver results.

Reference parity: ``EigenResult`` (eigenvalue, normalized eigenvector,
iterations, converged; reference src/result/eigen_result.hpp:22-52).
The ``iterations`` and ``converged`` fields are the reference's entire
observability contract and are preserved exactly, including its quirk that
power-family solvers report k+1 at the breaking iteration
(power_method.hpp:87,95). ``QRResult`` (qr_result.hpp:23-44) keeps the QR
solver's quirk of ``max_iterations + 1`` on non-convergence. Fields are
tensors on the solver's device until the caller reads them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EigenResult:
    """Result of single-eigenpair solvers (power method)."""

    eigenvalue: torch.Tensor   # 0-d
    eigenvector: torch.Tensor
    iterations: torch.Tensor   # 0-d int32
    converged: torch.Tensor    # 0-d bool

    def item_iterations(self) -> int:
        return int(self.iterations)

    def item_converged(self) -> bool:
        return bool(self.converged)

    def __repr__(self):
        lam = self.eigenvalue
        lam = complex(lam[0], lam[1]) if lam.ndim == 1 else complex(lam)  # (2,) planes
        return (f"EigenResult(eigenvalue={lam}, "
                f"iterations={int(self.iterations)}, converged={bool(self.converged)})")


@dataclasses.dataclass
class QRResult:
    """Result of QR-based eigenvalue solvers (reference
    src/result/qr_result.hpp:23-44): all eigenvalues, the iteration count
    (``max_iterations + 1`` when the parity iteration never converges,
    qr_eigenvalues.hpp:69,104) and the flag. ``eigenvectors`` (n x n,
    unit columns, column k paired with ``eigenvalues[k]``) is set only by
    ``QROptions(mode="accelerated", compute_vectors=True)``; the reference's
    QRResult carries none."""

    eigenvalues: torch.Tensor  # (n,)
    iterations: torch.Tensor   # 0-d int32
    converged: torch.Tensor    # 0-d bool
    eigenvectors: object = None

    def __repr__(self):
        return (f"QRResult(n={self.eigenvalues.shape[0]}, "
                f"iterations={int(self.iterations)}, converged={bool(self.converged)})")
