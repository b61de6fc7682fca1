"""pcsc_eigenvalue_solver_project_tpu_torch — the eigensolver on PyTorch and CUDA.

The port of ``pcsc_eigenvalue_solver_project_tpu`` (JAX on a TPU) to
PyTorch on an NVIDIA H100, under the same module tree and public names.
Its ``__all__`` equals the JAX package's as a set: the text reader and
writer (``write_matrix_to_file``); the power-method path on dense, CSR/ELL
and banded (DIA and interleaved DIA) operators, on the split-plane complex
banded operators (``SplitComplexDIA``, ``InterleavedSplitComplexDIA``,
``power_method_split_complex``) and in float64 (``power_method_ds64``);
general unstructured sparse operators (``SparseGELL``,
``SparseCSR.to_gell``) and the automatic layout
(``from_coo(layout="auto")``, ``suggest_layout``, ``PermutedOperator``); the
block top-k solvers ``subspace_iteration``,
``chebyshev_subspace_iteration`` and ``lobpcg_eigenvalues``; the Krylov
solvers ``arnoldi_eigenvalues``, ``krylov_schur_eigenvalues``,
``lanczos_eigenvalues``, ``lanczos_eigenpairs`` and
``lanczos_thick_restart``; the shifted solves (``solve_shifted``,
``shifted_inverse_power_method``, ``rayleigh_quotient_iteration``, with
BiCGStab and GMRES inner solves on the SpMV kernels); and the dense QR
stack (Hessenberg reduction, QR decomposition, QR eigenvalues in parity and
accelerated modes with aggressive early deflation, with eigenvectors). The
demo CLI is ``python -m pcsc_eigenvalue_solver_project_tpu_torch.demo``.
The distributed layer (``parallel/``: row-partitioned ELL, DIA, interleaved
DIA, split-plane and general sparse operators and the power, Krylov, block
and shifted solvers on them, over ``torch.distributed`` process groups, one
process per rank; ``io/distributed.py``) and checkpointed power runs
(``utils/checkpoint.py``) are in their modules, outside ``__all__`` as in
the JAX package. The banded and general sparse SpMV, the block SpMM and
the QR stack run as CUDA kernels written for Hopper (``csrc/``), built with
nvcc at the first CUDA launch. Constructors put their data on the card
unless given ``device`` (``device="cpu"`` for the CPU); on CPU tensors every
operation runs its plain PyTorch version.

Typical usage::

    import torch
    import pcsc_eigenvalue_solver_project_tpu_torch as eigsol

    A = eigsol.read_matrix_from_file("data/A.txt", dtype=torch.complex128)
    res = eigsol.power_method(A, eigsol.SolverOptions(tolerance=1e-8))
    print(res.eigenvalue, int(res.iterations), bool(res.converged))
    qr = eigsol.qr_eigenvalues(A, eigsol.QROptions(mode="accelerated"))
"""

from .core.options import QROptions, ShiftedSolverOptions, SolverOptions
from .core.results import EigenResult, QRResult
from .core.tolerance import is_close_relative
from .matrix.auto import LayoutDecision, PermutedOperator, from_coo, suggest_layout
from .matrix.dense import DenseMatrix
from .matrix.dia import InterleavedDIA, SparseDIA
from .matrix.gell import SparseGELL
from .matrix.protocol import AbstractMatrix
from .matrix.sparse import SparseCSR, SparseELL
from .matrix.split_complex import InterleavedSplitComplexDIA, SplitComplexDIA
from .io.reader import read_matrix_from_file, read_matrix_from_text
from .io.writer import write_matrix_to_file
from .solvers.arnoldi import arnoldi_eigenvalues, krylov_schur_eigenvalues
from .solvers.hessenberg import to_hessenberg
from .solvers.inverse_power import rayleigh_quotient_iteration, shifted_inverse_power_method
from .solvers.lanczos import lanczos_eigenpairs, lanczos_eigenvalues, lanczos_thick_restart
from .solvers.lobpcg import lobpcg_eigenvalues
from .solvers.power import power_method, power_method_ds64, power_method_split_complex
from .solvers.qr import qr_decompose
from .solvers.qr_eigenvalues import qr_eigenvalues
from .solvers.solve_shifted import solve_shifted
from .solvers.subspace import chebyshev_subspace_iteration, subspace_iteration

__version__ = "0.1.0"

__all__ = [
    "AbstractMatrix",
    "DenseMatrix",
    "EigenResult",
    "InterleavedDIA",
    "InterleavedSplitComplexDIA",
    "LayoutDecision",
    "PermutedOperator",
    "QROptions",
    "QRResult",
    "ShiftedSolverOptions",
    "SolverOptions",
    "SparseCSR",
    "SparseDIA",
    "SparseELL",
    "SparseGELL",
    "SplitComplexDIA",
    "arnoldi_eigenvalues",
    "chebyshev_subspace_iteration",
    "from_coo",
    "is_close_relative",
    "krylov_schur_eigenvalues",
    "lanczos_eigenpairs",
    "lanczos_eigenvalues",
    "lanczos_thick_restart",
    "lobpcg_eigenvalues",
    "power_method",
    "power_method_ds64",
    "power_method_split_complex",
    "qr_decompose",
    "qr_eigenvalues",
    "rayleigh_quotient_iteration",
    "read_matrix_from_file",
    "read_matrix_from_text",
    "shifted_inverse_power_method",
    "solve_shifted",
    "suggest_layout",
    "subspace_iteration",
    "to_hessenberg",
    "write_matrix_to_file",
]
