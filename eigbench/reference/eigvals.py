"""All eigenvalues of the matrix the benchmark made, by LAPACK's xGEEV
through NumPy, in float64. The control computes them from the matrix as
its lower precision holds it (TF32: every entry rounded to 10 mantissa
bits, the least that a TF32 product would change)."""

from __future__ import annotations

import numpy as np
import torch

from eigbench.reference import compare
from eigbench.reference import precision as prec


def answer(result) -> dict:
    return {"eigenvalues": result.eigenvalues, "converged": bool(result.converged)}


def solve(apply, raw: torch.Tensor, inputs: dict, mix: dict, n: int, precision: str) -> dict:
    a = prec.operand(raw, precision).to(torch.float64).cpu().numpy()
    return {"eigenvalues": np.linalg.eigvals(a), "converged": True}


def gaps(got: dict, want: dict) -> dict:
    return {"eig_gap": compare.matched_gap(got["eigenvalues"].cpu().numpy(), want["eigenvalues"]),
            "unconverged": 0 if got["converged"] else 1}
