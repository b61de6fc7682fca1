"""The plain m-step Arnoldi projection with modified Gram-Schmidt.

``V[0] = x / ||x||``; step j: ``w = A V[j]``, ``h_ij = V[i] . w`` and
``w -= h_ij V[i]`` for i = 0..j in turn, ``H[j+1, j] = ||w||``,
``V[j+1] = w / ||w||``. The k Ritz values of largest modulus are the
eigenvalues of ``H[:m, :m]``, solved in float64 by NumPy."""

from __future__ import annotations

import numpy as np
import torch

from eigbench.reference import compare
from eigbench.reference import precision as prec


def answer(result) -> dict:
    return {"eigenvalues": result.eigenvalues}


def solve(apply, raw, inputs: dict, mix: dict, n: int, precision: str) -> dict:
    k, m = mix["kwargs"]["k"], min(mix["kwargs"]["m"], n)
    x = prec.operand(inputs["x0"], precision)
    V = torch.empty((m + 1, n), dtype=x.dtype, device=x.device)
    H = torch.zeros((m + 1, m), dtype=x.dtype, device=x.device)
    V[0] = x / torch.linalg.vector_norm(x)
    for j in range(m):
        w = apply(V[j])
        for i in range(j + 1):
            H[i, j] = torch.dot(V[i], w)
            w = w - H[i, j] * V[i]
        H[j + 1, j] = torch.linalg.vector_norm(w)
        V[j + 1] = w / H[j + 1, j]
    ritz = np.linalg.eigvals(H[:m, :m].to(torch.float64).cpu().numpy())
    return {"eigenvalues": ritz[np.argsort(-np.abs(ritz), kind="stable")][:k]}


def gaps(got: dict, want: dict) -> dict:
    return {"ritz_gap": compare.matched_gap(got["eigenvalues"].cpu().numpy(), want["eigenvalues"])}
