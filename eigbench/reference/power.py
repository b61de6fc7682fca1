"""The plain power iteration (reference power_method.hpp:47-148).

From the unit start vector ``x``: ``z = A x``, then each iteration
``x = z / ||z||``, ``z = A x``, ``lambda = x . z``, stopping when
``|lambda_k - lambda_{k-1}| <= tol (1 + |lambda_k|)`` from the second
iteration on, or after ``max_iterations``; ``iterations`` counts the
iterations run."""

from __future__ import annotations

import torch

from eigbench.reference import precision as prec


def answer(result) -> dict:
    return {"eigenvalue": result.eigenvalue, "eigenvector": result.eigenvector,
            "iterations": int(result.iterations)}


def solve(apply, raw, inputs: dict, mix: dict, n: int, precision: str) -> dict:
    opts = mix["options"]
    max_it, tol = opts["max_iterations"], opts["tolerance"]
    x = prec.operand(inputs["x0"], precision)
    x = x / torch.linalg.vector_norm(x)
    z = apply(x)
    lam, iterations = None, 0
    for k in range(max_it):
        x = z / torch.linalg.vector_norm(z)
        z = apply(x)
        lam_new = float(torch.dot(x, z))
        iterations = k + 1
        stop = lam is not None and abs(lam_new - lam) <= tol * (1 + abs(lam_new))
        lam = lam_new
        if stop:
            break
    return {"eigenvalue": lam, "eigenvector": x, "iterations": iterations}


def gaps(got: dict, want: dict) -> dict:
    lam, lam_ref = float(got["eigenvalue"]), float(want["eigenvalue"])
    x = got["eigenvector"].to(torch.float64)
    x_ref = want["eigenvector"].to(device=x.device, dtype=torch.float64)
    return {"eig_gap": abs(lam - lam_ref) / abs(lam_ref),
            "vec_gap": float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref)),
            "iterations_gap": abs(got["iterations"] - want["iterations"])}
