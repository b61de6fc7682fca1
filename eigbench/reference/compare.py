"""Distances between a program's answer and the reference's."""

from __future__ import annotations

import numpy as np


def matched_gap(got, want) -> float:
    """The widest gap between two sets of eigenvalues paired one to one
    (the pairing of least total distance), over the largest reference
    modulus. Sets of different sizes, or non-finite values, read inf."""
    got = np.asarray(got, dtype=np.complex128).reshape(-1)
    want = np.asarray(want, dtype=np.complex128).reshape(-1)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    from scipy.optimize import linear_sum_assignment
    cost = np.abs(got[:, None] - want[None, :])
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].max() / np.abs(want).max())
