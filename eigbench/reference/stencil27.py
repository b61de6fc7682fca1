"""The plain 27-point operator, in natural (z, y, x) order, on the grid itself.

``A = (diagonal - neighbour) I + neighbour S`` where ``S = T (x) T (x) T``
sums the 3 x 3 x 3 neighbourhood of each point (zero beyond the grid) and
``T`` is tridiag(1, 1, 1). So ``A x`` is three passes of neighbour sums, one
per axis, and no stored diagonal. The eigenvalues follow from ``T``'s:
``(diagonal - neighbour) + neighbour prod_d (1 + 2 cos(k_d pi / (g + 1)))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def apply(x: torch.Tensor, cfg: dict, raw=None) -> torch.Tensor:
    """``A x`` for an (n,) vector, computed in x's dtype."""
    g = cfg["grid"]
    v = x.reshape(g, g, g)
    s = v
    for axis in range(3):
        t = s.clone()
        t.narrow(axis, 1, g - 1).add_(s.narrow(axis, 0, g - 1))
        t.narrow(axis, 0, g - 1).add_(s.narrow(axis, 1, g - 1))
        s = t
    y = s.mul_(cfg["neighbour"]).add_(v, alpha=cfg["diagonal"] - cfg["neighbour"])
    return y.reshape(-1)


def eigenvalues(cfg: dict) -> np.ndarray:
    """All n eigenvalues, from the closed form."""
    g = cfg["grid"]
    t = 1 + 2 * np.cos(np.arange(1, g + 1) * math.pi / (g + 1))
    prod = (t[:, None, None] * t[None, :, None] * t[None, None, :]).reshape(-1)
    return (cfg["diagonal"] - cfg["neighbour"]) + cfg["neighbour"] * prod
