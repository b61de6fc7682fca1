"""The plain adjacency operator of the simple undirected graph that the
builder made: ``A[r, c] = 1`` at each stored entry ``(r, c)`` of ``raw``
(``builders/graph500.py``), so ``y = A x`` is ``x[c]`` summed into
``y[r]``, computed in x's dtype by ``index_select`` and ``index_add_``,
``BLOCK`` entries at a time (2 GB of gathered float64 a step)."""

from __future__ import annotations

import torch

BLOCK = 1 << 28


def apply(x: torch.Tensor, cfg: dict, raw) -> torch.Tensor:
    """``A x`` for an (n,) vector, in x's dtype."""
    row, col = raw
    y = torch.zeros_like(x)
    for s in range(0, row.numel(), BLOCK):
        y.index_add_(0, row[s:s + BLOCK], x.index_select(0, col[s:s + BLOCK]))
    return y
