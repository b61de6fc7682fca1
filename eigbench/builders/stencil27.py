"""HPCG's 27-point operator (``GenerateProblem_ref.cpp``) on a g x g x g grid,
as the program serves it: ``SparseDIA(...).interleaved()``, the layout B1
reads.

Row ``i`` is the grid point ``(z, y, x) = (i // g^2, (i // g) % g, i % g)``;
diagonal ``d`` has the offset ``dz g^2 + dy g + dx`` and holds ``neighbour``
where that neighbour lies inside the grid and 0 where it does not, the
centre ``diagonal``. The operator is deterministic: the seed makes only the
start vectors. The diagonals are made on the device in a few large calls;
``SparseDIA.from_diagonals`` would build them on the host."""

from __future__ import annotations

import torch

STEPS = (-1, 0, 1)


def size(cfg: dict) -> int:
    return cfg["grid"] ** 3


def offsets(g: int) -> tuple:
    return tuple(dz * g * g + dy * g + dx for dz in STEPS for dy in STEPS for dx in STEPS)


def diagonals(cfg: dict, device) -> torch.Tensor:
    """The (27, n) row-indexed diagonals, ``data[d, i] = A[i, i + offsets[d]]``."""
    g = cfg["grid"]
    coord = torch.arange(g, device=device)
    # inside[s, c]: coordinate c moved by STEPS[s] stays on the grid
    inside = torch.stack([(coord + s >= 0) & (coord + s < g) for s in STEPS])
    mask = (inside[:, None, None, :, None, None]
            & inside[None, :, None, None, :, None]
            & inside[None, None, :, None, None, :])  # (dz, dy, dx, z, y, x)
    data = mask.reshape(27, g ** 3).to(getattr(torch, cfg["dtype"])).mul_(cfg["neighbour"])
    data[13] = cfg["diagonal"]  # (dz, dy, dx) = (0, 0, 0)
    return data


def operators(cfg: dict, seed: int, count: int, device) -> list:
    from pcsc_eigenvalue_solver_project_tpu_torch import SparseDIA
    n = size(cfg)
    natural = SparseDIA(data=diagonals(cfg, device), offsets=offsets(cfg["grid"]), shape=(n, n))
    return [natural.interleaved()]


def raw(cfg: dict, seed: int, index: int, device):
    """The reference builds its own operator from the configuration."""
    return None
