"""Dense square matrices with i.i.d. uniform(low, high) entries, LAPACK's
xGEEV random test matrices (DLARND distribution 2 for (-1, 1)), made on the
device from ``(seed, index)`` and served as ``DenseMatrix``."""

from __future__ import annotations

import torch

from eigbench import traffic


def size(cfg: dict) -> int:
    return cfg["n"]


def matrix(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    n = cfg["n"]
    gen = traffic.generator(seed, traffic.OPERATOR, index, device)
    return traffic.uniform((n, n), cfg["low"], cfg["high"], getattr(torch, cfg["dtype"]), gen)


def operators(cfg: dict, seed: int, count: int, device) -> list:
    from pcsc_eigenvalue_solver_project_tpu_torch import DenseMatrix
    return [DenseMatrix(matrix(cfg, seed, i, device)) for i in range(count)]


def raw(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """The same matrix, made again from the seed for the reference."""
    return matrix(cfg, seed, index, device)
