"""The plain dense operator: the matrix the benchmark made, as it is."""

from __future__ import annotations

import torch


def apply(x: torch.Tensor, cfg: dict, raw: torch.Tensor) -> torch.Tensor:
    return raw.to(x.dtype) @ x
