"""The precisions a reference or a control computes in."""

from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even:
    what a TF32 tensor-core product reads of its float32 operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    keep = bits + (0xFFF + ((bits >> 13) & 1))
    return (keep & ~0x1FFF).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a reference computing in ``precision`` holds it."""
    if precision == "tf32":
        return round_tf32(x)
    return x.to(DTYPES[precision])
