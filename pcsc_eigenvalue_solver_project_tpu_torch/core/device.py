"""Where the port's constructors put their tensors.

The port runs on the card: a constructor called without ``device`` places
its data on the current CUDA device, and a caller that wants the CPU asks
for it (``device="cpu"``, as the CPU tests do). There is no test for a card
and no fallback: on a machine without one, torch's own error says so.
Conversions (``SparseDIA.from_csr``, ``.interleaved()``) and the solvers
follow their operand's device instead.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device("cuda")`` when ``device`` is None, else
    ``torch.device(device)``."""
    return torch.device("cuda" if device is None else device)
