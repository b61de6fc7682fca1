"""The port's form of the JAX package's device ``lax.while_loop``.

A loop body runs eagerly on device tensors, in blocks of iterations. Its
carry starts with the 0-d iteration count ``k`` and the 0-d ``done`` flag,
and the body masks every update by ``~done`` (``torch.where``), so the
iterations that run inside a block after ``done`` change nothing. The host
reads ``(k, done)`` once a block, not once an iteration, and the result is
the while-loop's exactly. The power loops and the shifted inverse power
loops run so; BiCGStab in shorter blocks (``parallel/krylov.py``), GMRES
reading once a restart (``block=1``).
"""

from __future__ import annotations

import torch

from .timing import annotate, host_read, host_write

# Iterations between two host reads of the flags.
BLOCK_ITERATIONS = 32


def host_flags(k: torch.Tensor, done: torch.Tensor):
    """``(int(k), bool(done))`` in one read from the device."""
    k_host, done_host = host_read(torch.stack([k.to(torch.int64), done.to(torch.int64)]))
    return k_host, bool(done_host)


def run_masked(step, carry, limit: int, block: int = BLOCK_ITERATIONS, *, span: str):
    """Apply ``step`` to ``carry = (k, done, ...)`` until ``done`` or
    ``k == limit``, reading the two flags once every ``block`` steps. Each
    read and the block it lets run are one span, the caller's ``span``
    (``eigsol.power.block`` for the power loops)."""
    while True:
        with annotate(span):
            k, done = host_flags(carry[0], carry[1])
            if done or k >= limit:
                return carry
            for _ in range(min(block, limit - k)):
                carry = step(carry)


def count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def flag(value, device) -> torch.Tensor:
    """A 0-d bool tensor (``value`` a bool or a 0-d tensor)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.bool).reshape(())
    return host_write(bool(value), device, torch.bool)
