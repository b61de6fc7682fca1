"""Relative-tolerance convergence predicate.

Reference parity: ``is_close_relative(a, b, tol)`` returns
``|a - b| <= tol * (1 + |a|)`` (reference src/core/tolerance.hpp:29-33).
The scale term ``1 + |a|`` makes the test relative for large magnitudes and
absolute near zero. ``a`` is the *new* value in all solver call sites
(power_method.hpp:84 calls ``is_close_relative(lambdaNew, lambda, tol)``).

It works on 0-d tensors and returns a 0-d bool tensor, so a solver loop can
keep the decision on the device. Pass ``tol`` as a float64 tensor to decide
in float64 whatever the iterate's dtype, as the JAX package does under x64.
"""

from __future__ import annotations

import torch


def is_close_relative(a, b, tol):
    """True iff ``|a - b| <= tol * (1 + |a|)``. Works for real and complex."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)  # numpy scalars promote as arrays
    diff = torch.abs(a - b)
    scale = 1.0 + torch.abs(a)
    return diff <= tol * scale
