"""Split-plane complex arithmetic: complex numbers as (2, ...) real tensors.

The port's own copy of the JAX package's ``ops/split_complex.py``. Re/im
planes ride on axis 0 of a real tensor::

    vector  z  -> (2, n)    scalars -> (2,)    diagonals -> (2, k, n)

The card has complex dtypes; the planes exist because ``SplitComplexDIA``
and ``InterleavedSplitComplexDIA`` are public operators whose vectors are
planes. Host conversion helpers plus the algebra the solver loops need
(conjugating dot, norm, divide-by-scalar, relative-tolerance check).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.interop import to_tensor


def to_planes(z, device=None) -> torch.Tensor:
    """Complex (or real) array-like -> (2, ...) real planes, float32 for
    complex64/float32 input and float64 otherwise, on ``device``. Without
    ``device`` a tensor keeps its device and a host array goes to the card,
    as a constructor's data does (``core/device.py``)."""
    if not isinstance(z, torch.Tensor):
        device = resolve_device(device)
    t = to_tensor(z, device=device)
    rdt = torch.float32 if t.dtype in (torch.complex64, torch.float32) else torch.float64
    if not t.is_complex():
        t = t.to(torch.complex128)
    return torch.stack([t.real.to(rdt), t.imag.to(rdt)])


def from_planes(p) -> np.ndarray:
    """Planes -> host complex numpy array (complex64 for float32 planes)."""
    p = p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    cdt = np.complex64 if p.dtype == np.float32 else np.complex128
    return (p[0] + 1j * p[1]).astype(cdt)


def splitc_mul(a, b):
    """(2, ...) * (2, ...) complex multiply."""
    return torch.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def splitc_vdot(a, b):
    """sum(conj(a) * b) over all trailing axes -> (2,) scalar planes."""
    re = torch.sum(a[0] * b[0] + a[1] * b[1])
    im = torch.sum(a[0] * b[1] - a[1] * b[0])
    return torch.stack([re, im])


def splitc_norm(a):
    """Real 2-norm of a split-complex vector."""
    return torch.sqrt(torch.sum(a[0] * a[0] + a[1] * a[1]))


def splitc_abs(s):
    """|s| for a (2,) scalar."""
    return torch.sqrt(s[0] * s[0] + s[1] * s[1])


def splitc_scale(a, s_real):
    """Multiply planes by a real scalar."""
    return a * s_real


def splitc_div_scalar(a, s):
    """a / s for (2, n) planes and a (2,) scalar."""
    denom = s[0] * s[0] + s[1] * s[1]
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    re = (a[0] * s[0] + a[1] * s[1]) / safe
    im = (a[1] * s[0] - a[0] * s[1]) / safe
    return torch.stack([re, im])


def splitc_is_close_relative(a, b, tol):
    """Reference stopping rule |a-b| <= tol*(1+|a|) on (2,) scalars
    (tolerance.hpp:29-33)."""
    diff = splitc_abs(a - b)
    return diff <= tol * (1.0 + splitc_abs(a))
