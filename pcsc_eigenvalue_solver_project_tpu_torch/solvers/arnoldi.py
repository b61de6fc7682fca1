"""Arnoldi factorisation (the port of one function of the JAX package's
``solvers/arnoldi.py``).

``arnoldi_decomposition`` builds the Krylov factorisation the restarted
GMRES of ``parallel/krylov.py`` solves its small least squares on. The
eigenvalue solvers of that module (``arnoldi_eigenvalues``,
``krylov_schur_eigenvalues``) are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.dtypes import real_dtype_of
from .power import norm as _norm
from .power import vdot as _vdot


def arnoldi_decomposition(matvec, x0: torch.Tensor, m: int, *, vdot=_vdot, norm=_norm):
    """Krylov factorisation ``A V_m = V_{m+1} H`` via modified Gram-Schmidt
    (JAX ``solvers/arnoldi.py:30``).

    Returns ``(V, H, breakdown_at)`` with V (m+1, ...) leading with the
    Krylov index over ``x0``'s shape, H (m+1, m); ``breakdown_at`` (a 0-d
    tensor) is the step where the subspace became invariant (m if none).
    Fixed shapes and masked updates after a breakdown, as in JAX; the
    projection of step j runs over the j + 1 basis vectors it has (JAX's
    masked terms beyond them are exact zeros)."""
    dtype = x0.dtype
    rdt = real_dtype_of(dtype)
    dev = x0.device
    V = torch.zeros((m + 1,) + tuple(x0.shape), dtype=dtype, device=dev)
    V[0] = x0 / norm(x0).to(dtype)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    brk = torch.tensor(m + 1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(m):
        w = matvec(V[j])
        h = []
        for i in range(j + 1):
            hij = vdot(V[i], w)
            w = w - hij * V[i]
            h.append(hij)
        hjj = norm(w).to(rdt)
        breakdown = hjj == 0
        safe = torch.where(breakdown, 1, hjj).to(dtype)
        hcol = torch.stack(h + [hjj.to(dtype)] + [zero] * (m - j - 1))
        still = ~(brk < j + 1)  # no earlier breakdown
        V[j + 1] = torch.where(still & ~breakdown, w / safe, V[j + 1])
        H[:, j] = torch.where(still, hcol, H[:, j])
        brk = torch.where(still & breakdown, torch.clamp(brk, max=j + 1), brk)
    return V, H, torch.clamp(brk, max=m)
