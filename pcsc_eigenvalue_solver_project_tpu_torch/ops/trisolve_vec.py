"""Eigenvectors of an upper-triangular matrix: the CUDA kernel B14 and its
plain version.

Counterpart of the JAX package's ``ops/pallas/trisolve_vec.py``. Column k
of ``Y`` solves ``(T - T[k,k] I) y = 0`` with ``y[k] = 1`` and zeros below,
by the row recurrence ``y[i] = -(sum_{j>i} T[i,j] y[j]) / (T[i,i] - T[k,k])``
taken bottom-up for all columns at once, in blocks of ``BLOCK_ROWS`` rows:
the rows below a block enter through one product, the block's own rows run
in sequence. The Pallas kernel's rules are kept:

- the clamp ``|T[i,i] - T[k,k]|^2 < eps^2 -> den = eps`` (:205-212);
- the mask: row i of column k is solved only for ``k > i`` (:214-218);
- the rescale: when a new entry exceeds 1e18 (``max(|re|, |im|)``), the
  column's rows of the current block and its pending sums are scaled by
  1e-18 and the column's event count rises by one (:50-59, :220-236); the
  rows of lower blocks enter a block's product at 1e-18^(events since),
  and a last pass brings every block to the column's final count
  (:152-170, :331-337).

The columns are NOT normalised (the caller forms ``V = Q Y`` and normalises).
The TPU's column split ``nsplit``, its 16-row windows, streaming tiles and
padding are VMEM layout and have no counterpart.

``triangular_eigenvectors_kernel`` runs ``csrc/trisolve_vec.cu`` on a
complex64 or complex128 CUDA tensor and counts its launches in
``.launches``; ``triangular_eigenvectors_device`` runs the plain version
for a CPU tensor and the kernel otherwise (it launches or raises).
"""

from __future__ import annotations

import torch

from . import _build
from ._common import COMPLEX_CODES, abs2, check_square, raise_on_error, real_dtype, stream

BLOCK_ROWS = 64    # kBlockRows of csrc/trisolve_vec.cu
RESCALE_AT = 1e18  # trisolve_vec.py:58
RESCALE_BY = 1e-18  # :59


def _event_factor(delta: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    """1, 1e-18, 1e-36 for 0 (or fewer), 1, 2 events since, else 0
    (trisolve_vec.py:162-165)."""
    one = torch.ones((), dtype=rdt, device=delta.device)
    r = torch.tensor(RESCALE_BY, dtype=rdt, device=delta.device)
    return torch.where(delta <= 0, one, torch.where(
        delta == 1, r, torch.where(delta == 2, r * r, torch.zeros_like(one))))


def triangular_eigenvectors_plain(T: torch.Tensor, eps: float) -> torch.Tensor:
    """B14's plain version: the unnormalised eigenvector matrix ``Y`` of the
    upper-triangular complex ``T``; column k pairs with ``T[k, k]``."""
    n = T.shape[0]
    rdt = real_dtype(T.dtype)
    dev = T.device
    lam = T.diagonal()
    cols = torch.arange(n, device=dev)
    nblk = -(-n // BLOCK_ROWS)
    row_block = torch.arange(n, device=dev) // BLOCK_ROWS
    eps_t = torch.tensor(eps, dtype=rdt, device=dev)
    big = torch.tensor(RESCALE_AT, dtype=rdt, device=dev)
    Y = torch.zeros_like(T)
    cnt = torch.zeros((nblk, n), dtype=torch.int64, device=dev)
    ccur = torch.zeros(n, dtype=torch.int64, device=dev)
    for b in range(nblk - 1, -1, -1):
        b1, e1 = b * BLOCK_ROWS, min(n, (b + 1) * BLOCK_ROWS)
        if e1 < n:  # the rows below, each at the column's current scale
            f = _event_factor(ccur[None, :] - cnt[row_block[e1:]], rdt)
            racc = T[b1:e1, e1:] @ (Y[e1:] * f)
        else:
            racc = torch.zeros((e1 - b1, n), dtype=T.dtype, device=dev)
        yblk = torch.zeros((e1 - b1, n), dtype=T.dtype, device=dev)
        for i in range(e1 - 1, b1 - 1, -1):
            den = T[i, i] - lam
            den = torch.where(abs2(den) < eps_t * eps_t, eps_t.to(T.dtype), den)
            dd = abs2(den)
            dd = torch.where(dd == 0, 1, dd)
            y = -(racc[i - b1] * den.conj()) / dd * (cols > i) + (cols == i)
            trig = torch.maximum(y.real.abs(), y.imag.abs()) > big
            fct = torch.where(trig, RESCALE_BY, 1.0).to(rdt)
            yblk = yblk * fct
            racc = racc * fct
            ccur = ccur + trig
            y = y * fct
            yblk[i - b1] = y
            racc[:i - b1] += T[b1:i, i, None] * y  # the block's rows above
        cnt[b] = ccur
        Y[b1:e1] = yblk
    r = torch.tensor(RESCALE_BY, dtype=rdt, device=dev)
    return Y * torch.pow(r, (cnt[0][None, :] - cnt[row_block]).to(rdt))


def triangular_eigenvectors_kernel(T: torch.Tensor, eps: float) -> torch.Tensor:
    """B14 on the card: ``Y`` of an upper-triangular complex64 or complex128
    CUDA matrix."""
    code = check_square("triangular_eigenvectors_kernel", T, COMPLEX_CODES)
    n = T.shape[0]
    lib = _build.load()
    y = torch.empty_like(T)
    racc = torch.empty(BLOCK_ROWS * max(n, 1), dtype=T.dtype, device=T.device)
    counts = torch.empty((-(-n // BLOCK_ROWS) + 1) * max(n, 1), dtype=torch.int32,
                         device=T.device)
    rc = lib.trisolve_eigenvectors(code, T.device.index, T.data_ptr(), y.data_ptr(),
                                   racc.data_ptr(), counts.data_ptr(), n, float(eps),
                                   stream(T))
    raise_on_error("triangular_eigenvectors_kernel", lib, rc)
    triangular_eigenvectors_kernel.launches += 1
    return y


triangular_eigenvectors_kernel.launches = 0


def triangular_eigenvectors_device(T: torch.Tensor, eps: float) -> torch.Tensor:
    """Eigenvectors of an upper-triangular matrix (B14), unnormalised."""
    if T.device.type == "cpu":
        return triangular_eigenvectors_plain(T, eps)
    return triangular_eigenvectors_kernel(T, eps)
