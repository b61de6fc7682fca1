"""Blocked (compact-WY) Householder Hessenberg reduction: the CUDA kernel
B11 (B12 on complex data) and its plain version.

Counterpart of the JAX package's ``ops/pallas/hessenberg_blocked.py``. Per
panel of ``nb`` columns starting at k0, with ``A0`` the matrix at the
panel's start (the order and ``tau`` convention of ``_hess_blocked_kernel``,
:97-473):

- for each column j (k = k0 + j, pivot row s = k + 1) the column as the
  panel's earlier reflectors left it, ``c = (I - V T^H V^H)(A0 - Z T V^H)
  e_k``; the reflector from ``c`` with B7's rules (phase sign, tail-zero and
  degenerate skips, ``tau`` in {0, 2}, ``v = 0`` when ``tau = 0``); then
  ``V[:, j] = v``, ``Z[:, j] = A0 v`` and ``T[:j, j] = -tau T V^H v``,
  ``T[j, j] = tau``. Both versions form ``v`` as ``vinv x``, where ``x`` is
  ``c`` with ``vs = x0 + sign ||c[s:]||`` at s and zeros above it and
  ``vinv = 1 / ||x||`` (0 on a skip): ``Z[:, j] = vinv (A0 x)`` and
  ``V^H v = vinv (V[s+1:]^H c[s+1:] + conj(V[s]) vs)``, so that no sum waits
  for the norm;
- the trailing update ``A := (I - V T^H V^H)(A0 - Z T V^H)``, and exact
  zeros below the subdiagonal of the panel's columns;
- with Q: ``Q -= (Q V) T V^H``.

``H`` and ``Q`` (``A = Q H Q^H``) are those of the unblocked reduction B7 up
to rounding. On complex data the same code is B12's replacement: the TPU's
real embedding (``hessenberg_blocked_embedded``) exists only because its
compiler faults on the two-plane kernels at np_ >= 1152. The TPU's slab
windows, 128-lane padding, phase-split and chunking are VMEM workarounds
and have no counterpart.

``hessenberg_blocked_kernel`` runs ``csrc/hessenberg_blocked.cu`` on a
float32, float64, complex64 or complex128 CUDA tensor, counts its calls in
``.launches`` and the device kernels of the last call in
``.device_launches``; ``hessenberg_blocked`` runs the plain version for a
CPU tensor and the kernel otherwise (it launches or raises). The kernel
uses no atomics: two calls on the same input give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import (DTYPE_CODES, abs2, check_square, eye, ptr, raise_on_error,
                      real_dtype, stream)

# Panel width: 32 ran B11 at n = 4096 in float32 (without Q) in 121.2 ms on
# an H100 (700 W), against 148.6 ms for 16 and 119.1 ms for 64
# (chip_smoke.py's panel-width lines, PERF.md).
PANEL_WIDTH = 32
MAX_PANEL_WIDTH = 64  # kMaxPanel of csrc/hessenberg_blocked.cu


def _check_nb(name: str, nb: int) -> int:
    nb = int(nb)
    if not 1 <= nb <= MAX_PANEL_WIDTH:
        raise ValueError(f"{name}: panel width {nb} outside [1, {MAX_PANEL_WIDTH}]")
    return nb


def _pivot(c: torch.Tensor, s: int):
    """The reflector's scalars for column ``c`` with pivot row ``s``:
    ``vs = x0 + sign ||c[s:]||`` (sign the phase of ``x0 = c[s]``, 1 when it
    is 0), the factor ``tau`` (2, or 0 for the tail-zero and degenerate
    skips) and ``vinv = 1 / ||x||`` (0 on a skip), with ``||x||^2 =
    ||c[s+1:]||^2 + |vs|^2`` (hessenberg_blocked.py:216-243)."""
    x0 = c[s]
    nrm2, tail2 = abs2(c[s:]).sum(), abs2(c[s + 1:]).sum()
    m0 = abs2(x0).sqrt()
    has0 = m0 > 0
    sign = torch.where(has0, x0 / torch.where(has0, m0, 1), 1)
    vs = x0 + sign * nrm2.sqrt()
    vn2 = tail2 + abs2(vs)
    skip = (tail2 == 0) | (vn2 == 0)
    tau = torch.where(skip, 0.0, 2.0).to(real_dtype(c.dtype))
    vinv = torch.where(skip, 0.0, torch.rsqrt(torch.where(vn2 == 0, 1, vn2)))
    return vs, tau, vinv


def hessenberg_blocked_plain(a: torch.Tensor, accumulate_q: bool = False,
                             nb: int = PANEL_WIDTH):
    """B11's plain version: ``H`` (and ``Q`` with ``A = Q H Q^H`` when
    ``accumulate_q``) by panels of ``nb`` columns, in the kernel's algebra
    without its row tiles."""
    nb = _check_nb("hessenberg_blocked_plain", nb)
    n = a.shape[0]
    A = a.clone()
    Q = eye(n, a) if accumulate_q else None
    rows = torch.arange(n, device=a.device)
    for k0 in range(0, max(n - 2, 0), nb):
        jn, v0 = min(nb, n - 2 - k0), k0 + 1
        V = torch.zeros((n, jn), dtype=a.dtype, device=a.device)
        Z = torch.zeros_like(V)
        T = torch.zeros((jn, jn), dtype=a.dtype, device=a.device)
        for j in range(jn):
            k = k0 + j
            s = k + 1
            Vj, Tj = V[:, :j], T[:j, :j]
            c = A[:, k] - Z[:, :j] @ (Tj @ Vj[k].conj())
            c[v0:] -= Vj[v0:] @ (Tj.conj().T @ (Vj[v0:].conj().T @ c[v0:]))
            vs, tau, vinv = _pivot(c, s)
            x = torch.where(rows < s, 0, torch.where(rows == s, vs, c))
            m = vinv * (Vj[s + 1:].conj().T @ c[s + 1:] + Vj[s].conj() * vs)
            T[:j, j] = -tau * (Tj @ m)
            T[j, j] = tau
            V[:, j] = x * vinv
            Z[:, j] = vinv * (A[:, s:] @ x[s:])
        Vh = V.conj().T
        Y = Z @ T
        W = T.conj().T @ (Vh @ A) - (T.conj().T @ (Vh @ Y)) @ Vh
        A = A - Y @ Vh - V @ W
        panel = (rows[None, :] >= k0) & (rows[None, :] < k0 + jn)
        A = torch.where(panel & (rows[:, None] >= rows[None, :] + 2), 0, A)
        if accumulate_q:
            Q = Q - ((Q @ V) @ T) @ Vh
    return (A, Q) if accumulate_q else A


def hessenberg_blocked_kernel(a: torch.Tensor, accumulate_q: bool = False,
                              nb: int = PANEL_WIDTH):
    """B11 on the card (B12 on complex data): ``H`` (and ``Q``) of a square
    CUDA matrix. The kernels the call enqueued are in
    ``hessenberg_blocked_kernel.device_launches``."""
    code = check_square("hessenberg_blocked_kernel", a, DTYPE_CODES)
    nb = _check_nb("hessenberg_blocked_kernel", nb)
    n = a.shape[0]
    lib = _build.load()
    h = torch.empty_like(a)
    q = torch.empty_like(a) if accumulate_q else None
    scratch = torch.empty(lib.hessenberg_blocked_scratch(n, nb), dtype=a.dtype, device=a.device)
    count = ctypes.c_longlong(0)
    rc = lib.hessenberg_blocked(code, a.device.index, a.data_ptr(), h.data_ptr(), ptr(q),
                                scratch.data_ptr(), n, nb, ctypes.byref(count), stream(a))
    raise_on_error("hessenberg_blocked_kernel", lib, rc)
    hessenberg_blocked_kernel.launches += 1
    hessenberg_blocked_kernel.device_launches = count.value
    return (h, q) if accumulate_q else h


hessenberg_blocked_kernel.launches = 0
hessenberg_blocked_kernel.device_launches = 0


def hessenberg_blocked(a: torch.Tensor, accumulate_q: bool = False, nb: int = PANEL_WIDTH):
    """Blocked Householder Hessenberg reduction (B11; B12 on complex data)."""
    if a.device.type == "cpu":
        return hessenberg_blocked_plain(a, accumulate_q, nb)
    return hessenberg_blocked_kernel(a, accumulate_q, nb)
