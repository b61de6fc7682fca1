"""What the dense kernels' Python side shares: dtype codes, input checks,
the launch stream and error check, the Householder reflector rule of the
plain versions (B7, B9), and the shift and window rules of the shifted
sweeps' plain versions (B8, B13)."""

from __future__ import annotations

import torch

# Scalar-type codes of csrc/eig_common.cuh (the codes of csrc/dia_spmv.cu).
DTYPE_CODES = {torch.float32: 0, torch.float64: 2,
               torch.complex64: 3, torch.complex128: 4}
COMPLEX_CODES = {torch.complex64: 3, torch.complex128: 4}


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 elementwise, as re^2 + im^2 for complex tensors."""
    if x.is_complex():
        return x.real.square() + x.imag.square()
    return x.square()


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def reflector(col: torch.Tensor, s: int):
    """The Householder column step of the Pallas kernels on column ``col``
    with pivot row ``s`` (Hessenberg: s = k + 1; QR: s = k): the unit
    reflector ``v`` (zero above row ``s``) and the update factor, 2 or 0.

    The factor is 0 when the column is already zero below the pivot (the
    tail-zero skip) or the reflector degenerates (``||v|| = 0``). The sign
    is the phase ``x0/|x0|`` of the pivot, 1 when it is 0
    (qr_kernels.py:97-130, :676-702; hessenberg_blocked.py:216-243)."""
    n = col.shape[0]
    rows = torch.arange(n, device=col.device)
    x = torch.where(rows >= s, col, 0)
    norm_x = abs2(x).sum().sqrt()
    tail_zero = abs2(col[s + 1:]).sum() == 0
    x0 = col[s]
    m0 = abs2(x0).sqrt()
    has0 = m0 > 0
    sign = torch.where(has0, x0 / torch.where(has0, m0, 1), 1)
    v = x + (sign * norm_x) * (rows == s)
    vn2 = abs2(v).sum()
    degenerate = vn2 == 0
    v = v * torch.rsqrt(torch.where(degenerate, 1, vn2))
    factor = torch.where(tail_zero | degenerate, 0.0, 2.0).to(real_dtype(col.dtype))
    return v, factor


def wilkinson_shift(a, b, c, d):
    """Eigenvalue of ``[[a, b], [c, d]]`` nearest ``d``, in the plane
    arithmetic of the Pallas kernel (qr_kernels.py:366-385)."""
    delr, deli = (a.real - d.real) * 0.5, (a.imag - d.imag) * 0.5
    zr = delr * delr - deli * deli + b.real * c.real - b.imag * c.imag
    zi = 2.0 * delr * deli + b.real * c.imag + b.imag * c.real
    mz = torch.sqrt(zr * zr + zi * zi)
    sqr = torch.sqrt(torch.clamp((mz + zr) * 0.5, min=0.0))
    sqi_mag = torch.sqrt(torch.clamp((mz - zr) * 0.5, min=0.0))
    sqi = torch.where(zi >= 0.0, sqi_mag, -sqi_mag)
    mu1r, mu1i = d.real + delr + sqr, d.imag + deli + sqi
    mu2r, mu2i = d.real + delr - sqr, d.imag + deli - sqi
    m1 = (mu1r - d.real) ** 2 + (mu1i - d.imag) ** 2
    m2 = (mu2r - d.real) ** 2 + (mu2i - d.imag) ** 2
    pick1 = m1 < m2
    return torch.complex(torch.where(pick1, mu1r, mu2r), torch.where(pick1, mu1i, mu2i))


def deflate_and_lo(H: torch.Tensor, hi: int, tol: torch.Tensor):
    """The Pallas kernel's window update (qr_kernels.py:339-351): the new
    ``hi`` is 2 + the last c < hi - 1 whose subdiagonal ``H[c+1, c]`` is not
    negligible (1 if none); ``lo`` is 1 + the last c < new hi - 1 whose
    subdiagonal is negligible (0 if none). Negligible:
    ``|H[c+1,c]| <= tol * max(|H[c,c]| + |H[c+1,c+1]|, 1)``."""
    n = H.shape[0]
    if n < 2:
        return 1, 0
    smag = abs2(H.diagonal(-1)).sqrt()
    dmag = abs2(H.diagonal()).sqrt()
    neg = smag <= tol * torch.clamp(dmag[:-1] + dmag[1:], min=1.0)
    c = torch.arange(n - 1, device=H.device)
    new_hi = int(torch.where((c < hi - 1) & ~neg, c, -1).max()) + 2
    lo = int(torch.where((c < new_hi - 1) & neg, c, -1).max()) + 1
    return new_hi, lo


def givens(x: torch.Tensor, y: torch.Tensor):
    """The rotation zeroing ``y`` under ``x`` (qr_kernels.py:405-415):
    ``g00 = conj(x) / r``, ``g01 = conj(y) / r`` with ``r = sqrt(|x|^2 +
    |y|^2)``; the identity when ``r = 0``."""
    r2 = abs2(x) + abs2(y)
    zero = r2 == 0
    rinv = torch.rsqrt(torch.where(zero, 1, r2))
    return (torch.where(zero, torch.ones_like(x), x.conj() * rinv),
            torch.where(zero, 0, y.conj() * rinv))


def rotate_rows(g00, g01, x: torch.Tensor, y: torch.Tensor):
    """Rows k, k+1 under the left rotation: ``(g00 x + g01 y,
    -conj(g01) x + conj(g00) y)``, as new tensors."""
    return g00 * x + g01 * y, -g01.conj() * x + g00.conj() * y


def check_square(name: str, a: torch.Tensor, codes: dict) -> int:
    """The scalar-type code of a square contiguous CUDA matrix; raises on
    anything else."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: matrix on {a.device}, expected a CUDA device")
    if a.dtype not in codes:
        raise TypeError(f"{name}: unsupported dtype {a.dtype} "
                        f"(takes {', '.join(str(d) for d in codes)})")
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{name}: expected a square (n, n) matrix, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: matrix must be contiguous")
    return codes[a.dtype]


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(name: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): "
                           f"{lib.dia_cuda_error_string(rc).decode()}")


def ptr(t):
    return None if t is None else t.data_ptr()
