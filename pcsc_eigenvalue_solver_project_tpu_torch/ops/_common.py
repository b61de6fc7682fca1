"""What the dense kernels' Python side shares: dtype codes, input checks,
the launch stream and error check, and the Householder reflector rule of
the plain versions (B7, B9, B11)."""

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
