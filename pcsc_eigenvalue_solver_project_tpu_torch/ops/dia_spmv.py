"""Banded (DIA) SpMV: CUDA kernels for the H100 and their plain versions.

Counterpart of the JAX package's ``ops/pallas/dia_spmv.py``. Three kernels,
all in ``csrc/dia_spmv.cu`` (see its header for the design):

- ``dia_kernel`` (B2): row-major SpMV ``y[i] = sum_d vals[d, i] * x[i + off_d]``
  over f32, bf16 or f64 diagonals;
- ``dia_complex_kernel`` (B3): the same over complex64/complex128, reading
  native complex tensors (no split planes);
- ``dia_il_kernel`` (B1): the interleaved (lane-major) SpMV from a haloed
  window, ``y[s, l] = sum_d vals_il[d, s, l] * w[pr + s + off_d, l]``.

Each kernel wrapper checks its inputs, allocates the output, launches on
the current stream and counts its launches in ``.launches``. The
dispatchers (``dia_matvec``, ``dia_matvec_il``, ``dia_matvec_il_window``)
run the plain PyTorch version when the operands lie on the CPU, and the
kernel otherwise: a tensor on a CUDA device launches the kernel or raises.

Layout: the interleaved layout stores element ``i`` of an n-vector at
``(i % R, i // R)`` of an ``(R, 128)`` tensor. It exists for the TPU's
sublane shifts; it is kept at these public functions so the port and the
JAX package compare like with like.
"""

from __future__ import annotations

import functools

import torch

from . import _build

LANES = 128
_SUB = 8  # halo granularity of the interleaved layout (the TPU's sublane count)
DEFAULT_IL_TILE = 64

# Stored-type codes of csrc/dia_spmv.cu (DTypeCode).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
                torch.complex64: 3, torch.complex128: 4}


def acc_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    """The accumulation and output dtype for stored diagonals:
    ``promote(stored, float32)``."""
    return torch.promote_types(vals_dtype, torch.float32)


# --------------------------------------------------------------------------
# Interleaved layout helpers
# --------------------------------------------------------------------------

def il_rows(n: int, tile_s: int = DEFAULT_IL_TILE) -> int:
    """Row count R of the interleaved layout of an n-vector (rounded up to a
    multiple of ``tile_s`` so the padded size R*128 tiles evenly)."""
    return -(-(-(-n // LANES)) // tile_s) * tile_s


def _il_halo(offsets) -> int:
    bw = max((abs(o) for o in offsets), default=0)
    return max(-(-bw // _SUB) * _SUB, _SUB)


def il_window_halo(offsets) -> int:
    """The pr (halo rows) a pre-built window for ``dia_matvec_il_window``
    must carry: the bandwidth rounded up to a multiple of 8."""
    return _il_halo(offsets)


def interleave_vec(x: torch.Tensor, R: int) -> torch.Tensor:
    """(n,) -> contiguous (R, 128) lane-major: element i at (i % R, i // R)."""
    n = x.shape[0]
    padded = x.new_zeros(R * LANES)
    padded[:n] = x
    return padded.reshape(LANES, R).T.contiguous()


def deinterleave_vec(x_il: torch.Tensor, n: int) -> torch.Tensor:
    """(R, 128) lane-major -> (n,)."""
    return x_il.T.reshape(-1)[:n]


def interleave_dia_vals(vals: torch.Tensor, R: int) -> torch.Tensor:
    """(k, n) diagonals -> contiguous (k, R, 128) lane-major."""
    k, n = vals.shape
    padded = vals.new_zeros((k, R * LANES))
    padded[:, :n] = vals
    return padded.reshape(k, LANES, R).transpose(1, 2).contiguous()


def _il_window(x_il: torch.Tensor, pr: int) -> torch.Tensor:
    """Haloed window (R + 2*pr, 128): pr rows above/below each lane's chunk,
    carrying the tail/head of the neighbouring lane's chunk (zero at the
    vector's ends). Then x[i + off] for |off| <= pr is the pure row access
    window[pr + (i % R) + off, i // R]. Needs pr <= R."""
    R = x_il.shape[0]
    w = x_il.new_zeros((R + 2 * pr, LANES))
    w[pr:pr + R] = x_il
    w[:pr, 1:] = x_il[R - pr:, :LANES - 1]
    w[pr + R:, :LANES - 1] = x_il[:pr, 1:]
    return w


# --------------------------------------------------------------------------
# Plain PyTorch versions (the JAX package's XLA branches)
# --------------------------------------------------------------------------

def _shifted(x: torch.Tensor, off: int) -> torch.Tensor:
    """seg[i] = x[i + off], zero where i + off leaves [0, n)."""
    n = x.shape[0]
    if off > 0:
        return torch.nn.functional.pad(x[off:], (0, min(off, n)))
    if off < 0:
        return torch.nn.functional.pad(x[:off], (min(-off, n), 0))
    return x


def dia_matvec_plain(vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """Row-major banded SpMV by shifted slices and multiply-adds."""
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + vals[d] * _shifted(x, off)
    return y


def dia_matvec_il_plain(vals_il: torch.Tensor, offsets,
                        x_il: torch.Tensor) -> torch.Tensor:
    """Interleaved banded SpMV: de-interleave, shifted multiply-adds on the
    padded vector (exact: padding positions carry zero diagonal values),
    re-interleave."""
    k, R, _ = vals_il.shape
    vals = vals_il.transpose(1, 2).reshape(k, R * LANES)
    x = x_il.T.reshape(-1)
    y = torch.zeros_like(x, dtype=torch.promote_types(vals.dtype, x.dtype))
    for d, off in enumerate(offsets):
        y = y + vals[d] * _shifted(x, off)
    return y.reshape(LANES, R).T.contiguous()


def dia_matvec_il_window_plain(vals_il: torch.Tensor, offsets,
                               w: torch.Tensor) -> torch.Tensor:
    """Interleaved banded SpMV from a haloed window, by row slices."""
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    out_dt = acc_dtype(vals_il.dtype)
    y = torch.zeros((R, w.shape[1]), dtype=out_dt, device=w.device)
    for d, off in enumerate(offsets):
        y = y + vals_il[d].to(out_dt) * w[pr + off:pr + off + R].to(out_dt)
    return y


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    # Cached: a fresh host-to-device copy per launch would stall the stream.
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _check_operands(name: str, vals: torch.Tensor, vec: torch.Tensor,
                    offsets: tuple, k: int) -> None:
    for label, t in (("diagonals", vals), ("vector", vec)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} on {t.device}, expected a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if vec.device != vals.device:
        raise ValueError(f"{name}: diagonals on {vals.device}, vector on {vec.device}")
    if vals.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported diagonal dtype {vals.dtype}")
    if vec.dtype != acc_dtype(vals.dtype):
        raise TypeError(f"{name}: vector dtype {vec.dtype} does not match "
                        f"{acc_dtype(vals.dtype)} for {vals.dtype} diagonals")
    if len(offsets) != k:
        raise ValueError(f"{name}: {len(offsets)} offsets for {k} diagonals")
    if any(abs(o) >= 2 ** 31 for o in offsets):
        raise ValueError(f"{name}: offset out of int32 range")


def _raise_on_error(name: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): "
                           f"{lib.dia_cuda_error_string(rc).decode()}")


def _launch_rowmajor(name: str, vals: torch.Tensor, offsets, x: torch.Tensor):
    offsets = tuple(int(o) for o in offsets)
    if vals.ndim != 2 or x.shape != (vals.shape[1],):
        raise ValueError(f"{name}: expected (k, n) diagonals and an (n,) vector, "
                         f"got {tuple(vals.shape)} and {tuple(x.shape)}")
    k, n = vals.shape
    _check_operands(name, vals, x, offsets, k)
    lib = _build.load()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    rc = lib.dia_rowmajor_spmv(
        _DTYPE_CODES[vals.dtype], x.device.index, vals.data_ptr(), x.data_ptr(),
        _device_offsets(offsets, x.device).data_ptr(), k, n, y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(name, lib, rc)
    return y


def dia_kernel(vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """B2 on the card: real (k, n) diagonals (f32, bf16, f64) times an (n,)
    vector of dtype ``acc_dtype(vals.dtype)``."""
    if vals.is_complex():
        raise TypeError("dia_kernel: complex diagonals go to dia_complex_kernel")
    y = _launch_rowmajor("dia_kernel", vals, offsets, x)
    dia_kernel.launches += 1
    return y


dia_kernel.launches = 0


def dia_complex_kernel(vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """B3 on the card: complex64/complex128 (k, n) diagonals times an (n,)
    vector of the same dtype, with the four-FMA complex product."""
    if not vals.is_complex():
        raise TypeError("dia_complex_kernel: real diagonals go to dia_kernel")
    y = _launch_rowmajor("dia_complex_kernel", vals, offsets, x)
    dia_complex_kernel.launches += 1
    return y


dia_complex_kernel.launches = 0


def dia_il_kernel(vals_il: torch.Tensor, offsets, w: torch.Tensor) -> torch.Tensor:
    """B1 on the card: (k, R, 128) interleaved diagonals times the haloed
    (R + 2*pr, 128) window of dtype ``acc_dtype(vals_il.dtype)``."""
    offsets = tuple(int(o) for o in offsets)
    if vals_il.ndim != 3 or vals_il.shape[2] != LANES:
        raise ValueError(f"dia_il_kernel: expected (k, R, {LANES}) diagonals, "
                         f"got {tuple(vals_il.shape)}")
    k, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if tuple(w.shape) != (R + 2 * pr, LANES):
        raise ValueError(f"dia_il_kernel: window shape {tuple(w.shape)}, expected "
                         f"{(R + 2 * pr, LANES)}")
    _check_operands("dia_il_kernel", vals_il, w, offsets, k)
    lib = _build.load()
    y = torch.empty((R, LANES), dtype=w.dtype, device=w.device)
    rc = lib.dia_il_window_spmv(
        _DTYPE_CODES[vals_il.dtype], w.device.index, vals_il.data_ptr(),
        w.data_ptr(), _device_offsets(offsets, w.device).data_ptr(), k, pr,
        R * LANES, y.data_ptr(), torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on_error("dia_il_kernel", lib, rc)
    dia_il_kernel.launches += 1
    return y


dia_il_kernel.launches = 0

KERNELS = (dia_il_kernel, dia_kernel, dia_complex_kernel)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


# --------------------------------------------------------------------------
# Dispatchers
# --------------------------------------------------------------------------

def dia_matvec(vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """Banded SpMV: (k, n) row-indexed diagonals (``vals[d, i] =
    A[i, i + offsets[d]]``) times an (n,) vector. On the card the vector
    must have dtype ``acc_dtype(vals.dtype)``, and so has the result."""
    if vals.device.type == "cpu":
        return dia_matvec_plain(vals, offsets, x)
    if vals.is_complex():
        return dia_complex_kernel(vals, offsets, x)
    return dia_kernel(vals, offsets, x)


def dia_matvec_il(vals_il: torch.Tensor, offsets, x_il: torch.Tensor) -> torch.Tensor:
    """Interleaved-domain banded SpMV: (k, R, 128) x (R, 128) -> (R, 128).

    Both operands live in the lane-major layout of ``interleave_vec`` /
    ``interleave_dia_vals``; the result stays in that layout so solver loops
    never convert. Requires the halo (bandwidth rounded up to 8) <= R.
    Unlike the JAX function this takes no ``tile_s``: the layout's tile only
    fixed R (``il_rows``); the kernel's blocks are its own.
    """
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if pr > R:
        raise ValueError("dia_matvec_il: bandwidth exceeds chunk size R")
    if vals_il.device.type == "cpu":
        return dia_matvec_il_plain(vals_il, offsets, x_il)
    w = _il_window(x_il.to(torch.promote_types(x_il.dtype, torch.float32)), pr)
    return dia_il_kernel(vals_il, offsets, w)


def dia_matvec_il_window(vals_il: torch.Tensor, offsets, w: torch.Tensor) -> torch.Tensor:
    """Interleaved SpMV from a caller-built haloed window (R + 2*pr, 128).

    Unlike ``dia_matvec_il`` (which zero-fills the vector's ends), the
    window may carry any values in the halo rows — e.g. a neighbouring
    shard's entries in a row partition. Semantics:
    ``y[s, l] = sum_d vals[d, s, l] * w[pr + s + off_d, l]``.
    """
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if w.shape[0] != R + 2 * pr:
        raise ValueError(
            f"dia_matvec_il_window: window has {w.shape[0]} sublanes, "
            f"expected R + 2*pr = {R + 2 * pr}")
    if vals_il.device.type == "cpu":
        return dia_matvec_il_window_plain(vals_il, offsets, w)
    return dia_il_kernel(vals_il, offsets,
                         w.to(torch.promote_types(w.dtype, torch.float32)))
