"""Banded (DIA) SpMV and block SpMM: CUDA kernels for the H100 and their
plain versions.

Counterpart of the JAX package's ``ops/pallas/dia_spmv.py``. The kernels,
all in ``csrc/dia_spmv.cu`` (see its header for the design):

- ``dia_kernel`` (B2): row-major SpMV ``y[i] = sum_d vals[d, i] * x[i + off_d]``
  over f32, bf16 or f64 diagonals;
- ``dia_complex_kernel`` (B3): the same over complex64/complex128, reading
  native complex tensors;
- ``dia_il_kernel`` (B1): the interleaved (lane-major) SpMV from a haloed
  window, ``y[s, l] = sum_d vals_il[d, s, l] * w[pr + s + off_d, l]``;
- ``dia_planes_kernel`` (B3's split-plane entry) and ``dia_il_planes_kernel``
  (B4): the complex SpMV on real re/im planes, row-major ``(2, k, n)`` and
  interleaved ``(2, k, R, 128)``, four FMAs per diagonal;
- ``dia_il_power_kernel`` (B1's power-step form) and ``power_finish_kernel``:
  one iteration of the power method on the interleaved layout in two
  launches, the product with the step's vector work (the scale of the
  iterate, the halo read in place, the partial sums of the Rayleigh
  quotient and the norm) and a one-block finish that updates the loop's
  carry on the device (``PowerState``);
- ``dia_block_kernel`` and ``dia_il_block_kernel`` (B5): the band times a
  block of ``nvec`` vectors, row-major (an ``(nvec, n)`` block, or by
  strides the ``(n, nvec)`` block of the block solvers) and interleaved,
  each diagonal read once per chunk of up to 8 vectors, x staged in shared
  memory (``block_route`` picks that route, or the direct kernel for bands
  too wide for a tile).

Each kernel wrapper checks its inputs, allocates the output, launches on
the current stream and counts its launches in ``.launches``. The
dispatchers (``dia_matvec``, ``dia_matvec_il``, ``dia_matvec_il_window``,
``dia_matvec_planes``, ``dia_matvec_il_planes``, ``dia_matmat``,
``dia_matmat_cols``, ``dia_matmat_il``, ``dia_matmat_il_window``,
``dia_il_power_step``, ``power_finish``) run the
plain PyTorch version when the operands lie on the CPU, and the kernel
otherwise: a tensor on a CUDA device launches the kernel or raises. Outputs have the accumulation
dtype ``acc_dtype(stored)``, as the Pallas kernels' do.

Layout: the interleaved layout stores element ``i`` of an n-vector at
``(i % R, i // R)`` of an ``(R, 128)`` tensor. It exists for the TPU's
sublane shifts; it is kept at these public functions so the port and the
JAX package compare like with like. Not ported, as they serve the TPU only:
the lane rolls and the ``_il_plan`` residue groups, the ``_stream`` variants'
VMEM budget (``_WINDOW_VMEM_BUDGET``), the ``tile_rows`` / (8, 128) tiling
inside the kernels and ``_backend_supports_pallas``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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
    """Haloed window (..., R + 2*pr, 128): pr rows above/below each lane's
    chunk, carrying the tail/head of the neighbouring lane's chunk (zero at
    the vector's ends). Then x[i + off] for |off| <= pr is the pure row access
    window[pr + (i % R) + off, i // R]. Needs pr <= R. Leading dimensions
    (re/im planes, the vectors of a block) each get their own halo."""
    R = x_il.shape[-2]
    w = x_il.new_zeros((*x_il.shape[:-2], R + 2 * pr, LANES))
    w[..., pr:pr + R, :] = x_il
    w[..., :pr, 1:] = x_il[..., R - pr:, :LANES - 1]
    w[..., pr + R:, :LANES - 1] = x_il[..., :pr, 1:]
    return w


# --------------------------------------------------------------------------
# Plain PyTorch versions (the JAX package's XLA branches)
# --------------------------------------------------------------------------

def _shifted(x: torch.Tensor, off: int) -> torch.Tensor:
    """seg[..., i] = x[..., i + off], zero where i + off leaves [0, n)."""
    n = x.shape[-1]
    if off > 0:
        return torch.nn.functional.pad(x[..., off:], (0, min(off, n)))
    if off < 0:
        return torch.nn.functional.pad(x[..., :off], (min(-off, n), 0))
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
    return dia_matmat_il_plain(vals_il, offsets, x_il[None])[0]


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


def _il_to_rows(t: torch.Tensor) -> torch.Tensor:
    """(..., R, 128) lane-major -> (..., R*128) in the natural order."""
    return t.transpose(-1, -2).reshape(*t.shape[:-2], -1)


def _rows_to_il(t: torch.Tensor, R: int) -> torch.Tensor:
    """(..., R*128) natural -> contiguous (..., R, 128) lane-major."""
    return t.reshape(*t.shape[:-1], LANES, R).transpose(-1, -2).contiguous()


def dia_matvec_planes_plain(vals_p: torch.Tensor, offsets, x_p: torch.Tensor) -> torch.Tensor:
    """Split-plane complex SpMV (JAX :171-183): (2, k, n) real planes times
    (2, n) planes -> (2, n), ``y_re = A_re x_re - A_im x_im``,
    ``y_im = A_re x_im + A_im x_re``, in ``acc_dtype(vals_p.dtype)``."""
    out_dt = acc_dtype(vals_p.dtype)
    x_p = x_p.to(out_dt)
    yr = torch.zeros(x_p.shape[1:], dtype=out_dt, device=x_p.device)
    yi = torch.zeros_like(yr)
    for d, off in enumerate(offsets):
        sr, si = _shifted(x_p[0], off), _shifted(x_p[1], off)
        vr, vi = vals_p[0, d].to(out_dt), vals_p[1, d].to(out_dt)
        yr = yr + vr * sr - vi * si
        yi = yi + vr * si + vi * sr
    return torch.stack([yr, yi])


def dia_matvec_il_planes_plain(vals_il_p: torch.Tensor, offsets,
                               x_il_p: torch.Tensor) -> torch.Tensor:
    """Interleaved split-plane complex SpMV (JAX :689-692): de-interleave,
    the row-major planes product on the padded vector, re-interleave."""
    R = vals_il_p.shape[2]
    y = dia_matvec_planes_plain(_il_to_rows(vals_il_p), offsets, _il_to_rows(x_il_p))
    return _rows_to_il(y, R)


def dia_matmat_plain(vals: torch.Tensor, offsets, xs: torch.Tensor) -> torch.Tensor:
    """Banded block SpMM (JAX :305-312): (k, n) diagonals times (nvec, n)
    vectors -> (nvec, n) in ``acc_dtype(vals.dtype)`` (the Pallas kernel's
    output dtype, :271)."""
    out_dt = acc_dtype(vals.dtype)
    xs = xs.to(out_dt)
    ys = torch.zeros_like(xs)
    for d, off in enumerate(offsets):
        ys = ys + vals[d].to(out_dt)[None] * _shifted(xs, off)
    return ys


def dia_matmat_il_window_plain(vals_il: torch.Tensor, offsets,
                               w: torch.Tensor) -> torch.Tensor:
    """Interleaved block SpMM from haloed windows (JAX :785-790):
    (nvec, R + 2*pr, 128) -> (nvec, R, 128), by row slices."""
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    out_dt = acc_dtype(vals_il.dtype)
    ys = torch.zeros((w.shape[0], R, w.shape[2]), dtype=out_dt, device=w.device)
    for d, off in enumerate(offsets):
        ys = ys + vals_il[d].to(out_dt)[None] * w[:, pr + off:pr + off + R].to(out_dt)
    return ys


def dia_matmat_il_plain(vals_il: torch.Tensor, offsets, xs_il: torch.Tensor) -> torch.Tensor:
    """Interleaved block SpMM (JAX :804-805, ``dia_matvec_il``'s XLA branch
    on each vector): (nvec, R, 128) -> (nvec, R, 128)."""
    R = vals_il.shape[1]
    vals, xs = _il_to_rows(vals_il), _il_to_rows(xs_il)
    out_dt = torch.promote_types(vals.dtype, xs.dtype)
    ys = torch.zeros(xs.shape, dtype=out_dt, device=xs.device)
    for d, off in enumerate(offsets):
        ys = ys + vals[d][None] * _shifted(xs, off)
    return _rows_to_il(ys, R)


# --------------------------------------------------------------------------
# B1's power-step form: the state and the plain versions
# --------------------------------------------------------------------------

# The carry's fields, as csrc/dia_spmv.cu indexes them: ctl (int32) holds
# the iteration count k, done, initialized, converged, the iterations used,
# cur (which of the pair holds the newest product z) and the zero flag
# (||zz[cur]|| == 0: the next iteration breaks down); sc (float32) the step's
# scale s = 1/||zz[cur]|| (1 where zero), the kept iterate's scale sx (the
# iterate is x = sx * zz[1 - cur]) and lambda.
CTL_K, CTL_DONE, CTL_INITIALIZED, CTL_CONVERGED, CTL_USED, CTL_CUR, CTL_ZERO = range(7)
SC_S, SC_SX, SC_LAM = range(3)
POWER_BLOCK = 512  # elements of the step's block (4 rows), summed into one partial


class PowerState(NamedTuple):
    """The power step's operands: ``zz`` the pair (2, R, 128) of products in
    float32, the carry ``ctl`` (8,) and ``sc`` (4,) (``CTL_*``, ``SC_*``),
    and the step's partial sums ``partials`` (2, blocks) of x . z and z . z,
    one a block of ``POWER_BLOCK`` elements."""
    zz: torch.Tensor
    ctl: torch.Tensor
    sc: torch.Tensor
    partials: torch.Tensor


def power_blocks(R: int) -> int:
    """Blocks of the power step over an (R, 128) vector, one partial each."""
    return -(-R * LANES // POWER_BLOCK)


def power_state(x0_il: torch.Tensor) -> PowerState:
    """The state of a start vector (R, 128), before its product: zz[0] = x0
    and cur 0, s = sx = 1, the counters, flags and lambda zero. Made on
    x0's device with no copy from the host."""
    R = x0_il.shape[0]
    zz = torch.empty((2, R, LANES), dtype=torch.float32, device=x0_il.device)
    zz[0] = x0_il
    ctl = torch.zeros(8, dtype=torch.int32, device=x0_il.device)
    sc = torch.zeros(4, dtype=torch.float32, device=x0_il.device)
    sc[:SC_LAM] = 1
    partials = torch.empty((2, power_blocks(R)), dtype=torch.float32, device=x0_il.device)
    return PowerState(zz, ctl, sc, partials)


def dia_il_power_step_plain(vals_il: torch.Tensor, offsets, st: PowerState, src: int) -> None:
    """B1's power step by its definition, in place on ``st``: unless done or
    the zero flag is set, x = s * zz[src], zz[1 - src] = A x
    (``dia_matvec_il_plain``), and the partial sums of x . (A x) and
    (A x) . (A x) over each block of ``POWER_BLOCK`` elements. ``src`` is
    the step's parity, the carry's cur whenever the step runs
    (``power_fused_loop``)."""
    if int(st.ctl[CTL_DONE]) or int(st.ctl[CTL_ZERO]):
        return
    x = st.zz[src] * st.sc[SC_S]
    z = dia_matvec_il_plain(vals_il, offsets, x)
    st.zz[1 - src] = z
    blocks = st.partials.shape[1]
    sums = torch.stack([x * z, z * z]).reshape(2, -1)
    sums = torch.nn.functional.pad(sums, (0, blocks * POWER_BLOCK - sums.shape[1]))
    st.partials.copy_(sums.reshape(2, blocks, POWER_BLOCK).sum(-1))


def power_finish_plain(st: PowerState, tol: float, init: bool = False) -> None:
    """The power step's finish by its definition, in place on ``st``: the
    carry update of ``solvers/power.py::power_carry_loop``'s body (see
    ``power_finish_kernel``), the partials summed in float64."""
    ctl, sc = st.ctl, st.sc
    if int(ctl[CTL_DONE]):
        return
    if int(ctl[CTL_ZERO]) and not init:  # breakdown: nothing kept
        ctl[CTL_K] += 1
        ctl[CTL_USED] = ctl[CTL_K]
        ctl[CTL_DONE] = 1
        return
    p, q = st.partials.to(torch.float64).sum(1)
    if not init:
        lam_new = p.to(torch.float32)
        diff = torch.abs(lam_new - sc[SC_LAM])
        scale = 1 + torch.abs(lam_new)
        conv = int(ctl[CTL_INITIALIZED]) and bool(diff.double() <= tol * scale.double())
        ctl[CTL_K] += 1
        ctl[CTL_USED] = ctl[CTL_K]
        ctl[CTL_INITIALIZED] = 1
        ctl[CTL_CONVERGED] |= int(conv)
        ctl[CTL_DONE] = int(conv)
        sc[SC_LAM] = lam_new
    norm = torch.sqrt(q).to(torch.float32)
    sc[SC_SX] = sc[SC_S].clone()
    ctl[CTL_CUR] = 1 - ctl[CTL_CUR]
    ctl[CTL_ZERO] = int(norm == 0)
    sc[SC_S] = 1 if norm == 0 else 1 / norm


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


def _check_power_state(name: str, st: PowerState, R: int, device: torch.device) -> None:
    expected = {"zz": ((2, R, LANES), torch.float32), "ctl": ((8,), torch.int32),
                "sc": ((4,), torch.float32), "partials": ((2, power_blocks(R)), torch.float32)}
    for label, (shape, dtype) in expected.items():
        t = getattr(st, label)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {label} is {tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on {device}")


def dia_il_power_kernel(vals_il: torch.Tensor, offsets, st: PowerState, src: int) -> None:
    """B1's power step on the card (``dia_il_window_kernel_power``): float32
    or bfloat16 (k, R, 128) interleaved diagonals, the state ``st`` updated
    in place as ``dia_il_power_step_plain`` says, reading half ``src`` of
    the pair, |offsets| <= R."""
    offsets = tuple(int(o) for o in offsets)
    if src not in (0, 1):
        raise ValueError(f"dia_il_power_kernel: src {src}, expected 0 or 1")
    if vals_il.ndim != 3 or vals_il.shape[2] != LANES:
        raise ValueError(f"dia_il_power_kernel: expected (k, R, {LANES}) diagonals, "
                         f"got {tuple(vals_il.shape)}")
    if vals_il.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dia_il_power_kernel: diagonals must be float32 or bfloat16, "
                        f"got {vals_il.dtype}")
    k, R, _ = vals_il.shape
    if any(abs(o) > R for o in offsets):
        raise ValueError("dia_il_power_kernel: bandwidth exceeds chunk size R")
    _check_operands("dia_il_power_kernel", vals_il, st.zz, offsets, k)
    _check_power_state("dia_il_power_kernel", st, R, vals_il.device)
    lib = _build.load()
    rc = lib.dia_il_power_step(
        _DTYPE_CODES[vals_il.dtype], vals_il.device.index, vals_il.data_ptr(), st.zz.data_ptr(),
        src, _device_offsets(offsets, vals_il.device).data_ptr(), k, R, st.ctl.data_ptr(),
        st.sc.data_ptr(), st.partials.data_ptr(),
        torch.cuda.current_stream(vals_il.device).cuda_stream)
    _raise_on_error("dia_il_power_kernel", lib, rc)
    dia_il_power_kernel.launches += 1


dia_il_power_kernel.launches = 0


def power_finish_kernel(st: PowerState, tol: float, init: bool = False) -> None:
    """The power step's finish on the card (``power_finish_kernel``, one
    block): ``st`` updated in place as ``power_finish_plain`` says, the
    partials summed in a fixed order."""
    device = st.zz.device
    if device.type != "cuda":
        raise ValueError(f"power_finish_kernel: state on {device}, expected a CUDA device")
    _check_power_state("power_finish_kernel", st, st.zz.shape[1], device)
    lib = _build.load()
    rc = lib.dia_il_power_finish(
        device.index, st.partials.data_ptr(), st.partials.shape[1], st.ctl.data_ptr(),
        st.sc.data_ptr(), float(tol), int(init), torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error("power_finish_kernel", lib, rc)
    power_finish_kernel.launches += 1


power_finish_kernel.launches = 0


def _check_planes(name: str, vals: torch.Tensor) -> None:
    if vals.is_complex():
        raise TypeError(f"{name}: planes must be real (float32, bfloat16 or float64), "
                        f"got {vals.dtype}")


def _launch_planes(name, vals_p, offsets, x_p, pr, m, out_shape, window):
    _check_operands(name, vals_p, x_p, offsets, vals_p.shape[1])
    lib = _build.load()
    y = torch.empty(out_shape, dtype=x_p.dtype, device=x_p.device)
    rc = lib.dia_planes_spmv(
        _DTYPE_CODES[vals_p.dtype], x_p.device.index, vals_p.data_ptr(), x_p.data_ptr(),
        _device_offsets(offsets, x_p.device).data_ptr(), vals_p.shape[1], pr, m,
        x_p[0].numel(), int(window), y.data_ptr(),
        torch.cuda.current_stream(x_p.device).cuda_stream)
    _raise_on_error(name, lib, rc)
    return y


def dia_planes_kernel(vals_p: torch.Tensor, offsets, x_p: torch.Tensor) -> torch.Tensor:
    """B3's split-plane entry on the card: (2, k, n) real planes (f32, bf16,
    f64) times (2, n) planes of dtype ``acc_dtype(vals_p.dtype)`` -> (2, n)."""
    offsets = tuple(int(o) for o in offsets)
    _check_planes("dia_planes_kernel", vals_p)
    if vals_p.ndim != 3 or vals_p.shape[0] != 2 or x_p.shape != (2, vals_p.shape[2]):
        raise ValueError(f"dia_planes_kernel: expected (2, k, n) planes and a (2, n) vector, "
                         f"got {tuple(vals_p.shape)} and {tuple(x_p.shape)}")
    n = vals_p.shape[2]
    y = _launch_planes("dia_planes_kernel", vals_p, offsets, x_p, 0, n, (2, n), False)
    dia_planes_kernel.launches += 1
    return y


dia_planes_kernel.launches = 0


def dia_il_planes_kernel(vals_il_p: torch.Tensor, offsets, w_p: torch.Tensor) -> torch.Tensor:
    """B4 on the card: (2, k, R, 128) interleaved real planes times the
    per-plane haloed windows (2, R + 2*pr, 128) of dtype
    ``acc_dtype(vals_il_p.dtype)`` -> (2, R, 128)."""
    offsets = tuple(int(o) for o in offsets)
    _check_planes("dia_il_planes_kernel", vals_il_p)
    if vals_il_p.ndim != 4 or vals_il_p.shape[0] != 2 or vals_il_p.shape[3] != LANES:
        raise ValueError(f"dia_il_planes_kernel: expected (2, k, R, {LANES}) planes, "
                         f"got {tuple(vals_il_p.shape)}")
    _, _, R, _ = vals_il_p.shape
    pr = _il_halo(offsets)
    if tuple(w_p.shape) != (2, R + 2 * pr, LANES):
        raise ValueError(f"dia_il_planes_kernel: window shape {tuple(w_p.shape)}, expected "
                         f"{(2, R + 2 * pr, LANES)}")
    y = _launch_planes("dia_il_planes_kernel", vals_il_p, offsets, w_p, pr, R * LANES,
                       (2, R, LANES), True)
    dia_il_planes_kernel.launches += 1
    return y


dia_il_planes_kernel.launches = 0


# B5's staged route (csrc/dia_spmv.cu::dia_block_staged_kernel): blocks of
# 256 threads, each thread 16 bytes of output rows (4 in float32), a tile of
# x for a chunk of up to 8 vectors and a ring of 8 diagonals' values in
# shared memory; bands whose tile does not fit in BLOCK_STAGED_SMEM take the
# direct kernel.
BLOCK_CHUNK = 8
BLOCK_STAGES = 8
BLOCK_THREADS = 256
BLOCK_SLAB_LANES = 32
BLOCK_STAGED_SMEM = 160 * 1024


def block_stage_smem(window: bool, offsets, dtype: torch.dtype, nvec: int) -> int:
    """Bytes of shared memory B5's staged kernel takes for diagonals stored in
    ``dtype`` (vectors in ``acc_dtype(dtype)``): per vector of a chunk of
    ``min(nvec, 8)``, the x tile over the positions the band reaches,
    row-major ``256 r + span`` positions with one spare element after every
    128 bytes, interleaved ``(8 r + span)`` sublanes of 32 lanes, with
    ``r = 16 / itemsize`` rows a thread and ``span`` the largest offset less
    the least; rounded up to 16 bytes, then a ring of 8 diagonals' stored
    values, ``r`` of them for each of the 256 threads."""
    acc = acc_dtype(dtype)
    itemsize = torch.empty((), dtype=acc).element_size()
    rows = 16 // itemsize
    span = max(offsets, default=0) - min(offsets, default=0)
    if window:
        elems = ((BLOCK_THREADS // BLOCK_SLAB_LANES) * rows + span) * BLOCK_SLAB_LANES
    else:
        positions = BLOCK_THREADS * rows + span
        elems = positions + positions // (128 // itemsize) + 1
    tile = -(-elems * min(nvec, BLOCK_CHUNK) * itemsize // 16) * 16
    ring = BLOCK_STAGES * BLOCK_THREADS * rows * torch.empty((), dtype=dtype).element_size()
    return tile + ring


def block_route(window: bool, offsets, dtype: torch.dtype, nvec: int,
                vectors_last: bool = False) -> str:
    """B5's route for diagonals stored in ``dtype``, decided before the
    launch: ``"staged"`` or ``"direct"``, the kernel that reads x through L1.
    Staged where the tile fits in ``BLOCK_STAGED_SMEM`` and it was the faster
    on the H100 (``chip_smoke.py`` phase 15 times both; PERF.md): the
    interleaved window with 4-byte vectors (float32 and bf16 diagonals), and
    the ``(n, nvec)`` block of the block solvers. The ``(nvec, n)`` row-major
    block, and 8- and 16-byte vectors interleaved, take the direct kernel."""
    faster = vectors_last if not window else acc_dtype(dtype).itemsize == 4
    fits = block_stage_smem(window, offsets, dtype, nvec) <= BLOCK_STAGED_SMEM
    return "staged" if faster and fits else "direct"


def _launch_block(name, vals, offsets, xs, pr, length, x_len, x_strides, y, y_strides, nvec,
                  window, route=None):
    _check_operands(name, vals, xs, offsets, vals.shape[0])
    if nvec >= 2 ** 31:
        raise ValueError(f"{name}: {nvec} vectors, more than int32 holds")
    route = route or block_route(window, offsets, vals.dtype, nvec, x_strides[0] == 1)
    smem = block_stage_smem(window, offsets, vals.dtype, nvec)
    if route not in ("staged", "direct"):
        raise ValueError(f"{name}: route {route!r}, expected 'staged' or 'direct'")
    if route == "staged" and smem > BLOCK_STAGED_SMEM:
        raise ValueError(f"{name}: the band's tile takes {smem} bytes, more than the "
                         f"staged route's {BLOCK_STAGED_SMEM}")
    if window and route == "direct":  # flat window indices
        x_strides, y_strides = (x_strides[0], 1), (y_strides[0], 1)
    lib = _build.load()
    rc = lib.dia_block_spmm(
        _DTYPE_CODES[vals.dtype], xs.device.index, vals.data_ptr(), xs.data_ptr(),
        _device_offsets(offsets, xs.device).data_ptr(), vals.shape[0],
        min(offsets, default=0), max(offsets, default=0), pr, length, x_len, *x_strides,
        *y_strides, nvec, int(window), int(route == "staged"), smem, y.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on_error(name, lib, rc)
    return route


def dia_block_kernel(vals: torch.Tensor, offsets, xs: torch.Tensor, *,
                     vectors_last: bool = False, route: str | None = None) -> torch.Tensor:
    """B5 on the card, row-major: (k, n) diagonals (f32, bf16, f64, c64,
    c128) times an (nvec, n) block of dtype ``acc_dtype(vals.dtype)`` ->
    (nvec, n); with ``vectors_last`` an (n, nvec) block -> (n, nvec), read
    and written by strides, with no transposed copy. ``route`` ("staged" or
    "direct") overrides ``block_route``; the route taken is in
    ``dia_block_kernel.last_route``."""
    offsets = tuple(int(o) for o in offsets)
    n_axis = 0 if vectors_last else 1
    if vals.ndim != 2 or xs.ndim != 2 or xs.shape[n_axis] != vals.shape[1]:
        shape = "(n, nvec)" if vectors_last else "(nvec, n)"
        raise ValueError(f"dia_block_kernel: expected (k, n) diagonals and an {shape} block, "
                         f"got {tuple(vals.shape)} and {tuple(xs.shape)}")
    n, nvec = vals.shape[1], xs.shape[1 - n_axis]
    y = torch.empty(tuple(xs.shape), dtype=xs.dtype, device=xs.device)
    strides = (1, nvec) if vectors_last else (n, 1)
    dia_block_kernel.last_route = _launch_block("dia_block_kernel", vals, offsets, xs, 0, n, n,
                                                strides, y, strides, nvec, False, route)
    dia_block_kernel.launches += 1
    return y


dia_block_kernel.launches = 0
dia_block_kernel.last_route = None


def dia_il_block_kernel(vals_il: torch.Tensor, offsets, w: torch.Tensor,
                        route: str | None = None) -> torch.Tensor:
    """B5 on the card, interleaved: (k, R, 128) diagonals times the haloed
    windows (nvec, R + 2*pr, 128) of dtype ``acc_dtype(vals_il.dtype)`` ->
    (nvec, R, 128). ``route`` overrides ``block_route``; the route taken is
    in ``dia_il_block_kernel.last_route``."""
    offsets = tuple(int(o) for o in offsets)
    if vals_il.ndim != 3 or vals_il.shape[2] != LANES:
        raise ValueError(f"dia_il_block_kernel: expected (k, R, {LANES}) diagonals, "
                         f"got {tuple(vals_il.shape)}")
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if w.ndim != 3 or tuple(w.shape[1:]) != (R + 2 * pr, LANES):
        raise ValueError(f"dia_il_block_kernel: window shape {tuple(w.shape)}, expected "
                         f"(nvec, {R + 2 * pr}, {LANES})")
    nvec = w.shape[0]
    y = torch.empty((nvec, R, LANES), dtype=w.dtype, device=w.device)
    dia_il_block_kernel.last_route = _launch_block(
        "dia_il_block_kernel", vals_il, offsets, w, pr, R, R + 2 * pr,
        ((R + 2 * pr) * LANES, LANES), y, (R * LANES, LANES), nvec, True, route)
    dia_il_block_kernel.launches += 1
    return y


dia_il_block_kernel.launches = 0
dia_il_block_kernel.last_route = None

KERNELS = (dia_il_kernel, dia_kernel, dia_complex_kernel, dia_il_planes_kernel,
           dia_planes_kernel, dia_block_kernel, dia_il_block_kernel, dia_il_power_kernel,
           power_finish_kernel)


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


def dia_matvec_planes(vals_p: torch.Tensor, offsets, x_p: torch.Tensor) -> torch.Tensor:
    """Split-plane banded complex SpMV: (2, k, n) real planes times (2, n)
    planes -> (2, n) (``y = A x`` with A and x complex). On the card ``x_p``
    must have dtype ``acc_dtype(vals_p.dtype)``, and so has the result."""
    if vals_p.device.type == "cpu":
        return dia_matvec_planes_plain(vals_p, offsets, x_p)
    return dia_planes_kernel(vals_p, offsets, x_p)


def dia_matvec_il_planes(vals_il_p: torch.Tensor, offsets,
                         x_il_p: torch.Tensor) -> torch.Tensor:
    """Interleaved split-plane complex SpMV: (2, k, R, 128) real planes times
    (2, R, 128) planes -> (2, R, 128). Each plane gets its own haloed
    window. Requires the halo (bandwidth rounded up to 8) <= R."""
    _, _, R, _ = vals_il_p.shape
    pr = _il_halo(offsets)
    if pr > R:
        raise ValueError("dia_matvec_il_planes: bandwidth exceeds chunk size R")
    if vals_il_p.device.type == "cpu":
        return dia_matvec_il_planes_plain(vals_il_p, offsets, x_il_p)
    w = _il_window(x_il_p.to(torch.promote_types(x_il_p.dtype, torch.float32)), pr)
    return dia_il_planes_kernel(vals_il_p, offsets, w)


def dia_matmat(vals: torch.Tensor, offsets, xs: torch.Tensor) -> torch.Tensor:
    """Banded block SpMM: (k, n) diagonals times (nvec, n) vectors ->
    (nvec, n). On the card ``xs`` must be contiguous with dtype
    ``acc_dtype(vals.dtype)``, and the result has that dtype."""
    if vals.device.type == "cpu":
        return dia_matmat_plain(vals, offsets, xs)
    return dia_block_kernel(vals, offsets, xs)


def dia_matmat_cols(vals: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """Banded block SpMM on an (n, b) block of column vectors -> (n, b), the
    layout of the block solvers. On the card ``X`` must be contiguous with
    dtype ``acc_dtype(vals.dtype)``: the kernel reads and writes it by
    strides, with no transposed copy."""
    if vals.device.type == "cpu":
        return dia_matmat_plain(vals, offsets, X.T).T
    return dia_block_kernel(vals, offsets, X, vectors_last=True)


def dia_matmat_il(vals_il: torch.Tensor, offsets, xs_il: torch.Tensor) -> torch.Tensor:
    """Interleaved-domain block SpMM: (k, R, 128) diagonals times
    (nvec, R, 128) vectors -> (nvec, R, 128). Each vector gets its own haloed
    window; requires the halo <= R."""
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if pr > R:
        raise ValueError("dia_matmat_il: bandwidth exceeds chunk size R")
    if vals_il.device.type == "cpu":
        return dia_matmat_il_plain(vals_il, offsets, xs_il)
    w = _il_window(xs_il.to(torch.promote_types(xs_il.dtype, torch.float32)), pr)
    return dia_il_block_kernel(vals_il, offsets, w)


def dia_matmat_il_window(vals_il: torch.Tensor, offsets, w: torch.Tensor) -> torch.Tensor:
    """Interleaved block SpMM from caller-built haloed windows
    (nvec, R + 2*pr, 128) -> (nvec, R, 128); the halo rows may carry any
    values (cf. ``dia_matvec_il_window``)."""
    _, R, _ = vals_il.shape
    pr = _il_halo(offsets)
    if w.shape[1] != R + 2 * pr:
        raise ValueError(
            f"dia_matmat_il_window: window has {w.shape[1]} sublanes, "
            f"expected R + 2*pr = {R + 2 * pr}")
    if vals_il.device.type == "cpu":
        return dia_matmat_il_window_plain(vals_il, offsets, w)
    return dia_il_block_kernel(vals_il, offsets,
                               w.to(torch.promote_types(w.dtype, torch.float32)))


def dia_il_power_step(vals_il: torch.Tensor, offsets, st: PowerState, src: int) -> None:
    """One power step on ``st`` (``power_state``) from half ``src`` of the
    pair: B1's power-step form on the card, its plain version on the CPU."""
    if vals_il.device.type == "cpu":
        dia_il_power_step_plain(vals_il, offsets, st, src)
    else:
        dia_il_power_kernel(vals_il, offsets, st, src)


def power_finish(st: PowerState, tol: float, init: bool = False) -> None:
    """The finish of a power step (``init``: of the start's product), in
    place on ``st``: the kernel on the card, the plain version on the CPU."""
    if st.zz.device.type == "cpu":
        power_finish_plain(st, tol, init)
    else:
        power_finish_kernel(st, tol, init)
