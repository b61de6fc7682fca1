"""General (unstructured) sparse SpMV: the CUDA kernel B6 for the H100, its
plain version and the pack it reads.

Counterpart of the JAX package's ``ops/pallas/gell_spmv.py``. The JAX pack
("packed gather-ELL") is shaped for the TPU's 128-lane gather and its VMEM;
on the card a gather is an address, so ``pack_gell`` keeps the JAX name but
builds plain row-sorted CSR from the same COO: ``indptr``, ``indices`` and
``values`` (complex values as (re, im) pairs), duplicates kept, since the
kernel sums them as the JAX run scan does. The kernel (``csrc/gell_spmv.cu``,
see its header) gives each row a group of ``group`` lanes.

- ``gell_kernel`` (B6): ``y = A x`` for a real pack (f32, bf16 or f64
  values) and for a complex pack on native complex64/complex128 vectors;
- ``gell_planes_kernel`` (B6 cpx): a complex pack times (2, n_cols) re/im
  planes -> (2, n_rows) planes.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and counts its launches in ``.launches``. The dispatchers
``gell_matvec`` and ``gell_matvec_planes`` run the plain PyTorch version when
the pack lies on the CPU and the kernel otherwise: a pack on a CUDA device
launches the kernel or raises.

Not ported, as they serve the TPU only: the lane buckets, the int16/int32
segment word and its mask bits, the suffix scan, the int8 inverse
permutation, the transposed x, the chunk lists and ``max_chunks``, the spill
tail, ``auto_tile_rows``, ``_XT_VMEM_BUDGET`` and the dtype gate of
``_use_pallas``. ``unpack_gell_leaves`` decodes a JAX pack back to COO (its
copy of the pack's logic), so a JAX operator can be carried across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import as_torch_dtype
from ..utils.interop import to_tensor
from . import _build

LANES = 128
_INT32_MAX = 2 ** 31 - 1
_SEG16_BITS = 13  # the JAX pack's int16 segment word: 13-bit segment, then the mask bits

# Value-type codes of csrc/gell_spmv.cu (those of csrc/dia_spmv.cu) and its modes.
_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_MODE_REAL, _MODE_COMPLEX, _MODE_PLANES = 0, 1, 2


def group_width(nnz: int, n_rows: int) -> int:
    """Lanes per row: the smallest power of two at or above the mean row
    length, clamped to [4, 32] (32 at 33 entries a row, 8 at 6)."""
    mean = -(-nnz // max(n_rows, 1))
    g = 4
    while g < mean and g < 32:
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class GELLPack:
    """One general sparse operator as row-sorted CSR on one device.

    ``values`` is (nnz,) for real data (f32, bf16 or f64) and (nnz, 2)
    (re, im) pairs in the real dtype for complex data. ``tile_rows`` is the
    JAX keyword, checked and recorded; it does not shape this layout."""

    indptr: torch.Tensor    # (n_rows + 1,) int32
    indices: torch.Tensor   # (nnz,) int32, ascending within each row
    values: torch.Tensor    # (nnz,) or (nnz, 2)
    shape: tuple
    group: int
    tile_rows: int | None = None
    is_complex: bool = False

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        """The logical scalar dtype: the values' for real data; complex64 for
        f32 or bf16 pairs, complex128 for f64 pairs."""
        if self.is_complex:
            return torch.complex128 if self.values.dtype == torch.float64 else torch.complex64
        return self.values.dtype

    @property
    def vector_dtype(self) -> torch.dtype:
        """The dtype of ``x`` and ``y`` on the card: ``promote(values,
        float32)``, its complex form for a complex pack."""
        real = torch.promote_types(self.values.dtype, torch.float32)
        return real.to_complex() if self.is_complex else real

    def with_values_dtype(self, dtype) -> "GELLPack":
        """The same pack with its values cast (``torch.bfloat16`` halves the
        value bytes; the kernel accumulates in f32 regardless)."""
        dt = as_torch_dtype(dtype)
        if dt not in _VALUE_CODES:
            raise TypeError(f"GELLPack.with_values_dtype: values are float32, bfloat16 or "
                            f"float64, got {dt}")
        return dataclasses.replace(self, values=self.values.to(dt))


def build_pack(row, col, values: torch.Tensor, shape, *, is_complex: bool,
               tile_rows: int | None = None, device=None) -> GELLPack:
    """Sort COO triplets by (row, col) on the host (stably: duplicates keep
    their order) and place the CSR on ``device`` (default: the card).
    ``values`` is a host tensor, (nnz,) or (nnz, 2) pairs when
    ``is_complex``."""
    n_rows, n_cols = map(int, shape)
    if tile_rows is not None and tile_rows % LANES != 0:
        raise ValueError("pack_gell: tile_rows must be a multiple of 128")
    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    if values.dtype not in _VALUE_CODES:
        raise TypeError(f"pack_gell: unsupported value dtype {values.dtype}")
    if r.ndim != 1 or r.shape != c.shape or values.shape[:1] != r.shape \
            or values.shape[1:] != ((2,) if is_complex else ()):
        raise ValueError("pack_gell: row/col/values must be 1-D of equal length")
    nnz = r.shape[0]
    if min(n_rows, n_cols) < 0 or max(n_rows, n_cols, nnz) > _INT32_MAX:
        raise ValueError("pack_gell: nnz and both dimensions must fit int32")
    if nnz and (r.min() < 0 or r.max() >= n_rows or c.min() < 0 or c.max() >= n_cols):
        raise ValueError("Sparse indices out of range")
    key = r * n_cols + c
    if nnz and (key[1:] < key[:-1]).any():  # a sorted COO (a CSR's) skips the sort
        order = np.argsort(key, kind="stable")
        c, values = c[order], values[torch.from_numpy(order)]
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=indptr[1:])
    device = resolve_device(device)
    return GELLPack(
        indptr=torch.from_numpy(indptr.astype(np.int32)).to(device),
        indices=torch.from_numpy(c.astype(np.int32)).to(device),
        values=values.contiguous().to(device),
        shape=(n_rows, n_cols), group=group_width(nnz, n_rows), tile_rows=tile_rows,
        is_complex=is_complex)


def pack_gell(row, col, values, shape, tile_rows: int | None = None,
              device=None) -> GELLPack:
    """Host-side packing of COO triplets on ``device`` (default: the card).
    Duplicates are kept and sum in the product, as in the JAX pack. Complex
    values are stored as (re, im) pairs, f64 for complex128, else f32."""
    v = np.asarray(values)
    if v.dtype.kind == "c":
        rdt = np.float64 if v.dtype.itemsize > 8 else np.float32
        pairs = np.stack([v.real, v.imag], axis=-1).astype(rdt)
        return build_pack(row, col, torch.from_numpy(pairs), shape, is_complex=True,
                          tile_rows=tile_rows, device=device)
    return build_pack(row, col, to_tensor(v), shape, is_complex=False,
                      tile_rows=tile_rows, device=device)


def unpack_gell_leaves(seg_packed, val, inv, sp_rows, sp_cols, sp_vals,
                       tile_rows: int, is_complex: bool):
    """Decode the JAX package's GELL pack (its leaves as numpy arrays) back to
    COO: (row, col, values), values (nnz,) or (nnz, 2) (re, im) pairs in the
    pack's dtype, the entries in no particular order, duplicates kept.

    Each valid ``inv[t, g*128 + l, j]`` (bit 7) names the head slot ``hs`` of
    row ``t*tile_rows + g*128 + j``'s run in bucket ``l`` of tile ``t``; the
    run goes on to the next slot while a member's m1 bit is set (bit 13 of an
    int16 segment word, bit 16 of an int32 one); a member's column is
    ``seg*128 + l``. The COO spill tail is appended."""
    seg_arr = np.asarray(seg_packed)
    if seg_arr.dtype == np.int16:
        word = seg_arr.astype(np.int32) & 0xFFFF
        seg, more = word & ((1 << _SEG16_BITS) - 1), (word >> _SEG16_BITS) & 1
    else:
        word = seg_arr.astype(np.int64)
        seg, more = word & 0xFFFF, (word >> 16) & 1
    val = np.asarray(val)
    n_tiles = seg.shape[0]
    inv4 = (np.asarray(inv).astype(np.int32) & 0xFF).reshape(n_tiles, -1, LANES, LANES)
    t, g, lane, j = np.nonzero(inv4 & 0x80)
    head = inv4[t, g, lane, j] & 0x7F
    # run[t, l, s]: members from slot s to the end of its run
    run = np.ones(seg.shape, np.int64)
    for s in range(LANES - 2, -1, -1):
        run[:, :, s] += more[:, :, s] * run[:, :, s + 1]
    length = run[t, lane, head]
    member = np.repeat(np.arange(len(t)), length)
    step = np.arange(int(length.sum())) - np.repeat(np.cumsum(length) - length, length)
    mt, ml, ms = t[member], lane[member], head[member] + step
    rows = (t * tile_rows + g * LANES + j)[member]
    cols = seg[mt, ml, ms] * LANES + ml
    sp_vals = np.asarray(sp_vals)
    if is_complex:
        vals = np.stack([val[mt, 0, ml, ms], val[mt, 1, ml, ms]], axis=-1)
        spill = sp_vals.T
    else:
        vals, spill = val[mt, ml, ms], sp_vals
    return (np.concatenate([rows, np.asarray(sp_rows, np.int64)]),
            np.concatenate([cols, np.asarray(sp_cols, np.int64)]),
            np.concatenate([vals, spill.astype(vals.dtype)]))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the JAX package's XLA branches)
# --------------------------------------------------------------------------

def _row_ids(pack: GELLPack) -> torch.Tensor:
    counts = (pack.indptr[1:] - pack.indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(pack.shape[0], device=pack.device), counts)


def gell_matvec_plain(pack: GELLPack, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` by a gather of x, a product and ``index_add_`` into y, in
    x's dtype (JAX :533-562; a complex pack computes in complex128 for a
    complex128 x, else complex64)."""
    rows, cols = _row_ids(pack), pack.indices.long()
    if pack.is_complex:
        rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
        v = pack.values.to(rdt)
        vals = torch.complex(v[:, 0], v[:, 1])
        xs = x.to(vals.dtype)
        y = torch.zeros(pack.shape[0], dtype=vals.dtype, device=x.device)
        return y.index_add_(0, rows, vals * xs[cols]).to(x.dtype)
    y = torch.zeros(pack.shape[0], dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, pack.values.to(x.dtype) * x[cols])


def gell_matvec_planes_plain(pack: GELLPack, x_planes: torch.Tensor) -> torch.Tensor:
    """Complex pack times (2, n_cols) re/im planes -> (2, n_rows) planes in
    the planes' dtype: ``y_re = A_re x_re - A_im x_im``,
    ``y_im = A_re x_im + A_im x_re``."""
    rows, cols = _row_ids(pack), pack.indices.long()
    v = pack.values.to(x_planes.dtype)
    vr, vi = v[:, 0], v[:, 1]
    xr, xi = x_planes[0][cols], x_planes[1][cols]
    y = torch.zeros((2, pack.shape[0]), dtype=x_planes.dtype, device=x_planes.device)
    y[0].index_add_(0, rows, vr * xr - vi * xi)
    y[1].index_add_(0, rows, vr * xi + vi * xr)
    return y


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check_operands(name: str, pack: GELLPack, vec: torch.Tensor, dtype: torch.dtype) -> None:
    for label, t in (("pack", pack.values), ("vector", vec)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} on {t.device}, expected a CUDA device")
    if vec.device != pack.device:
        raise ValueError(f"{name}: pack on {pack.device}, vector on {vec.device}")
    if pack.values.dtype not in _VALUE_CODES:
        raise TypeError(f"{name}: unsupported value dtype {pack.values.dtype}")
    if vec.dtype != dtype:
        raise TypeError(f"{name}: vector dtype {vec.dtype} does not match {dtype} for "
                        f"{pack.dtype} values")
    if not (pack.values.is_contiguous() and pack.indices.is_contiguous()
            and pack.indptr.is_contiguous()):
        raise ValueError(f"{name}: pack tensors must be contiguous")
    if pack.is_complex and pack.values.data_ptr() % (2 * pack.values.element_size()):
        raise ValueError(f"{name}: complex value pairs must be aligned to a pair")


def _launch(name: str, pack: GELLPack, x: torch.Tensor, mode: int, x_plane: int,
            y: torch.Tensor) -> None:
    lib = _build.load()
    rc = lib.gell_csr_spmv(
        _VALUE_CODES[pack.values.dtype], x.device.index, mode, pack.indptr.data_ptr(),
        pack.indices.data_ptr(), pack.values.data_ptr(), x.data_ptr(), x_plane,
        pack.shape[0], pack.group, y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): "
                           f"{lib.dia_cuda_error_string(rc).decode()}")


def gell_kernel(pack: GELLPack, x: torch.Tensor) -> torch.Tensor:
    """B6 on the card: ``A @ x`` with x an (n_cols,) contiguous vector of
    dtype ``pack.vector_dtype`` (complex64/complex128 for a complex pack).
    A pack with no rows or no entries launches nothing: y is empty or zero."""
    n_rows, n_cols = pack.shape
    if x.shape != (n_cols,):
        raise ValueError(f"gell_kernel: expected an ({n_cols},) vector, got {tuple(x.shape)}")
    _check_operands("gell_kernel", pack, x, pack.vector_dtype)
    if not x.is_contiguous():
        raise ValueError("gell_kernel: vector must be contiguous")
    if pack.nnz == 0:
        return torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    _launch("gell_kernel", pack, x, _MODE_COMPLEX if pack.is_complex else _MODE_REAL, 0, y)
    gell_kernel.launches += 1
    return y


gell_kernel.launches = 0


def gell_planes_kernel(pack: GELLPack, x_planes: torch.Tensor) -> torch.Tensor:
    """B6 cpx on the card: a complex pack times (2, n_cols) re/im planes of
    dtype ``pack.vector_dtype.to_real()``, unit stride along a plane and any
    stride between the planes -> (2, n_rows) planes."""
    if not pack.is_complex:
        raise TypeError("gell_planes_kernel: the pack is not complex")
    n_rows, n_cols = pack.shape
    if x_planes.shape != (2, n_cols):
        raise ValueError(f"gell_planes_kernel: expected (2, {n_cols}) planes, got "
                         f"{tuple(x_planes.shape)}")
    _check_operands("gell_planes_kernel", pack, x_planes, pack.vector_dtype.to_real())
    if n_cols > 1 and x_planes.stride(1) != 1:
        raise ValueError("gell_planes_kernel: planes must have unit stride along a plane")
    if pack.nnz == 0:
        return torch.zeros((2, n_rows), dtype=x_planes.dtype, device=x_planes.device)
    y = torch.empty((2, n_rows), dtype=x_planes.dtype, device=x_planes.device)
    _launch("gell_planes_kernel", pack, x_planes, _MODE_PLANES, x_planes.stride(0), y)
    gell_planes_kernel.launches += 1
    return y


gell_planes_kernel.launches = 0

KERNELS = (gell_kernel, gell_planes_kernel)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


# --------------------------------------------------------------------------
# Dispatchers
# --------------------------------------------------------------------------

def gell_matvec(pack: GELLPack, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a pack. On the card x must have dtype
    ``pack.vector_dtype``, and so has the result; on the CPU the result has
    x's dtype, as in JAX. JAX's ``force`` ("pallas", "interpret", "xla") has
    no counterpart: where the pack lies decides."""
    if pack.device.type == "cpu":
        return gell_matvec_plain(pack, x)
    return gell_kernel(pack, x)


def gell_matvec_planes(pack: GELLPack, x_planes: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a complex pack with x as (2, n_cols) re/im planes,
    returning (2, n_rows) planes in the planes' dtype (the JAX entry point
    for backends without complex dtypes; no ``force``, as above)."""
    if not pack.is_complex:
        raise ValueError("gell_matvec_planes: pack is not complex")
    if pack.device.type == "cpu":
        return gell_matvec_planes_plain(pack, x_planes)
    return gell_planes_kernel(pack, x_planes)
