"""General (unstructured) sparse SpMV: the CUDA kernel B6 for the H100, its
plain versions and the pack it reads.

Counterpart of the JAX package's ``ops/pallas/gell_spmv.py``. The JAX pack
("packed gather-ELL") is shaped for the TPU's 128-lane gather and its VMEM;
on the card ``pack_gell`` keeps the JAX name but builds two layouts of the
same COO, each read by a kernel written by hand:

- **CSR** (``indptr``, ``indices``, ``values``; complex values as (re, im)
  pairs), duplicates kept, since the kernel sums them as the JAX run scan
  does. ``csrc/gell_spmv.cu`` gives each row a group of ``group`` lanes
  that gather x from L2 (one 32-byte sector per entry, two on planes).
  On real values, rows of more than ``LONG_ROW`` entries are cut into
  chunks of at most ``SPLIT_CHUNK`` entries within one window of
  ``SPLIT_WINDOW`` columns, one block a chunk, in the same launch, window by
  window (``GELLSplit``, built with the pack): a hub row no longer runs on
  one group, and the blocks resident at once gather from one window of x.
- **Windows** (``GELLWindows``, ``window_layout``): rows cut into ranges of
  ``R`` rows, about one range per SM that a launch holds at once, columns
  into windows of ``W`` columns (``W`` x the bytes of an x element <= 64 KB,
  16384 columns in f32, the JAX chunk width), entries ordered by (range,
  window, row, column) with a 16-bit local row and a 16-bit local column in
  one 32-bit word; ranges grouped in clusters of ``cluster`` blocks, each
  with the union of the windows its ranges touch (JAX's ``chunk_ids``).
  ``csrc/gell_window_spmv.cu`` stages those x windows in shared memory by
  TMA bulk copies, double-buffered, and gathers from there. Each block
  stages its own windows: the packs are built with clusters of one block
  (``WINDOW_CLUSTER``), since multicasting a window to clusters of 2 or 4
  was slower in every case measured (PERF.md); ``with_windows`` still
  builds those for comparison.

**Which layout runs** (``pick_route``), computed from the pack: the windows
when the bytes they stage, ``staged windows x W x (bytes of an x element)``
(one copy per cluster window), are fewer than the sectors CSR gathers,
``nnz x 32 B x sectors per entry`` (2 on planes, else 1). A very wide, very
sparse operator stages windows for a handful of entries and stays on CSR;
the windowed layout is kept only when the rule picks it for the planes
entry of a complex pack or for the native entry. Both routes are kernels:
this is a dispatch, not a fallback, and a route that fails to build or
launch raises. ``ROUTE_LAUNCHES`` counts the launches of each. The route,
the checks of the pack and the C call's fixed arguments are resolved once
per pack and entry (``_launcher``), so that a call's host work is the
vector's checks and one ctypes call of five arguments.

- ``gell_kernel`` (B6): ``y = A x`` for a real pack (f32, bf16 or f64
  values) and for a complex pack on native complex64/complex128 vectors;
- ``gell_planes_kernel`` (B6 cpx): a complex pack times (2, n_cols) re/im
  planes -> (2, n_rows) planes.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and counts its launches in ``.launches`` (either route). The
dispatchers ``gell_matvec`` and ``gell_matvec_planes`` run the plain PyTorch
version when the pack lies on the CPU and the kernel otherwise: a pack on a
CUDA device launches a kernel or raises. ``gell_window_matvec_plain`` (and
its planes form) computes y from the windowed arrays alone.

**Where the pack is built** (``pack_device``): on ``device`` when given,
else where COO tensors on a card lie, else on the card; host arrays are
copied there first. One pack serves every input (``_device_pack``): row
counts by ``bincount`` into ``indptr``, then, a piece of whole rows of about
``PACK_CHUNK`` entries at a time, the piece's entries found by a scan of the
COO, sorted by (row, column) and written in place. No int64 array or sort
spans all entries, so a COO of ~2e9 entries packs beside its own 25 GB on
one 80 GB card. The windowed layout's rule is counted piece by piece too,
and the layout is built only where the rule keeps it (``_window_layout``).

Not ported, as they serve the TPU only: the lane buckets, the int16/int32
segment word and its mask bits, the suffix scan, the int8 inverse
permutation, the transposed x, the spill tail, ``auto_tile_rows``,
``_XT_VMEM_BUDGET`` and the dtype gate of ``_use_pallas``.
``unpack_gell_leaves`` decodes a JAX pack back to COO (its copy of the
pack's logic), so a JAX operator can be carried across.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import as_torch_dtype
from ..utils.interop import to_tensor
from ..utils.timing import annotate, count
from . import _build

LANES = 128
_INT32_MAX = 2 ** 31 - 1
_SEG16_BITS = 13  # the JAX pack's int16 segment word: 13-bit segment, then the mask bits

# Value-type codes of csrc/gell_spmv.cu (those of csrc/dia_spmv.cu) and its modes.
_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_MODE_REAL, _MODE_COMPLEX, _MODE_PLANES = 0, 1, 2

WINDOW_BYTES = 64 * 1024          # an x window in shared memory (one buffer)
WINDOW_BUFFERS = 2                # csrc/gell_window_spmv.cu::kStages: double-buffered
WINDOW_SMEM = 227 * 1024 - 1024   # csrc/gell_window_spmv.cu::kSmemBudget
WINDOW_CLUSTER = 1                # blocks a cluster: multicast of the windows did not pay (PERF.md)
CLUSTER_SIZES = (1, 2, 4)
NOMINAL_SMS = 132                 # a CPU pack's ranges: as on the H100's 132 SMs
SECTOR_BYTES = 32                 # what one gather of x moves from L2
PACK_CHUNK = 1 << 27              # entries a step of a device pack or of the window rule takes
# A row is long above LONG_ROW entries, and split: on the H100 at Graph 500
# SCALE 26, B6 took 35.9 ms a call split above 1024 (2^24-column windows),
# 37.8 above 4096 (2^22) and 43.5 above 16384, against 53.1 unsplit
LONG_ROW = 1024
# The most entries a block of a long row takes: 16 a thread of 256; 8 a
# thread measured the same there (37.7-37.8 ms against 37.8)
SPLIT_CHUNK = 4096
# Columns a window of a split (64 MB of f32 x): with 1024-entry rows split,
# finer windows cut their chunks too small (PERF.md §6)
SPLIT_WINDOW = 1 << 24


def group_width(nnz: int, n_rows: int) -> int:
    """Lanes per row: the smallest power of two at or above the mean row
    length, clamped to [4, 32] (32 at 33 entries a row, 8 at 6)."""
    mean = -(-nnz // max(n_rows, 1))
    g = 4
    while g < mean and g < 32:
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class GELLWindows:
    """The windowed layout of a pack (see the module docstring).

    Union row ``g`` of cluster ``k``, for ``g`` in ``[uptr[k], uptr[k+1])``,
    names window ``uwin[g]`` (the cluster's last row is a sentinel, window
    ``ceil(n_cols / cols)``); ``uoff[g * cluster + r]`` is the first entry there of
    the cluster's range ``r`` (at the sentinel: the range's end)."""

    words: torch.Tensor   # (nnz,) int32: local row << 16 | local column
    values: torch.Tensor  # (nnz,) or (nnz, 2): the pack's values in window order
    rows: int             # R, rows a range
    cols: int             # W, columns a window
    cluster: int
    n_ranges: int         # a multiple of cluster; ranges past the last row are empty
    uptr: torch.Tensor    # (n_ranges / cluster + 1,) int32
    uwin: torch.Tensor    # (union rows,) int32
    uoff: torch.Tensor    # (union rows * cluster,) int32
    staged_windows: int   # union windows over all clusters, sentinels not counted
    staged_bytes: int     # what the launch copies into shared memory: staged windows x W x
                          # the bytes of an x element


@dataclasses.dataclass(frozen=True)
class GELLSplit:
    """The rows of a pack longer than ``LONG_ROW`` entries, cut into chunks
    that B6's CSR route runs one block each, in the same launch as the other
    rows (``csrc/gell_spmv.cu``): a chunk holds at most ``SPLIT_CHUNK``
    entries of one row within one window of ``SPLIT_WINDOW`` columns.

    Long row ``i`` is row ``rows[i]``; its chunks are ``[first[i], first[i +
    1])``, in entry order; chunk ``c`` belongs to long row ``chunk_row[c]``
    and runs from entry ``chunk_start[c]`` to the next chunk's start (the
    row's end for its last). Block ``b`` runs chunk ``order[b]``: window by
    window, so the blocks resident at once gather from one window of x.
    ``counters`` (one a long row, 0 between calls) and ``partials`` (8 bytes
    a chunk, one accumulator) are the kernel's: see ``gell_kernel`` on
    calls that share a split."""

    long_row: int              # rows of more entries are long (``LONG_ROW`` when built)
    rows: torch.Tensor         # (n_long,) int32, ascending
    first: torch.Tensor        # (n_long + 1,) int32
    chunk_row: torch.Tensor    # (n_chunks,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int64
    order: torch.Tensor        # (n_chunks,) int32
    counters: torch.Tensor     # (n_long,) int32
    partials: torch.Tensor     # (n_chunks,) float64

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_row.shape[0])


def split_long_rows(indptr: torch.Tensor, indices: torch.Tensor,
                    n_cols: int) -> GELLSplit | None:
    """The split of the rows of a CSR (int32 ``indptr`` and ``indices``, on
    the pack's device) longer than ``LONG_ROW`` entries; None where there is
    none. One pass over the rows in int32; the long rows' entries are counted
    by window a piece of about ``PACK_CHUNK`` at a time, so what is int64
    spans one piece, the long rows and their chunks."""
    dev = indptr.device
    long = torch.nonzero(indptr[1:] - indptr[:-1] > LONG_ROW).squeeze(1)
    if long.numel() == 0:
        return None
    begin = indptr[long].long()
    lengths = indptr[long + 1].long() - begin
    n_windows = max(-(-n_cols // SPLIT_WINDOW), 1)
    # seg[i, w]: entries of long row i in window w (columns ascend in a row)
    seg = torch.zeros((long.numel(), n_windows), dtype=torch.int64, device=dev)
    if n_windows == 1:
        seg[:, 0] = lengths
    else:
        ends = torch.cumsum(lengths, 0)
        cuts = _chunk_bounds(torch.cat([ends.new_zeros(1), ends]), PACK_CHUNK)
        for a, b in zip(cuts, cuts[1:]):
            n = lengths[a:b]
            at = torch.repeat_interleave(begin[a:b] - (torch.cumsum(n, 0) - n), n)
            at += torch.arange(at.numel(), device=dev)
            key = indices[at].long()
            del at
            key //= SPLIT_WINDOW
            key += torch.repeat_interleave(torch.arange(a, b, device=dev) * n_windows, n)
            seg.view(-1).add_(torch.bincount(key, minlength=seg.numel()))
            del key
    chunks = (seg + SPLIT_CHUNK - 1) // SPLIT_CHUNK
    seg_start = begin[:, None] + torch.cumsum(seg, 1) - seg
    first = torch.zeros(long.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(chunks.sum(1), 0, out=first[1:])
    flat = chunks.view(-1)
    seg_of = torch.repeat_interleave(torch.arange(flat.numel(), device=dev), flat)
    within = torch.arange(seg_of.numel(), device=dev) - (torch.cumsum(flat, 0) - flat)[seg_of]
    chunk_start = seg_start.view(-1)[seg_of] + within * SPLIT_CHUNK
    order = torch.argsort(seg_of % n_windows, stable=True)
    return GELLSplit(long_row=LONG_ROW, rows=long.to(torch.int32), first=first.to(torch.int32),
                     chunk_row=(seg_of // n_windows).to(torch.int32), chunk_start=chunk_start,
                     order=order.to(torch.int32),
                     counters=torch.zeros(long.numel(), dtype=torch.int32, device=dev),
                     partials=torch.zeros(seg_of.numel(), dtype=torch.float64, device=dev))


@dataclasses.dataclass(frozen=True)
class GELLPack:
    """One general sparse operator as row-sorted CSR on one device, with its
    windowed layout in ``windows`` where the route rule picks it.

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
    windows: GELLWindows | None = None  # the windowed layout, when the rule picks it
    split: GELLSplit | None = None      # real values' long rows, if any (``split_long_rows``)
    # (planes, route) -> the launch resolved for this pack (``_launcher``); a
    # replaced pack starts with none
    _launchers: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                         compare=False)

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
        value bytes; the kernel accumulates in f32 regardless). The windowed
        layout is built anew, since its shape follows the vector dtype."""
        dt = as_torch_dtype(dtype)
        if dt not in _VALUE_CODES:
            raise TypeError(f"GELLPack.with_values_dtype: values are float32, bfloat16 or "
                            f"float64, got {dt}")
        return attach_windows(dataclasses.replace(self, values=self.values.to(dt), windows=None))


def pack_device(device, *arrays) -> torch.device:
    """Where a pack of ``arrays`` is built: ``device`` when given, else
    where those of them that are tensors on a card lie, else on the card
    (``resolve_device``), as for host arrays and CPU tensors."""
    if device is None:
        on_card = [a.device for a in arrays if isinstance(a, torch.Tensor) and a.device.type != "cpu"]
        if on_card:
            return on_card[0]
    return resolve_device(device)


def index_tensor(a, device: torch.device) -> torch.Tensor:
    """Row or column indices on ``device``: a tensor moved (not copied where
    it lies, its integer dtype kept), host input as int64."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def value_tensor(a, device: torch.device) -> torch.Tensor:
    """Values on ``device``: a tensor moved, host input copied."""
    return a.to(device) if isinstance(a, torch.Tensor) else to_tensor(a, device=device)


def build_pack(row, col, values, shape, *, is_complex: bool,
               tile_rows: int | None = None, device=None) -> GELLPack:
    """The CSR pack of COO triplets: entries sorted by (row, col), stably
    (duplicates keep their order and sum in the product), with its windowed
    layout where the rule picks it, under the span ``eigsol.gell.pack``
    (the sort under ``eigsol.gell.sort``, the layout under
    ``eigsol.gell.windows``) and counted in ``gell_pack_entries``.

    ``row`` and ``col`` are integer tensors or host arrays; ``values`` is
    (nnz,) f32, bf16 or f64, or (nnz, 2) (re, im) pairs when ``is_complex``.
    Built on ``pack_device(device, row, col, values)`` (``_device_pack``)."""
    n_rows, n_cols = map(int, shape)
    if tile_rows is not None and tile_rows % LANES != 0:
        raise ValueError("pack_gell: tile_rows must be a multiple of 128")
    dev = pack_device(device, row, col, values)
    with annotate("eigsol.gell.pack"):
        pack = _device_pack(index_tensor(row, dev), index_tensor(col, dev),
                            value_tensor(values, dev), n_rows, n_cols, is_complex, tile_rows)
        count("gell_pack_entries", pack.nnz)
        with annotate("eigsol.gell.windows"):
            return attach_windows(pack)


def _chunk_bounds(starts: torch.Tensor, chunk: int) -> list:
    """Boundaries that cut units (rows, or clusters of ranges) into pieces
    of about ``chunk`` entries, unit ``i`` holding entries ``[starts[i],
    starts[i + 1])`` (int64, ascending): a piece is the units whose first
    entry lies in one stretch ``[k chunk, (k + 1) chunk)``, so it holds at
    most ``chunk`` entries and the rest of its last unit. Sorted, 0 and the
    number of units included."""
    stretch = starts[:-1] // chunk
    cuts = torch.nonzero(stretch[1:] != stretch[:-1]).squeeze(1) + 1
    return sorted({0, starts.numel() - 1, *cuts.tolist()})


def _device_pack(row: torch.Tensor, col: torch.Tensor, values: torch.Tensor, n_rows: int,
                 n_cols: int, is_complex: bool, tile_rows: int | None) -> GELLPack:
    """The pack of COO tensors that lie on one device, built there.

    Row counts come from ``bincount`` (``PACK_CHUNK`` entries a call) into
    an int64 ``indptr``; then each piece of whole rows holding about
    ``PACK_CHUNK`` entries (``_chunk_bounds``) finds its entries by a scan
    of ``row``, in input order, sorts them stably by (row, column) on an
    int64 key of the piece alone and writes their columns and values at the
    piece's place. Beyond its inputs and output the pack holds the int64
    counts and ``indptr`` (16 B a row) and one piece's positions, keys, sort
    and gathers (~40 B an entry of the piece, ~5 GiB at ``PACK_CHUNK``); with
    the window rule's pieces and ``SparseGELL``'s ``diag``, 7.3 GiB beyond a
    COO of 2.1e9 entries (23.5 GiB) and its pack (15.9 GiB) on an H100: under
    a third of the COO's bytes."""
    if values.dtype not in _VALUE_CODES:
        raise TypeError(f"pack_gell: unsupported value dtype {values.dtype}")
    if row.dtype.is_floating_point or row.dtype.is_complex or row.dtype == torch.bool \
            or col.dtype.is_floating_point or col.dtype.is_complex or col.dtype == torch.bool:
        raise TypeError("pack_gell: row and col must be integer tensors")
    if row.ndim != 1 or row.shape != col.shape or values.shape[:1] != row.shape \
            or values.shape[1:] != ((2,) if is_complex else ()):
        raise ValueError("pack_gell: row/col/values must be 1-D of equal length")
    dev = values.device
    nnz = row.numel()
    if min(n_rows, n_cols) < 0 or max(n_rows, n_cols, nnz) > _INT32_MAX:
        raise ValueError("pack_gell: nnz and both dimensions must fit int32")
    steps = range(0, nnz, PACK_CHUNK)
    if nnz:
        ends = torch.stack([torch.stack([t.min(), t.max()]).long()
                            for s in steps for t in (row[s:s + PACK_CHUNK], col[s:s + PACK_CHUNK])])
        lo, hi = ends[:, 0].view(-1, 2).amin(0), ends[:, 1].view(-1, 2).amax(0)
        if bool((lo < 0).any() | (hi[0] >= n_rows) | (hi[1] >= n_cols)):
            raise ValueError("Sparse indices out of range")
    counts = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    for s in steps:
        counts += torch.bincount(row[s:s + PACK_CHUNK], minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    del counts
    indices = torch.empty(nnz, dtype=torch.int32, device=dev)
    vals = torch.empty(values.shape, dtype=values.dtype, device=dev)
    cuts = _chunk_bounds(indptr, PACK_CHUNK)
    firsts = indptr[cuts].tolist()
    with annotate("eigsol.gell.sort"):
        for a, b, s, e in zip(cuts, cuts[1:], firsts, firsts[1:]):
            if e == s:
                continue
            pos = torch.cat([((row[t:t + PACK_CHUNK] >= a) & (row[t:t + PACK_CHUNK] < b))
                             .nonzero().squeeze(1) + t for t in steps])
            key = (row[pos].long() - a) * n_cols + col[pos].long()
            order = torch.sort(key, stable=True).indices
            del key
            src = pos[order]
            del pos, order
            indices[s:e] = col[src]
            vals[s:e] = values[src]
            del src
    indptr = indptr.to(torch.int32)
    return GELLPack(indptr=indptr, indices=indices, values=vals, shape=(n_rows, n_cols),
                    group=group_width(nnz, n_rows), tile_rows=tile_rows, is_complex=is_complex,
                    split=None if is_complex else split_long_rows(indptr, indices, n_cols))


# --------------------------------------------------------------------------
# The windowed layout
# --------------------------------------------------------------------------

def x_element_bytes(pack: GELLPack) -> int:
    """Bytes of one x element on the card: re and im together for a complex
    pack (native or planes)."""
    return torch.empty((), dtype=pack.vector_dtype).element_size()


def _capacity(device: torch.device, cluster: int) -> int:
    """Clusters of the windowed kernel the device runs at once (one wave);
    for a pack off the card, as on the H100's 132 SMs."""
    if device.type != "cuda":
        return max(NOMINAL_SMS // cluster, 1)
    lib = _build.load()
    count = ctypes.c_int(0)
    rc = lib.gell_window_capacity(device.index if device.index is not None else
                                  torch.cuda.current_device(), cluster, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"gell_window_capacity: CUDA call failed ({rc}): "
                           f"{lib.dia_cuda_error_string(rc).decode()}")
    return max(count.value, 1)


def window_shape(pack: GELLPack, cluster: int = WINDOW_CLUSTER, rows: int | None = None,
                 cols: int | None = None):
    """``(R, W, n_ranges)`` of the windowed layout: ``W`` fills
    ``WINDOW_BYTES`` with x elements; ``R`` spreads the rows over the
    clusters that one wave of the launch holds, in multiples of 32, with the
    partial sums (``R`` x the accumulator's bytes, twice for complex) in
    what shared memory has left beside the two window buffers, and at most
    65536 (16-bit local rows). ``rows`` and ``cols`` override (small shapes
    for tests)."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"window_layout: cluster {cluster} not in {CLUSTER_SIZES}")
    n_rows = pack.shape[0]
    W = int(cols) if cols is not None else WINDOW_BYTES // x_element_bytes(pack)
    xe = x_element_bytes(pack)  # also the bytes of a row's partial sum (a pair if complex)
    r_max = min(65536, (WINDOW_SMEM - WINDOW_BUFFERS * (W * xe + 32)) // xe)
    if rows is not None:
        R = int(rows)
    else:
        per = -(-n_rows // (_capacity(pack.device, cluster) * cluster))
        R = min(max(32, -(-per // 32) * 32), r_max)
    if not 1 <= R <= r_max or not 1 <= W <= 65536:
        raise ValueError(f"window_layout: R = {R} rows, W = {W} columns do not fit "
                         f"(R <= {r_max}, W <= 65536)")
    n_ranges = -(-max(-(-n_rows // R), 1) // cluster) * cluster
    return R, W, n_ranges


def _rule_keeps(staged_bytes: int, nnz: int, planes: bool) -> bool:
    return staged_bytes < nnz * SECTOR_BYTES * (2 if planes else 1)


def _window_layout(pack: GELLPack, cluster: int, rows: int | None, cols: int | None,
                   planes: bool | None) -> GELLWindows | None:
    """The layout (see ``window_layout``); with ``planes`` given, None when
    ``window_rule`` would refuse it. The CSR is taken a piece of whole
    clusters, about ``PACK_CHUNK`` entries, at a time (``_chunk_bounds``). The
    rule is read off each piece's union windows, before any entry is sorted,
    and stops at the first piece that takes the staged bytes to CSR's: a
    refused layout is never built. Where it is kept, each piece's entries
    are sorted by (range, window) on their own, since a piece holds whole
    ranges; no int64 array spans all entries. The rule reads an entry's
    cluster, the layout its row."""
    R, W, n_ranges = window_shape(pack, cluster, rows, cols)
    dev = pack.device
    n_rows, nnz = pack.shape[0], pack.nnz
    n_windows = max(-(-pack.shape[1] // W), 1)
    n_clusters = n_ranges // cluster
    slots = n_windows + 1  # windows of a cluster, then its sentinel
    xe = x_element_bytes(pack)
    indptr = pack.indptr.long()
    span = R * cluster  # rows a cluster
    starts = indptr[torch.clamp(torch.arange(n_clusters + 1, device=dev) * span, max=n_rows)]
    cuts = _chunk_bounds(starts, PACK_CHUNK)
    row_cuts = [min(k * span, n_rows) for k in cuts]
    firsts = starts[cuts].tolist()
    pieces = list(zip(cuts, cuts[1:], row_cuts, row_cuts[1:], firsts, firsts[1:]))

    unions, staged = [], 0
    for k0, k1, _, _, s, e in pieces:
        cluster_of = torch.repeat_interleave(torch.arange(k0, k1, device=dev),
                                             starts[k0 + 1:k1 + 1] - starts[k0:k1])
        unions.append(torch.unique(cluster_of * slots + pack.indices[s:e].long() // W))
        del cluster_of
        staged += unions[-1].numel()
        if planes is not None and not _rule_keeps(staged * W * xe, nnz, planes):
            return None
    words = torch.empty(nnz, dtype=torch.int32, device=dev)
    values = torch.empty_like(pack.values)
    union_rows, uoff = [], []
    for (k0, k1, r0, r1, s, e), union in zip(pieces, unions):
        rows_of = torch.repeat_interleave(torch.arange(r0, r1, device=dev),
                                          indptr[r0 + 1:r1 + 1] - indptr[r0:r1])
        cols_of = pack.indices[s:e].long()
        key, order = torch.sort((rows_of // R) * n_windows + cols_of // W, stable=True)
        word = ((rows_of % R) << 16 | (cols_of % W))[order]
        words[s:e] = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
        values[s:e] = pack.values[s:e][order]
        sentinels = torch.arange(k0, k1, device=dev) * slots + n_windows
        union = torch.sort(torch.cat([union, sentinels])).values
        g_row, w_row = union // slots, union % slots
        ranges = g_row[:, None] * cluster + torch.arange(cluster, device=dev)[None, :]
        uoff.append(torch.searchsorted(key, (ranges * n_windows + w_row[:, None]).reshape(-1)) + s)
        union_rows.append(union)
    union = torch.cat(union_rows)
    g_row, w_row = union // slots, union % slots
    uptr = torch.zeros(n_clusters + 1, dtype=torch.int64, device=dev)
    uptr[1:] = torch.cumsum(torch.bincount(g_row, minlength=n_clusters), 0)
    return GELLWindows(words=words, values=values, rows=R, cols=W, cluster=cluster,
                       n_ranges=n_ranges, uptr=uptr.to(torch.int32), uwin=w_row.to(torch.int32),
                       uoff=torch.cat(uoff).to(torch.int32), staged_windows=staged,
                       staged_bytes=staged * W * xe)


def window_layout(pack: GELLPack, cluster: int = WINDOW_CLUSTER, rows: int | None = None,
                  cols: int | None = None) -> GELLWindows:
    """The windowed layout of a pack, built from its CSR where the pack lies
    (one stable sort of the entries by (range, window); the CSR order keeps
    (row, column) within). Duplicates stay and sum in the product."""
    return _window_layout(pack, cluster, rows, cols, None)


def window_rule(pack: GELLPack, windows: GELLWindows, planes: bool = False) -> bool:
    """True when the windowed layout moves fewer bytes than CSR's gathers:
    ``staged windows x W x x element bytes < nnz x 32 B x sectors per entry``
    (2 sectors on planes, re and im a plane apart; 1 otherwise)."""
    return _rule_keeps(windows.staged_bytes, pack.nnz, planes)


def attach_windows(pack: GELLPack, cluster: int = WINDOW_CLUSTER) -> GELLPack:
    """The pack with its windowed layout where the rule picks it (for the
    native entry, or the planes entry of a complex pack), else without; the
    rule is read off the union windows, so a refused layout is never
    built."""
    if pack.nnz == 0 or pack.shape[0] == 0 or pack.device.type == "meta":
        return pack
    return dataclasses.replace(
        pack, windows=_window_layout(pack, cluster, None, None, planes=pack.is_complex))


def with_windows(pack: GELLPack, cluster: int = WINDOW_CLUSTER, rows: int | None = None,
                 cols: int | None = None) -> GELLPack:
    """The pack with a windowed layout of the given cluster size, whatever
    the rule says (to time or test the windowed route on any pack)."""
    return dataclasses.replace(pack, windows=window_layout(pack, cluster, rows, cols))


def pick_route(pack: GELLPack, planes: bool = False) -> str:
    """``"windows"`` when the pack has a windowed layout and the rule
    prefers it for this entry, else ``"csr"``."""
    if pack.windows is not None and window_rule(pack, pack.windows, planes):
        return "windows"
    return "csr"


def pack_gell(row, col, values, shape, tile_rows: int | None = None,
              device=None) -> GELLPack:
    """Packing of COO triplets (``build_pack``) on ``pack_device(device,
    row, col, values)``: ``device`` when given, else where card tensors lie,
    else the card. Duplicates are kept and sum in the product, as in the JAX
    pack. Complex values are stored as (re, im) pairs, f64 for complex128,
    else f32."""
    dev = pack_device(device, row, col, values)
    v = value_tensor(values, dev)
    if v.is_complex():
        rdt = torch.float64 if v.dtype == torch.complex128 else torch.float32
        return build_pack(row, col, torch.view_as_real(v).to(rdt), shape, is_complex=True,
                          tile_rows=tile_rows, device=dev)
    return build_pack(row, col, v, shape, is_complex=False, tile_rows=tile_rows, device=dev)


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


def window_coo(pack: GELLPack, windows: GELLWindows | None = None):
    """The entries of the windowed layout as (row, column, values), in its
    order: range ``k`` of cluster ``k // cluster`` holds, in union window
    ``w``, entries ``[uoff[g, r], uoff[g + 1, r])``; an entry's row is
    ``k R + (word >> 16)`` and its column ``w W + (word & 0xffff)``."""
    win = windows if windows is not None else pack.windows
    if win is None:
        raise ValueError("window_coo: the pack has no windowed layout")
    c, dev = win.cluster, win.words.device
    off = win.uoff.long().view(-1, c)
    g_row = torch.repeat_interleave(torch.arange(win.uptr.numel() - 1, device=dev),
                                    (win.uptr[1:] - win.uptr[:-1]).long())
    live = (g_row[1:] == g_row[:-1])[:, None].expand(-1, c)  # row g, not a sentinel
    starts, lengths = off[:-1][live], (off[1:] - off[:-1])[live]
    ranges = (g_row[:-1, None] * c + torch.arange(c, device=dev))[live]
    windows_of = win.uwin.long()[:-1, None].expand(-1, c)[live]
    order = torch.argsort(starts, stable=True)
    lengths = lengths[order]
    word = win.words.long() & 0xFFFFFFFF
    rows = torch.repeat_interleave(ranges[order], lengths) * win.rows + (word >> 16)
    cols = torch.repeat_interleave(windows_of[order], lengths) * win.cols + (word & 0xFFFF)
    return rows, cols, win.values


def _matvec_coo(pack: GELLPack, rows, cols, values, x: torch.Tensor) -> torch.Tensor:
    if pack.is_complex:
        rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
        v = values.to(rdt)
        vals = torch.complex(v[:, 0], v[:, 1])
        xs = x.to(vals.dtype)
        y = torch.zeros(pack.shape[0], dtype=vals.dtype, device=x.device)
        return y.index_add_(0, rows, vals * xs[cols]).to(x.dtype)
    y = torch.zeros(pack.shape[0], dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, values.to(x.dtype) * x[cols])


def _matvec_planes_coo(pack: GELLPack, rows, cols, values, x_planes: torch.Tensor):
    v = values.to(x_planes.dtype)
    vr, vi = v[:, 0], v[:, 1]
    xr, xi = x_planes[0][cols], x_planes[1][cols]
    y = torch.zeros((2, pack.shape[0]), dtype=x_planes.dtype, device=x_planes.device)
    y[0].index_add_(0, rows, vr * xr - vi * xi)
    y[1].index_add_(0, rows, vr * xi + vi * xr)
    return y


def gell_matvec_plain(pack: GELLPack, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` by a gather of x, a product and ``index_add_`` into y, in
    x's dtype (JAX :533-562; a complex pack computes in complex128 for a
    complex128 x, else complex64), from the CSR arrays."""
    return _matvec_coo(pack, _row_ids(pack), pack.indices.long(), pack.values, x)


def gell_matvec_planes_plain(pack: GELLPack, x_planes: torch.Tensor) -> torch.Tensor:
    """Complex pack times (2, n_cols) re/im planes -> (2, n_rows) planes in
    the planes' dtype: ``y_re = A_re x_re - A_im x_im``,
    ``y_im = A_re x_im + A_im x_re``, from the CSR arrays."""
    return _matvec_planes_coo(pack, _row_ids(pack), pack.indices.long(), pack.values, x_planes)


def gell_window_matvec_plain(pack: GELLPack, x: torch.Tensor,
                             windows: GELLWindows | None = None) -> torch.Tensor:
    """``gell_matvec_plain`` computed from the windowed arrays alone
    (``window_coo``; default: the pack's layout)."""
    return _matvec_coo(pack, *window_coo(pack, windows), x)


def gell_window_matvec_planes_plain(pack: GELLPack, x_planes: torch.Tensor,
                                    windows: GELLWindows | None = None) -> torch.Tensor:
    """``gell_matvec_planes_plain`` computed from the windowed arrays alone."""
    return _matvec_planes_coo(pack, *window_coo(pack, windows), x_planes)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

class _CSRArgs(ctypes.Structure):
    """csrc/gell_spmv.cu::GellCSRArgs."""
    _fields_ = [("dtype", ctypes.c_int), ("device", ctypes.c_int), ("mode", ctypes.c_int),
                ("group", ctypes.c_int), ("n_rows", ctypes.c_longlong),
                ("indptr", ctypes.c_void_p), ("indices", ctypes.c_void_p),
                ("values", ctypes.c_void_p), ("n_chunks", ctypes.c_longlong),
                ("long_row", ctypes.c_longlong), ("long_rows", ctypes.c_void_p), ("long_first", ctypes.c_void_p),
                ("chunk_row", ctypes.c_void_p), ("chunk_start", ctypes.c_void_p),
                ("chunk_order", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("partials", ctypes.c_void_p)]


class _WindowArgs(ctypes.Structure):
    """csrc/gell_window_spmv.cu::GellWindowArgs."""
    _fields_ = [("dtype", ctypes.c_int), ("device", ctypes.c_int), ("mode", ctypes.c_int),
                ("cluster", ctypes.c_int), ("R", ctypes.c_int), ("W", ctypes.c_int),
                ("n_rows", ctypes.c_longlong), ("n_cols", ctypes.c_longlong),
                ("n_ranges", ctypes.c_longlong), ("words", ctypes.c_void_p),
                ("values", ctypes.c_void_p), ("uptr", ctypes.c_void_p),
                ("uwin", ctypes.c_void_p), ("uoff", ctypes.c_void_p)]


@dataclasses.dataclass(frozen=True)
class _Launch:
    """One entry of one pack on the card, resolved once: the route, the C
    function, its argument struct (kept alive here) and what a vector must
    be."""
    route: str
    fn: object
    args: ctypes.Structure
    args_ptr: int
    device: torch.device
    index: int
    dtype: torch.dtype      # of x and y (planes: of each plane)
    split: tuple | None     # (long rows, chunk blocks) a launch splits; None: no split


def _launcher(name: str, pack: GELLPack, planes: bool, route: str | None) -> _Launch:
    """The pack's launch for this entry and route (default ``pick_route``),
    built on the first call after checking the pack, then reused: the pack
    is frozen, so its tensors, layout and route do not change."""
    hit = pack._launchers.get((planes, route))
    if hit is not None:
        return hit
    if pack.values.device.type != "cuda":
        raise ValueError(f"{name}: pack on {pack.values.device}, expected a CUDA device")
    if pack.values.dtype not in _VALUE_CODES:
        raise TypeError(f"{name}: unsupported value dtype {pack.values.dtype}")
    if not (pack.values.is_contiguous() and pack.indices.is_contiguous()
            and pack.indptr.is_contiguous()):
        raise ValueError(f"{name}: pack tensors must be contiguous")
    if pack.is_complex and pack.values.data_ptr() % (2 * pack.values.element_size()):
        raise ValueError(f"{name}: complex value pairs must be aligned to a pair")
    chosen = route or pick_route(pack, planes)
    lib = _build.load()
    dev = pack.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    code = _VALUE_CODES[pack.values.dtype]
    mode = _MODE_PLANES if planes else _MODE_COMPLEX if pack.is_complex else _MODE_REAL
    split = pack.split if chosen == "csr" and mode == _MODE_REAL else None
    if chosen == "windows":
        win = pack.windows
        if win is None:
            raise ValueError(f"{name}: the pack has no windowed layout")
        if win.values.dtype != pack.values.dtype or win.words.device != dev:
            raise ValueError(f"{name}: the windowed layout does not match the pack")
        fn, args = lib.gell_window_spmv, _WindowArgs(
            code, index, mode, win.cluster, win.rows, win.cols, pack.shape[0], pack.shape[1],
            win.n_ranges, win.words.data_ptr(), win.values.data_ptr(), win.uptr.data_ptr(),
            win.uwin.data_ptr(), win.uoff.data_ptr())
    elif chosen == "csr":
        fn, args = lib.gell_csr_spmv, _CSRArgs(
            code, index, mode, pack.group, pack.shape[0], pack.indptr.data_ptr(),
            pack.indices.data_ptr(), pack.values.data_ptr(),
            *((split.n_chunks, split.long_row, split.rows.data_ptr(), split.first.data_ptr(),
               split.chunk_row.data_ptr(), split.chunk_start.data_ptr(),
               split.order.data_ptr(), split.counters.data_ptr(), split.partials.data_ptr())
              if split is not None else (0, 0) + (None,) * 7))
    else:
        raise ValueError(f"{name}: route {chosen!r} is neither 'csr' nor 'windows'")
    dtype = pack.vector_dtype.to_real() if planes else pack.vector_dtype
    hit = _Launch(chosen, fn, args, ctypes.addressof(args), dev, index, dtype,
                  (len(split.rows), split.n_chunks) if split is not None else None)
    pack._launchers[(planes, route)] = hit
    return hit


def _check_vector(name: str, launch: _Launch, pack: GELLPack, vec: torch.Tensor) -> None:
    if vec.device != launch.device:
        if vec.device.type != "cuda":
            raise ValueError(f"{name}: vector on {vec.device}, expected a CUDA device")
        raise ValueError(f"{name}: pack on {launch.device}, vector on {vec.device}")
    if vec.dtype != launch.dtype:
        raise TypeError(f"{name}: vector dtype {vec.dtype} does not match {launch.dtype} for "
                        f"{pack.dtype} values")


ROUTE_LAUNCHES = {"csr": 0, "windows": 0}


def _launch(name: str, launch: _Launch, x: torch.Tensor, x_plane: int, y: torch.Tensor) -> None:
    rc = launch.fn(launch.args_ptr, x.data_ptr(), x_plane, y.data_ptr(),
                   torch._C._cuda_getCurrentRawStream(launch.index))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): "
                           f"{_build.load().dia_cuda_error_string(rc).decode()}")
    ROUTE_LAUNCHES[launch.route] += 1
    if launch.split is not None:
        count("gell_split_rows", launch.split[0])
        count("gell_split_blocks", launch.split[1])


def gell_kernel(pack: GELLPack, x: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """B6 on the card: ``A @ x`` with x an (n_cols,) contiguous vector of
    dtype ``pack.vector_dtype`` (complex64/complex128 for a complex pack),
    by ``route`` (``"csr"`` or ``"windows"``; default ``pick_route``).
    A pack with no rows or no entries launches nothing: y is empty or zero.

    On the CSR route a pack with long rows (``pack.split``) is not
    reentrant: the kernel writes the split's per-row counters and per-chunk
    partials, which packs made from this one by ``with_values_dtype`` or
    ``dataclasses.replace`` share. Calls on such packs must run in stream
    order: two at once, from two streams or from overlapping CUDA graph
    replays, give a wrong y without an error."""
    n_rows, n_cols = pack.shape
    if x.shape != (n_cols,):
        raise ValueError(f"gell_kernel: expected an ({n_cols},) vector, got {tuple(x.shape)}")
    launch = _launcher("gell_kernel", pack, False, route)
    _check_vector("gell_kernel", launch, pack, x)
    if not x.is_contiguous():
        raise ValueError("gell_kernel: vector must be contiguous")
    if x.data_ptr() % x.element_size():
        raise ValueError("gell_kernel: vector must be aligned to its element size")
    if pack.nnz == 0:
        return torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    _launch("gell_kernel", launch, x, 0, y)
    gell_kernel.launches += 1
    return y


gell_kernel.launches = 0


def gell_planes_kernel(pack: GELLPack, x_planes: torch.Tensor,
                       route: str | None = None) -> torch.Tensor:
    """B6 cpx on the card: a complex pack times (2, n_cols) re/im planes of
    dtype ``pack.vector_dtype.to_real()``, unit stride along a plane and any
    stride between the planes -> (2, n_rows) planes, by ``route`` (default
    ``pick_route`` for planes)."""
    if not pack.is_complex:
        raise TypeError("gell_planes_kernel: the pack is not complex")
    n_rows, n_cols = pack.shape
    if x_planes.shape != (2, n_cols):
        raise ValueError(f"gell_planes_kernel: expected (2, {n_cols}) planes, got "
                         f"{tuple(x_planes.shape)}")
    launch = _launcher("gell_planes_kernel", pack, True, route)
    _check_vector("gell_planes_kernel", launch, pack, x_planes)
    if n_cols > 1 and x_planes.stride(1) != 1:
        raise ValueError("gell_planes_kernel: planes must have unit stride along a plane")
    if pack.nnz == 0:
        return torch.zeros((2, n_rows), dtype=x_planes.dtype, device=x_planes.device)
    y = torch.empty((2, n_rows), dtype=x_planes.dtype, device=x_planes.device)
    _launch("gell_planes_kernel", launch, x_planes, x_planes.stride(0), y)
    gell_planes_kernel.launches += 1
    return y


gell_planes_kernel.launches = 0

KERNELS = (gell_kernel, gell_planes_kernel)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0


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
