"""The long rows of a GELL pack (``ops/gell_spmv.py::GELLSplit``), which B6's
CSR route runs one block a chunk, on the CPU.

``split_long_rows`` lists the rows of more than ``LONG_ROW`` entries and
cuts each into chunks of at most ``SPLIT_CHUNK`` entries within one window
of ``SPLIT_WINDOW`` columns, run window by window; these tests hold that the
chunks cover every entry of every long row exactly once and in order, each
in one window and the run order window by window (at the real window and at
windows of a few hundred columns), that no split is made where no row is
long (``chip_smoke.py``'s uniform band of 33 entries a row, a row of exactly
``LONG_ROW``, a complex pack), that the split rides along with the pack's
replacements, and that the kernel's order of sums (each
chunk's partial, then the partials in chunk order) gives the product: a
plain emulation of that order against ``gell_matvec_plain`` in float64, to
1e-5 in float32 and 1e-12 in float64 relative to max|y| (the two sum a long
row in another order).
"""

import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu_torch.matrix.gell import SparseGELL
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as tg

L, C = tg.LONG_ROW, tg.SPLIT_CHUNK

# row lengths around the edges: at and one past the threshold, a chunk and
# one past, many chunks, a hub first and last, hubs side by side
LENGTHS = {
    "one_hub": [3] * 500 + [20 * C + 17] + [5] * 400,
    "edges": [L, L + 1, 0, C, 2 * C, 2 * C + 1, 7, 3 * C - 1],
    "first_and_last": [9 * C + 5] + [1] * 300 + [L + 2],
    "side_by_side": [0] * 10 + [4 * C + 1, 5 * C, 6 * C + 3] + [2] * 50,
}
# columns: one window, and (with the window cut to 700 columns) many
WINDOWS = [(5000, None), (5000, 700), (3 * tg.SPLIT_WINDOW + 5, None)]


def coo_of(lengths, n_cols, seed, dtype=np.float32):
    """Rows of the given lengths, columns drawn uniformly (sorted in the
    pack), standard normal values."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    r = np.repeat(np.arange(len(lengths)), lengths)
    return r, rng.integers(0, n_cols, len(r)), rng.standard_normal(len(r)).astype(dtype)


def chunk_ends(pack):
    """Each chunk's end: the next chunk's start, the row's end for its last."""
    sp = pack.split
    ends = torch.cat([sp.chunk_start[1:], sp.chunk_start.new_zeros(1)])
    last = sp.first[1:].long() - 1
    ends[last] = pack.indptr.long()[sp.rows.long() + 1]
    return ends


def split_matvec_emulated(pack, x):
    """B6's CSR route in the kernel's order: rows that are not long by the
    plain product; each chunk's partial over its entries, then each long
    row's partials in chunk order (``index_add_`` on the CPU adds in index
    order)."""
    y = tg.gell_matvec_plain(pack, x)
    sp = pack.split
    if sp is None:
        return y
    lengths = chunk_ends(pack) - sp.chunk_start
    entry = torch.repeat_interleave(sp.chunk_start - torch.cumsum(lengths, 0) + lengths,
                                    lengths) + torch.arange(int(lengths.sum()))
    chunk = torch.repeat_interleave(torch.arange(sp.n_chunks), lengths)
    products = pack.values[entry].to(x.dtype) * x[pack.indices[entry].long()]
    partials = torch.zeros(sp.n_chunks, dtype=x.dtype).index_add_(0, chunk, products)
    rows = torch.zeros(len(sp.rows), dtype=x.dtype).index_add_(0, sp.chunk_row.long(), partials)
    y[sp.rows.long()] = rows
    return y


@pytest.mark.parametrize("n_cols,window", WINDOWS)
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_chunks_cover_each_long_row_once_in_order(monkeypatch, case, n_cols, window):
    if window:
        monkeypatch.setattr(tg, "SPLIT_WINDOW", window)
    lengths = np.asarray(LENGTHS[case])
    pack = tg.pack_gell(*coo_of(lengths, n_cols, seed=len(case)), (len(lengths), n_cols),
                        device="cpu")
    sp = pack.split
    long_rows = np.nonzero(lengths > L)[0]
    assert sp is not None and sp.rows.tolist() == long_rows.tolist() and sp.long_row == L
    assert (sp.rows.dtype, sp.first.dtype, sp.chunk_row.dtype, sp.chunk_start.dtype,
            sp.order.dtype, sp.counters.dtype, sp.partials.dtype) == (
        torch.int32, torch.int32, torch.int32, torch.int64, torch.int32, torch.int32,
        torch.float64)
    assert not sp.counters.any() and sp.counters.shape == sp.rows.shape
    assert sp.partials.shape == sp.order.shape == (sp.n_chunks,) and sp.first[0] == 0
    assert sp.first[-1] == sp.n_chunks
    ends = chunk_ends(pack)
    indptr = pack.indptr.tolist()
    width = window or tg.SPLIT_WINDOW
    windows = []
    for c, (s, e) in enumerate(zip(sp.chunk_start.tolist(), ends.tolist())):
        win = set((pack.indices[s:e] // width).tolist())
        assert 0 < e - s <= C and len(win) == 1, c  # in one window, at most a chunk
        windows.append(win.pop())
    for i, row in enumerate(long_rows):
        lo, hi = int(sp.first[i]), int(sp.first[i + 1])
        assert (sp.chunk_row[lo:hi] == i).all()
        covered = np.concatenate([np.arange(s, e) for s, e in
                                  zip(sp.chunk_start[lo:hi].tolist(), ends[lo:hi].tolist())])
        np.testing.assert_array_equal(covered, np.arange(indptr[row], indptr[row + 1]))
        assert hi - lo == sum(-(-int(n) // C) for n in np.bincount(
            (pack.indices[indptr[row]:indptr[row + 1]] // width).numpy()))
    # block b runs chunk order[b]: every chunk once, window by window, in
    # chunk order within a window
    order = sp.order.tolist()
    assert sorted(order) == list(range(sp.n_chunks))
    assert [windows[c] for c in order] == sorted(windows)
    assert all(a < b for a, b in zip(order, order[1:]) if windows[a] == windows[b])
    if n_cols > (window or tg.SPLIT_WINDOW):
        assert len(set(windows)) > 1


@pytest.mark.parametrize("lengths", [[33] * 20_000, [L] * 3 + [1] * 100, [0] * 5, []],
                         ids=["uniform_band", "at_the_threshold", "empty_rows", "no_rows"])
def test_no_split_without_a_long_row(lengths):
    r, c, v = coo_of(lengths, 20_000, seed=1)
    assert tg.pack_gell(r, c, v, (len(lengths), 20_000), device="cpu").split is None


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_a_complex_pack_has_no_split(dtype):
    # the complex kernels run one group a row, long or not
    lengths = LENGTHS["one_hub"]
    r, c, v = coo_of(lengths, 900, seed=2)
    pack = tg.pack_gell(r, c, (v + 1j * v[::-1]).astype(dtype), (len(lengths), 900),
                        device="cpu")
    assert pack.is_complex and pack.split is None


def test_the_uniform_band_has_no_split():
    # chip_smoke.py's uniform operator (bench.py's 33 entries a row, duplicates
    # dropped), at 50,000 rows
    rng = np.random.default_rng(0)
    n = 50_000
    key = np.unique(np.repeat(np.arange(n), 33) * n + rng.integers(0, n, 33 * n))
    m = SparseGELL.from_coo(key // n, key % n, np.ones(len(key), np.float32), (n, n),
                            device="cpu")
    assert m.pack.split is None and m.pack.group == 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_the_split_rides_along_with_the_pack(dtype):
    lengths = LENGTHS["one_hub"]
    pack = tg.pack_gell(*coo_of(lengths, 900, seed=3), (len(lengths), 900), device="cpu")
    cast = pack.with_values_dtype(dtype)
    assert cast.values.dtype == dtype and cast.split is pack.split
    assert tg.with_windows(pack, 1).split is pack.split


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_tensor_and_host_input_give_the_same_split(monkeypatch, index_dtype):
    monkeypatch.setattr(tg, "PACK_CHUNK", 5_000)  # pieces cut through the hubs
    monkeypatch.setattr(tg, "SPLIT_WINDOW", 100)
    lengths = LENGTHS["side_by_side"] + LENGTHS["one_hub"]
    r, c, v = coo_of(lengths, 700, seed=4)
    shape = (len(lengths), 700)
    host = tg.pack_gell(r, c, v, shape, device="cpu").split
    dev = tg.pack_gell(torch.from_numpy(r).to(index_dtype), torch.from_numpy(c).to(index_dtype),
                       torch.from_numpy(v), shape, device="cpu").split
    for field in ("rows", "first", "chunk_row", "chunk_start", "order"):
        assert torch.equal(getattr(host, field), getattr(dev, field)), field


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_the_split_order_gives_the_product(monkeypatch, case, dtype, tol):
    monkeypatch.setattr(tg, "SPLIT_WINDOW", 700)
    lengths = LENGTHS[case]
    n_cols = 5000
    pack = tg.pack_gell(*coo_of(lengths, n_cols, seed=7, dtype=dtype), (len(lengths), n_cols),
                        device="cpu")
    assert pack.split.n_chunks > len(pack.split.rows) * 4
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, n_cols).astype(dtype))
    want = tg.gell_matvec_plain(pack, x.double())  # float32 sums of 36,869 terms would not do
    got = split_matvec_emulated(pack, x).double()
    assert float((got - want).abs().max() / want.abs().max()) <= tol
