"""The GELL pack (``ops/gell_spmv.py::build_pack``), from NumPy arrays and
from tensors, against a pack made here by a stable NumPy sort of the same
triplets, on the CPU: ``indptr``, ``indices``, ``values``, ``group``, the
route, the windowed layout where the rule keeps it and ``SparseGELL``'s
``diag``, field for field and bit for bit. ``PACK_CHUNK`` is cut to a few
entries, so that the pieces of rows (and of clusters, in the window rule)
break everywhere. Also: where a pack is built (``pack_device``), the
errors, ``from_coo(layout="gell")`` on tensors, the spans and counter under
a profile, and, on the card (marked ``cuda``), the pack on the card, one
kernel a B6 call and B6 at entry offsets next to 2^31.
"""

import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu_torch import from_coo
from pcsc_eigenvalue_solver_project_tpu_torch.matrix.gell import SparseGELL
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as tg
from pcsc_eigenvalue_solver_project_tpu_torch.utils import timing

PACK_FIELDS = ("indptr", "indices", "values")
WINDOW_FIELDS = ("words", "values", "uptr", "uwin", "uoff")
CHUNKS = [1 << 27, 500, 61]


def unsorted_coo(rng, n_rows, n_cols, nnz, empty_rows=()):
    """Random triplets in no order, a run of repeated (row, col) pairs, and
    no entry in ``empty_rows``."""
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    if nnz >= 40:
        r[20:40], c[20:40] = r[0], c[0]
    for e in empty_rows:
        r[r == e] = (e + 1) % n_rows
    return r, c, rng.standard_normal(nnz)


def banded_coo(rng, n, per_row):
    """``per_row`` entries a row within one 16384-column window: the rule
    keeps the windowed layout."""
    r = np.repeat(np.arange(n), per_row)
    return r, rng.integers(0, n, n * per_row), rng.standard_normal(n * per_row)


def as_tensors(r, c, v, index_dtype=torch.int64):
    return (torch.from_numpy(r).to(index_dtype), torch.from_numpy(c).to(index_dtype),
            torch.from_numpy(v))


def reference_pack(r, c, v, shape):
    """The CSR of the triplets by a stable NumPy sort on (row, column), with
    the windowed layout where the rule keeps it; complex values as (re, im)
    pairs."""
    order = np.argsort(r * shape[1] + c, kind="stable")
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=shape[0]), out=indptr[1:])
    vals = v[order]
    if v.dtype.kind == "c":
        vals = np.stack([vals.real, vals.imag], -1)
    return tg.attach_windows(tg.GELLPack(
        indptr=torch.from_numpy(indptr.astype(np.int32)),
        indices=torch.from_numpy(c[order].astype(np.int32)), values=torch.from_numpy(vals),
        shape=shape, group=tg.group_width(len(r), shape[0]), is_complex=v.dtype.kind == "c"))


def reference_diag(r, c, v, shape):
    k = min(shape)
    d = np.zeros(k, v.dtype)
    on = (r == c) & (r < k)
    np.add.at(d, r[on], v[on])
    return torch.from_numpy(d)


def assert_same_pack(host, dev):
    for f in PACK_FIELDS:
        a, b = getattr(host, f), getattr(dev, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (host.shape, host.group, host.is_complex) == (dev.shape, dev.group, dev.is_complex)
    assert tg.pick_route(host) == tg.pick_route(dev)
    assert (host.windows is None) == (dev.windows is None)
    if host.windows is not None:
        for f in WINDOW_FIELDS:
            assert torch.equal(getattr(host.windows, f), getattr(dev.windows, f)), f
        assert host.windows.staged_bytes == dev.windows.staged_bytes


CASES = {
    "unsorted_duplicates": lambda rng: (unsorted_coo(rng, 300, 300, 4000), (300, 300)),
    "empty_rows": lambda rng: (unsorted_coo(rng, 200, 200, 900, empty_rows=(0, 5, 6, 7, 199)),
                               (200, 200)),
    "wide": lambda rng: (unsorted_coo(rng, 60, 5000, 2000), (60, 5000)),
    "tall": lambda rng: (unsorted_coo(rng, 3000, 40, 2500), (3000, 40)),
    "one_entry": lambda rng: (unsorted_coo(rng, 9, 9, 1), (9, 9)),
    "no_entries": lambda rng: (unsorted_coo(rng, 12, 7, 0), (12, 7)),
    "windows_kept": lambda rng: (banded_coo(rng, 4224, 100), (4224, 4224)),
}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tensor_pack_equals_numpy_pack(monkeypatch, case, dtype, chunk):
    if case == "windows_kept":  # each piece scans all entries: a few pieces at 422,400
        chunk = max(chunk, 50_000)
    (r, c, v), shape = CASES[case](np.random.default_rng(len(case)))
    v = v.astype(dtype)
    want = reference_pack(r, c, v, shape)
    monkeypatch.setattr(tg, "PACK_CHUNK", chunk)
    host = tg.pack_gell(r, c, v, shape, device="cpu")
    index = torch.int32 if chunk == 61 else torch.int64
    dev = tg.pack_gell(*as_tensors(r, c, v, index), shape, device="cpu")
    assert_same_pack(want, host)
    assert_same_pack(want, dev)
    if case == "windows_kept":
        assert dev.windows is not None and tg.pick_route(dev) == "windows"
    g_host = SparseGELL.from_coo(r, c, v, shape, device="cpu")
    g_dev = SparseGELL.from_coo(*as_tensors(r, c, v, index), shape, device="cpu")
    assert_same_pack(want, g_host.pack)
    assert_same_pack(want, g_dev.pack)
    diag = reference_diag(r, c, v, shape)
    for g in (g_host, g_dev):
        assert g.diag.dtype == diag.dtype and torch.equal(g.diag, diag)
    assert g_host.nnz == g_dev.nnz == len(r)


@pytest.mark.parametrize("chunk", [1 << 27, 13])
def test_bf16_tensor_pack_equals_the_cast_numpy_pack(monkeypatch, chunk):
    # NumPy has no bfloat16: the reference's values are cast after the sort,
    # which commutes with the gather of the values
    (r, c, v), shape = CASES["unsorted_duplicates"](np.random.default_rng(3))
    host = reference_pack(r, c, v.astype(np.float32), shape)
    host = tg.attach_windows(tg.GELLPack(indptr=host.indptr, indices=host.indices,
                                         values=host.values.to(torch.bfloat16), shape=shape,
                                         group=host.group))
    monkeypatch.setattr(tg, "PACK_CHUNK", chunk)
    r_t, c_t, v_t = as_tensors(r, c, v.astype(np.float32))
    dev = tg.pack_gell(r_t, c_t, v_t.to(torch.bfloat16), shape, device="cpu")
    assert dev.values.dtype == torch.bfloat16
    assert_same_pack(host, dev)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_pack_equals_the_reference(monkeypatch, dtype):
    rng = np.random.default_rng(4)
    (r, c, v), shape = CASES["unsorted_duplicates"](rng)
    v = (v + 1j * rng.standard_normal(len(v))).astype(dtype)
    want = reference_pack(r, c, v, shape)
    monkeypatch.setattr(tg, "PACK_CHUNK", 97)
    for coo in ((r, c, v), as_tensors(r, c, v)):
        assert_same_pack(want, tg.pack_gell(*coo, shape, device="cpu"))
        g = SparseGELL.from_coo(*coo, shape, device="cpu")
        assert g.device.type == "cpu" and g.dtype == torch.from_numpy(v).dtype
        assert torch.equal(g.diag, reference_diag(r, c, v, shape))


def layout_in_pieces(monkeypatch, chunk, pack, *args):
    monkeypatch.setattr(tg, "PACK_CHUNK", chunk)
    return tg._window_layout(pack, *args)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("chunk", [1, 50, 400])
@pytest.mark.parametrize("rows,cols", [(16, 32), (64, 128)])
def test_chunked_window_layout_equals_the_unchunked(monkeypatch, cluster, chunk, rows, cols):
    rng = np.random.default_rng(cluster * 7 + rows)
    r, c, v = unsorted_coo(rng, 500, 700, 6000, empty_rows=range(100, 180))
    pack = tg.pack_gell(r, c, v.astype(np.float32), (500, 700), device="cpu")
    whole = layout_in_pieces(monkeypatch, 1 << 40, pack, cluster, rows, cols, None)
    cut = layout_in_pieces(monkeypatch, chunk, pack, cluster, rows, cols, None)
    for f in WINDOW_FIELDS:
        assert torch.equal(getattr(whole, f), getattr(cut, f)), f
    assert (whole.staged_windows, whole.n_ranges) == (cut.staged_windows, cut.n_ranges)
    x = torch.from_numpy(rng.standard_normal(700).astype(np.float32))
    assert torch.equal(tg.gell_window_matvec_plain(pack, x, cut), tg.gell_matvec_plain(pack, x))


@pytest.mark.parametrize("chunk", [1, 300, 1 << 40])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("case", ["windows_kept", "wide"])
def test_chunked_window_rule_gives_the_same_decision(monkeypatch, case, planes, chunk):
    (r, c, v), shape = CASES[case](np.random.default_rng(5))
    pack = tg.pack_gell(r, c, v.astype(np.float32), shape, device="cpu")
    whole = tg.window_layout(pack)
    kept = layout_in_pieces(monkeypatch, chunk, pack, tg.WINDOW_CLUSTER, None, None, planes)
    assert (kept is not None) == tg.window_rule(pack, whole, planes)
    assert (kept is not None) == (case == "windows_kept")
    if kept is not None:
        for f in WINDOW_FIELDS:
            assert torch.equal(getattr(whole, f), getattr(kept, f)), f


def test_a_refused_rule_stops_at_the_first_piece_past_csr(monkeypatch):
    # a wide, sparse pack: the first piece's union windows already stage more
    # than CSR gathers, and the rule reads no later piece
    n = 4000
    rng = np.random.default_rng(6)
    pack = tg.pack_gell(np.arange(n), rng.integers(0, 50_000_000, n), np.ones(n, np.float32),
                        (n, 50_000_000), device="cpu")
    seen = []
    real = torch.unique
    monkeypatch.setattr(torch, "unique", lambda *a, **k: seen.append(1) or real(*a, **k))
    assert layout_in_pieces(monkeypatch, 100, pack, 1, None, None, False) is None
    assert len(seen) == 1


@pytest.mark.parametrize("host", [False, True], ids=["tensors", "numpy"])
def test_errors(monkeypatch, host):
    r, c, v = np.array([0, 1]), np.array([1, 2]), np.array([1.0, 2.0], np.float32)
    if not host:
        r, c, v = as_tensors(r, c, v)
    cpu = {"device": "cpu"}
    for bad in ((r, c, v, (1, 3)), (r, c, v, (3, 2)), (r - 1, c, v, (3, 3)), (r, c - 2, v, (3, 3))):
        with pytest.raises(ValueError, match="Sparse indices out of range"):
            tg.pack_gell(*bad, **cpu)
        with pytest.raises(ValueError, match="Sparse indices out of range"):
            SparseGELL.from_coo(*bad, **cpu)
    with pytest.raises(ValueError, match="must fit int32"):
        tg.pack_gell(r, c, v, (2 ** 31, 3), **cpu)
    monkeypatch.setattr(tg, "_INT32_MAX", 1)
    with pytest.raises(ValueError, match="must fit int32"):
        tg.pack_gell(r, c, v, (3, 3), **cpu)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="1-D of equal length"):
        tg.pack_gell(r, c[:1], v, (3, 3), **cpu)
    with pytest.raises(ValueError, match="1-D of equal length"):
        SparseGELL.from_coo(r, c, v[:1], (3, 3), **cpu)
    if not host:  # NumPy indices are taken as int64, as np.asarray casts them
        with pytest.raises(TypeError, match="integer tensors"):
            tg.pack_gell(r.float(), c, v, (3, 3), **cpu)
    ints = v.astype(np.int32) if host else v.int()
    with pytest.raises(TypeError, match="unsupported value dtype"):
        tg.pack_gell(r, c, ints, (3, 3), **cpu)
    with pytest.raises(TypeError, match="scalar concept"):
        SparseGELL.from_coo(r, c, ints, (3, 3), **cpu)
    with pytest.raises(ValueError, match="tile_rows must be a multiple of 128"):
        tg.pack_gell(r, c, v, (3, 3), tile_rows=100, **cpu)


def test_pack_device_rule():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert tg.pack_device("cpu", meta, meta) == torch.device("cpu")  # given: it holds
    assert tg.pack_device(None, cpu, meta) == meta.device  # tensors off the CPU stay there
    for host in ((cpu, cpu), (np.zeros(2), [0.0])):  # else the card, as for host data
        assert tg.pack_device(None, *host) == torch.device("cuda")


def test_cpu_tensors_with_no_device_go_to_the_card():
    (r, c, v), shape = CASES["one_entry"](np.random.default_rng(1))
    tensors = as_tensors(r, c, v.astype(np.float32))
    for build in (tg.pack_gell, SparseGELL.from_coo,
                  lambda *a: from_coo(*a, layout="gell")):
        if torch.cuda.is_available():
            assert build(*tensors, shape).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build(*tensors, shape)


def test_from_coo_gell_keeps_tensors_on_their_device(monkeypatch):
    (r, c, v), shape = CASES["unsorted_duplicates"](np.random.default_rng(8))
    want = SparseGELL.from_coo(r, c, v.astype(np.float32), shape, device="cpu")

    def no_host(*args, **kwargs):
        raise AssertionError("a tensor was copied to NumPy")
    tensors = as_tensors(r, c, v.astype(np.float32))
    monkeypatch.setattr(torch.Tensor, "numpy", no_host)
    got = from_coo(*tensors, shape, layout="gell", device="cpu")
    assert isinstance(got, SparseGELL)
    assert {t.device.type for t in (got.pack.indptr, got.pack.indices, got.pack.values,
                                    got.diag)} == {"cpu"}
    assert_same_pack(want.pack, got.pack)
    assert torch.equal(want.diag, got.diag)


def test_pack_spans_and_counter_under_a_profile(tmp_path):
    (r, c, v), shape = CASES["windows_kept"](np.random.default_rng(9))
    tensors = as_tensors(r, c, v.astype(np.float32))
    timing.reset()
    tg.pack_gell(*tensors, shape, device="cpu")
    assert timing.spans() == [] and timing.counters() == {}
    with timing.trace(str(tmp_path)):
        tg.pack_gell(*tensors, shape, device="cpu")
    spans = timing.spans()
    names = [s.name for s in spans]
    assert names == ["eigsol.gell.pack", "eigsol.gell.sort", "eigsol.gell.windows"]
    assert spans[1].parent == spans[2].parent == 0 and all(s.end_ns for s in spans)
    assert timing.counters() == {"gell_pack_entries": len(r)}
    timing.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1 << 27, 100_003])
def test_card_pack_equals_the_cpu_pack(card, monkeypatch, chunk):
    monkeypatch.setattr(tg, "PACK_CHUNK", chunk)
    rng = np.random.default_rng(11)
    r, c, v = unsorted_coo(rng, 100_000, 120_000, 2_000_000)
    tensors = as_tensors(r, c, v.astype(np.float32), torch.int32)
    cpu = SparseGELL.from_coo(*tensors, (100_000, 120_000), device="cpu")
    gpu = SparseGELL.from_coo(*(t.cuda() for t in tensors), (100_000, 120_000))
    assert gpu.device.type == "cuda"
    for f in PACK_FIELDS:  # NumPy input and CPU tensors pack on the card by default
        for coo in ((r, c, v.astype(np.float32)), tensors):
            assert torch.equal(getattr(cpu.pack, f),
                               getattr(tg.pack_gell(*coo, (100_000, 120_000)), f).cpu()), f
    for f in PACK_FIELDS:
        assert torch.equal(getattr(cpu.pack, f), getattr(gpu.pack, f).cpu()), f
    assert torch.equal(cpu.diag, gpu.diag.cpu()) and cpu.pack.group == gpu.pack.group
    x = torch.from_numpy(rng.standard_normal(120_000).astype(np.float32))
    y = gpu.matvec(x.cuda()).cpu().double()
    want = tg.gell_matvec_plain(cpu.pack, x.double())
    assert float((y - want).abs().max() / want.abs().max()) < 1e-5


B6_KERNELS = ("gell_real_kernel", "gell_complex_kernel", "gell_window_kernel")


@pytest.mark.cuda
def test_card_each_b6_call_is_one_kernel(card):
    # the benchmark's b6_roofline counts B6's calls in the trace: one kernel a
    # call (counted in the CUDA graph the calls are captured into)
    from test_torch_cuda_kernels import graph_kernels
    rng = np.random.default_rng(13)
    (r, c, v), shape = CASES["unsorted_duplicates"](rng)
    csr = tg.pack_gell(r, c, v.astype(np.float32), shape)
    cpx = tg.pack_gell(r, c, (v + 1j * v[::-1]).astype(np.complex64), shape)
    (rw, cw, vw), wshape = CASES["windows_kept"](rng)
    win = tg.pack_gell(rw, cw, vw.astype(np.float32), wshape)
    assert (tg.pick_route(csr), tg.pick_route(win)) == ("csr", "windows")
    x, xw = torch.rand(shape[1], device="cuda"), torch.rand(wshape[1], device="cuda")
    planes = torch.rand(2, shape[1], device="cuda")

    def calls():
        for _ in range(3):
            tg.gell_kernel(csr, x)
        for _ in range(2):
            tg.gell_kernel(win, xw)
        tg.gell_planes_kernel(cpx, planes)

    names = graph_kernels(calls)
    assert len(names) == 6 and all(any(k in n for k in B6_KERNELS) for n in names), names


@pytest.mark.cuda
def test_card_b6_at_entry_offsets_next_to_int32_max(card):
    # 2^31 - 1 entries; the last row's 20 start 21 below 2^31, so a lane's
    # start + lane would pass 2^31 in int32
    nnz, rows, tail = 2 ** 31 - 1, 2 ** 20, 20
    dev = torch.device("cuda")
    indptr = torch.empty(rows + 1, dtype=torch.int64, device=dev)
    indptr[:rows] = torch.arange(rows, device=dev) * (nnz - tail) // (rows - 1)
    indptr[rows] = nnz
    assert int(indptr[rows - 1]) == nnz - tail
    indices = torch.zeros(nnz, dtype=torch.int32, device=dev)
    values = torch.zeros(nnz, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    live = 5000  # the last rows' entries carry values
    indices[-live:] = torch.randint(0, 1000, (live,), generator=gen, device=dev,
                                    dtype=torch.int32)
    values[-live:] = torch.rand(live, generator=gen, device=dev)
    pack = tg.GELLPack(indptr=indptr.to(torch.int32), indices=indices, values=values,
                       shape=(rows, 1000), group=32)
    x = torch.rand(1000, generator=gen, device=dev)
    y = tg.gell_kernel(pack, x, route="csr")
    first = int(torch.searchsorted(indptr, torch.tensor(nnz - live, device=dev), right=True)) - 1
    want = torch.zeros(rows - first, dtype=torch.float64, device=dev)
    lo = int(indptr[first])
    row_of = torch.repeat_interleave(torch.arange(rows - first, device=dev),
                                     (indptr[first + 1:] - indptr[first:-1]))
    want.index_add_(0, row_of, values[lo:].double() * x.double()[indices[lo:].long()])
    torch.testing.assert_close(y[first:].double(), want, rtol=1e-5, atol=1e-6)
    assert not y[:first].any()
