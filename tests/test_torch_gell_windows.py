"""The windowed layout of the general sparse SpMV (B6's staged-x route) in
its plain version, against the JAX package's GELL product and the port's
CSR plain version, on the CPU.

``window_layout`` cuts rows into ranges of R rows and columns into windows
of W columns and orders the entries by (range, window, row, column), with a
16-bit local row and column in one word; ranges are grouped in clusters of
1, 2 or 4 with the union of their windows. ``gell_window_matvec_plain``
(and its planes form) computes y from those arrays alone, so these tests
hold the layout the card kernel reads. Small ranges and windows (R = 64,
W = 128) make many of both.

Tolerances, relative to max|y|: 1e-5 in float32 and complex64, 1e-12 in
float64 and complex128, as ``tests/test_torch_gell.py`` holds the CSR plain
version to JAX (the sides sum a row in another order); the windowed and the
CSR plain versions sum each row in the same column order and agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu.ops.pallas import gell_spmv as jg
from pcsc_eigenvalue_solver_project_tpu_torch.ops import gell_spmv as tg

F32_TOL, F64_TOL = 1e-5, 1e-12
SMALL = {"rows": 64, "cols": 128}


def tol(dtype):
    return F64_TOL if np.dtype(dtype) in (np.float64, np.complex128) else F32_TOL


def random_coo(rng, n_rows, n_cols, nnz, dtype):
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    v = rng.standard_normal(nnz)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(nnz)
    return r, c, v.astype(dtype)


def random_vec(rng, n, dtype):
    x = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def rel(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    return np.abs(y - y_ref).max() / np.abs(y_ref).max()


def windowed(r, c, v, shape, cluster=1, **kw):
    pack = tg.pack_gell(r, c, v, shape, device="cpu")
    return pack, tg.window_layout(pack, cluster, **(kw or SMALL))


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("force,dtype", [
    ("interpret", np.float32), ("interpret", np.complex64), ("xla", np.float32),
    ("xla", np.float64), ("xla", np.complex64), ("xla", np.complex128)])
def test_window_plain_matches_jax(force, dtype, cluster):
    rng = np.random.default_rng(0)
    r, c, v = random_coo(rng, 500, 700, 9000, dtype)
    x = random_vec(rng, 700, dtype)
    yj = np.asarray(jg.gell_matvec(jg.pack_gell(r, c, v, (500, 700), tile_rows=128),
                                   jnp.asarray(x), force=force))
    pack, win = windowed(r, c, v, (500, 700), cluster)
    assert win.n_ranges == 8 and win.uwin.numel() > 6 * win.n_ranges // cluster
    yw = tg.gell_window_matvec_plain(pack, torch.from_numpy(x), win)
    assert yw.dtype == torch.from_numpy(x).dtype
    assert rel(yw.numpy(), yj) < tol(dtype)
    np.testing.assert_array_equal(yw.numpy(), tg.gell_matvec_plain(pack, torch.from_numpy(x)))


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("force,dtype", [("interpret", np.complex64), ("xla", np.complex64),
                                         ("xla", np.complex128)])
def test_window_planes_plain_matches_jax(force, dtype, cluster):
    rng = np.random.default_rng(5)
    r, c, v = random_coo(rng, 300, 1000, 6000, dtype)
    x = random_vec(rng, 1000, dtype)
    planes = np.stack([x.real, x.imag])
    yj = np.asarray(jg.gell_matvec_planes(jg.pack_gell(r, c, v, (300, 1000), tile_rows=128),
                                          jnp.asarray(planes), force=force))
    pack, win = windowed(r, c, v, (300, 1000), cluster)
    yw = tg.gell_window_matvec_planes_plain(pack, torch.from_numpy(planes), win)
    assert yw.shape == (2, 300) and rel(yw.numpy(), yj) < tol(dtype)
    yc = tg.gell_window_matvec_plain(pack, torch.from_numpy(x), win).numpy()
    assert rel(yw[0].numpy() + 1j * yw[1].numpy(), yc) < tol(dtype)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", ["row lengths 0-5000", "duplicates", "700x40000",
                                  "columns past the last full window", "one and all windows"])
def test_window_plain_matches_csr_plain(case, cluster):
    rng = np.random.default_rng(9)
    if case == "row lengths 0-5000":
        lengths = np.array([0, 1, 31, 32, 33, 5000] * 3 + [6] * 400 + [0, 33, 5000])
        r = np.repeat(np.arange(len(lengths)), lengths)
        c = rng.integers(0, 3001, len(r))
        shape = (len(lengths), 3001)
    elif case == "duplicates":
        r = np.array([3, 3, 3, 3, 7, 7, 70, 70])
        c = np.array([5, 5, 5, 5, 5, 5, 300, 300])
        shape = (80, 400)
    elif case == "700x40000":
        r, c = rng.integers(0, 700, 15_000), rng.integers(0, 40_000, 15_000)
        shape = (700, 40_000)
    elif case == "columns past the last full window":
        r, c = rng.integers(0, 200, 3000), rng.integers(1000, 1061, 3000)
        shape = (200, 1061)  # 1061 = 8 windows of 128 and 37 columns
    else:  # range 0 touches one window, range 1 every window
        r = np.concatenate([rng.integers(0, 64, 500), rng.integers(64, 128, 3000)])
        c = np.concatenate([rng.integers(256, 384, 500), np.arange(3000) % 1280])
        shape = (128, 1280)
    v = rng.standard_normal(len(r)).astype(np.float64)
    pack, win = windowed(r, c, v, shape, cluster)
    x = torch.from_numpy(rng.standard_normal(shape[1]))
    np.testing.assert_array_equal(tg.gell_window_matvec_plain(pack, x, win),
                                  tg.gell_matvec_plain(pack, x))
    if case == "duplicates":
        x = torch.zeros(400, dtype=torch.float64)
        x[5], x[300] = 2.0, 1.0
        y = tg.gell_window_matvec_plain(pack, x, win)
        assert y[3].item() == pytest.approx(2 * v[:4].sum(), rel=1e-15)
        assert y[7].item() == pytest.approx(2 * (v[4] + v[5]), rel=1e-15)
        assert y[70].item() == pytest.approx(v[6] + v[7], rel=1e-15)
    if case == "one and all windows":
        counts = (win.uptr[1:] - win.uptr[:-1]).tolist()
        if cluster == 1:
            assert counts == [2, 11]  # one window and its sentinel; ten and the sentinel
        else:
            assert counts[0] == 11  # the cluster's union
    if case == "columns past the last full window":
        live = win.uwin[win.uwin < 9]  # 9 windows; the sentinels are window 9
        assert int(live.max()) == 8  # the ragged ninth window is staged


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_pack_invariants(dtype, cluster):
    rng = np.random.default_rng(3)
    r, c, v = random_coo(rng, 1000, 5000, 20_000, dtype)
    pack, win = windowed(r, c, v, (1000, 5000), cluster, rows=96, cols=640)
    word = win.words.long() & 0xFFFFFFFF
    assert int((word >> 16).max()) < win.rows <= 65536
    assert int((word & 0xFFFF).max()) < win.cols <= 65536
    assert win.n_ranges % cluster == 0 and win.n_ranges * win.rows >= 1000
    assert win.uptr.dtype == win.uwin.dtype == win.uoff.dtype == win.words.dtype == torch.int32
    uptr = win.uptr.long()
    assert int(uptr[0]) == 0 and int(uptr[-1]) == win.uwin.numel()
    assert bool((uptr[1:] > uptr[:-1]).all())  # each cluster has at least its sentinel
    off = win.uoff.long().view(-1, cluster)
    n_windows = -(-5000 // 640)
    for k in range(win.n_ranges // cluster):
        g0, g1 = int(uptr[k]), int(uptr[k + 1])
        w = win.uwin[g0:g1].long()
        assert int(w[-1]) == n_windows and bool((w[1:] > w[:-1]).all())  # sorted, sentinel last
        assert bool((off[g0 + 1:g1] >= off[g0:g1 - 1]).all())  # offsets monotone per range
    assert int(off[0, 0]) == 0 and int(off[-1, -1]) == pack.nnz
    assert win.staged_windows == win.uwin.numel() - win.n_ranges // cluster
    assert win.staged_bytes == win.staged_windows * win.cols * (8 if pack.is_complex else 4)
    # the entries, as (row, column, value), are the COO as a multiset
    rows, cols, vals = tg.window_coo(pack, win)
    got = sorted(zip(rows.tolist(), cols.tolist(),
                     map(tuple, vals.reshape(len(rows), -1).tolist())))
    vv = np.stack([v.real, v.imag], -1) if np.iscomplexobj(v) else v[:, None]
    want = sorted(zip(r.tolist(), c.tolist(), map(tuple, vv.astype(np.float32).tolist())))
    assert got == want


def test_inf_in_x_reaches_only_the_rows_that_hold_its_column():
    rng = np.random.default_rng(4)
    r, c, v = random_coo(rng, 200, 150, 600, np.float32)
    x = rng.standard_normal(150).astype(np.float32)
    x[c[0]] = np.inf
    pack, win = windowed(r, c, v, (200, 150), 2, rows=32, cols=16)
    y = tg.gell_window_matvec_plain(pack, torch.from_numpy(x), win).numpy()
    hit = np.zeros(200, bool)
    hit[r[c == c[0]]] = True
    assert not np.isfinite(y[hit]).any()
    assert np.isfinite(y[~hit]).all()
    yj = np.asarray(jg.gell_matvec(jg.pack_gell(r, c, v, (200, 150)), jnp.asarray(x),
                                   force="xla"))
    assert rel(y[~hit], yj[~hit]) < F32_TOL


def test_the_rule_picks_windows_for_a_dense_band_of_columns_and_csr_when_wide():
    rng = np.random.default_rng(6)
    n = 100_000  # 33 uniform entries a row over 7 windows of 16384 columns
    r = np.repeat(np.arange(n), 33)
    pack = tg.pack_gell(r, rng.integers(0, n, 33 * n), np.ones(33 * n, np.float32), (n, n),
                        device="cpu")
    assert pack.windows is not None and tg.pick_route(pack) == "windows"
    assert pack.windows.cols == 16384 and tg.window_rule(pack, pack.windows)
    # one entry a row over 50M columns: the windows would stage ~1 MB per entry
    wide = tg.pack_gell(np.arange(n), rng.integers(0, 50_000_000, n), np.ones(n, np.float32),
                        (n, 50_000_000), device="cpu")
    assert wide.windows is None and tg.pick_route(wide) == "csr"
    assert not tg.window_rule(wide, tg.window_layout(wide))
    # planes gather two sectors an entry, so the rule leans to the windows there
    assert tg.window_rule(pack, pack.windows, planes=True)


def test_values_dtype_change_rebuilds_the_windows():
    rng = np.random.default_rng(8)
    n = 40_000  # 40 uniform entries a row: windowed in f32 (3 windows) and f64 (5)
    r = np.repeat(np.arange(n), 40)
    pack = tg.pack_gell(r, rng.integers(0, n, 40 * n), rng.standard_normal(40 * n)
                        .astype(np.float32), (n, n), device="cpu")
    assert pack.windows is not None and pack.windows.cols == 16384
    p64 = pack.with_values_dtype(torch.float64)
    assert p64.windows is not None and p64.windows.cols == 8192  # 64 KB of f64
    assert p64.windows.values.dtype == torch.float64
    pbf = pack.with_values_dtype(torch.bfloat16)
    assert pbf.windows.values.dtype == torch.bfloat16 and pbf.windows.cols == 16384
    x = torch.from_numpy(rng.standard_normal(n))
    np.testing.assert_array_equal(tg.gell_window_matvec_plain(p64, x), tg.gell_matvec_plain(p64, x))


def test_window_shape_and_errors():
    pack = tg.pack_gell([0, 5], [1, 3], np.float32([1, 2]), (10, 10), device="cpu")
    assert tg.window_shape(pack, 1) == (32, 16384, 1)
    assert tg.window_shape(pack, 4) == (32, 16384, 4)  # ranges past the rows are empty
    assert tg.window_shape(pack, 2, rows=3, cols=4) == (3, 4, 4)
    with pytest.raises(ValueError, match="cluster 3 not in"):
        tg.window_layout(pack, 3)
    with pytest.raises(ValueError, match="do not fit"):
        tg.window_layout(pack, 1, rows=70_000)
    with pytest.raises(ValueError, match="no windowed layout"):
        tg.window_coo(pack)


def test_a_refused_layout_is_never_sorted(monkeypatch):
    # the rule is read off the union windows: a wide, sparse pack sorts no
    # entries and searches no offsets before it is refused
    rng = np.random.default_rng(9)
    n = 20_000
    wide = tg.pack_gell(np.arange(n), rng.integers(0, 50_000_000, n), np.ones(n, np.float32),
                        (n, 50_000_000), device="cpu")
    calls = []
    for name in ("sort", "searchsorted"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _real=real, _name=name, **k:
                            calls.append(_name) or _real(*a, **k))
    assert tg.attach_windows(wide).windows is None and calls == []
    # a kept layout is the one window_layout builds
    n = 40_000  # 40 uniform entries a row over 3 windows: kept
    r = np.repeat(np.arange(n), 40)
    dense = tg.pack_gell(r, rng.integers(0, n, 40 * n), rng.standard_normal(40 * n)
                         .astype(np.float32), (n, n), device="cpu")
    kept, built = dense.windows, tg.window_layout(dense)
    assert kept is not None and calls
    for field in ("words", "values", "uptr", "uwin", "uoff"):
        assert torch.equal(getattr(kept, field), getattr(built, field)), field
    assert (kept.rows, kept.cols, kept.n_ranges, kept.staged_windows, kept.staged_bytes) == \
        (built.rows, built.cols, built.n_ranges, built.staged_windows, built.staged_bytes)


def _c_struct_fields(source, struct):
    """(name, C type) of each field of `struct` in csrc/`source`, in order."""
    import pathlib
    import re
    text = (pathlib.Path(tg.__file__).parents[1] / "csrc" / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?(?:int|long long|void\*))\s+(.*)", decl).groups()
        fields += [(name.strip(), ctype) for name in names.split(",")]
    return fields


@pytest.mark.parametrize("source,struct,args", [
    ("gell_spmv.cu", "GellCSRArgs", tg._CSRArgs),
    ("gell_window_spmv.cu", "GellWindowArgs", tg._WindowArgs)])
def test_launch_arguments_match_the_c_structs(source, struct, args):
    # a call passes the pack's fixed arguments as one struct: its ctypes
    # mirror must name the same fields, of the same types, in the same order
    import ctypes
    ctypes_of = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                 "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p}
    want = [(name, ctypes_of[ctype]) for name, ctype in _c_struct_fields(source, struct)]
    assert args._fields_ == want


def test_a_cpu_pack_resolves_no_launch():
    pack = tg.pack_gell([0, 1, 1], [1, 0, 1], np.float32([1, 2, 3]), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="expected a CUDA device"):
        tg.gell_kernel(pack, torch.ones(2))
    assert pack._launchers == {}
    # a replaced pack starts with no resolved launch of its own
    pack._launchers[(False, None)] = "resolved"
    assert pack.with_values_dtype(torch.float64)._launchers == {}
    assert tg.with_windows(pack, 1)._launchers == {}
    np.testing.assert_array_equal(tg.gell_matvec(pack, torch.ones(2)), [1.0, 5.0])
