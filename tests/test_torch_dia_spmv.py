"""Banded SpMV of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as tests/test_dia.py runs them) and through the port's
dispatchers, which on CPU tensors run the kernels' plain versions. Tolerance
rtol = atol = 1e-5 in float32 and bfloat16 storage (both sides read the same
bf16 values and accumulate in float32; only the summation order differs),
1e-12 in float64.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcsc_eigenvalue_solver_project_tpu.ops.pallas import dia_spmv as jds
from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build
from pcsc_eigenvalue_solver_project_tpu_torch.ops import dia_spmv as tds
from pcsc_eigenvalue_solver_project_tpu_torch.utils.interop import to_tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def band(n, offsets, seed, complex_values=False):
    """(k, n) float64/complex128 diagonals (zero outside the matrix) and an
    (n,) vector, from numpy."""
    rng = np.random.default_rng(seed)
    k = len(offsets)
    vals = rng.random((k, n))
    x = rng.random(n)
    if complex_values:
        vals = vals + 1j * rng.random((k, n))
        x = x + 1j * rng.random(n)
    for d, off in enumerate(offsets):
        if off > 0:
            vals[d, n - off:] = 0
        elif off < 0:
            vals[d, :-off] = 0
    return vals, x


def assert_close(y_torch, y_jax, tol):
    np.testing.assert_allclose(y_torch.numpy(), np.asarray(y_jax), rtol=tol, atol=tol)


# tests/test_dia.py:75-80
ROWMAJOR_CASES = [
    (16384, (-1, 0, 1)),
    (16500, (-16, -3, 0, 7, 16)),
    (20000, tuple(range(-16, 17))),
    (16384, (-130, 0, 129)),
]


class TestRowMajor:
    """B2 and B3: ``dia_matvec``."""

    @pytest.mark.parametrize("n,offsets", ROWMAJOR_CASES)
    def test_f32_matches_jax_kernel(self, n, offsets):
        vals, x = band(n, offsets, seed=42)
        vals, x = vals.astype(np.float32), x.astype(np.float32)
        y_jax = jds.dia_matvec(jnp.asarray(vals), offsets, jnp.asarray(x),
                               force="interpret")
        y = tds.dia_matvec(torch.from_numpy(vals), offsets, torch.from_numpy(x))
        assert y.dtype == torch.float32
        assert_close(y, y_jax, 1e-5)

    def test_bf16_storage_matches_jax_kernel(self):
        n, offsets = 20000, tuple(range(-16, 17))
        vals, x = band(n, offsets, seed=1)
        vals_j = jnp.asarray(vals, jnp.bfloat16)
        x = x.astype(np.float32)
        y_jax = jds.dia_matvec(vals_j, offsets, jnp.asarray(x), force="interpret")
        vals_t = to_tensor(np.asarray(vals_j))  # bit-exact bf16
        assert vals_t.dtype == torch.bfloat16
        y = tds.dia_matvec(vals_t, offsets, torch.from_numpy(x))
        assert y.dtype == torch.float32 and y_jax.dtype == jnp.float32
        assert_close(y, y_jax, 1e-5)

    def test_f64_matches_jax_kernel(self):
        n, offsets = 16500, (-16, -3, 0, 7, 16)
        vals, x = band(n, offsets, seed=2)
        y_jax = jds.dia_matvec(jnp.asarray(vals), offsets, jnp.asarray(x),
                               force="interpret")
        y = tds.dia_matvec(torch.from_numpy(vals), offsets, torch.from_numpy(x))
        assert y.dtype == torch.float64
        assert_close(y, y_jax, 1e-12)

    def test_c64_matches_jax_planes_kernel(self):
        n, offsets = 16384, (-130, -2, 0, 1, 129)
        vals, x = band(n, offsets, seed=3, complex_values=True)
        vals, x = vals.astype(np.complex64), x.astype(np.complex64)
        y_jax = jds.dia_matvec(jnp.asarray(vals), offsets, jnp.asarray(x),
                               force="interpret")
        y = tds.dia_matvec(torch.from_numpy(vals), offsets, torch.from_numpy(x))
        assert y.dtype == torch.complex64
        assert_close(y, y_jax, 1e-5)

    def test_offset_beyond_n_is_zero(self):
        # a diagonal entirely outside the matrix contributes nothing
        vals = torch.ones((2, 5))
        x = torch.arange(5, dtype=torch.float32)
        y = tds.dia_matvec(vals, (0, 7), x)
        np.testing.assert_array_equal(y.numpy(), x.numpy())


# tests/test_dia.py:110-115
IL_CASES = [
    (20000, tuple(range(-16, 17)), 64),
    (16500, (-16, -3, 0, 7, 16), 64),
    (20000, (-100, -3, 0, 5, 99), 64),
    (9000, (-1, 0, 1), 8),
]


class TestInterleaved:
    """B1: ``dia_matvec_il`` and ``dia_matvec_il_window``, and the layout."""

    @pytest.mark.parametrize("n,offsets,tile_s", IL_CASES)
    def test_f32_matches_jax_kernel(self, n, offsets, tile_s):
        vals, x = band(n, offsets, seed=7)
        vals, x = vals.astype(np.float32), x.astype(np.float32)
        R = jds.il_rows(n, tile_s)
        assert tds.il_rows(n, tile_s) == R
        vals_il_j = jds.interleave_dia_vals(jnp.asarray(vals), R)
        x_il_j = jds.interleave_vec(jnp.asarray(x), R)
        y_jax = jds.dia_matvec_il(vals_il_j, offsets, x_il_j, tile_s=tile_s,
                                  force="interpret")
        vals_il = tds.interleave_dia_vals(torch.from_numpy(vals), R)
        x_il = tds.interleave_vec(torch.from_numpy(x), R)
        np.testing.assert_array_equal(vals_il.numpy(), np.asarray(vals_il_j))
        np.testing.assert_array_equal(x_il.numpy(), np.asarray(x_il_j))
        y = tds.dia_matvec_il(vals_il, offsets, x_il)
        assert y.shape == (R, tds.LANES) and y.is_contiguous()
        assert_close(y, y_jax, 1e-5)

    def test_bf16_storage_matches_jax_kernel(self):
        n, offsets, tile_s = 20000, tuple(range(-16, 17)), 64
        vals, x = band(n, offsets, seed=8)
        R = jds.il_rows(n, tile_s)
        vals_il_j = jds.interleave_dia_vals(jnp.asarray(vals, jnp.bfloat16), R)
        x_il_j = jds.interleave_vec(jnp.asarray(x, jnp.float32), R)
        y_jax = jds.dia_matvec_il(vals_il_j, offsets, x_il_j, tile_s=tile_s,
                                  force="interpret")
        y = tds.dia_matvec_il(to_tensor(np.asarray(vals_il_j)), offsets,
                              to_tensor(np.asarray(x_il_j)))
        assert y.dtype == torch.float32
        assert_close(y, y_jax, 1e-5)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_window_with_halo_values_matches_jax(self, dtype):
        n, offsets = 20000, (-9, 0, 3, 9)
        vals, _ = band(n, offsets, seed=9)
        vals = vals.astype(dtype)
        R = jds.il_rows(n, 64)
        pr = jds.il_window_halo(offsets)
        assert tds.il_window_halo(offsets) == pr
        w = np.random.default_rng(10).uniform(-1, 1, (R + 2 * pr, 128)).astype(dtype)
        vals_il_j = jds.interleave_dia_vals(jnp.asarray(vals), R)
        y_jax = jds.dia_matvec_il_window(vals_il_j, offsets, jnp.asarray(w))
        y = tds.dia_matvec_il_window(to_tensor(np.asarray(vals_il_j)), offsets,
                                     torch.from_numpy(w))
        assert_close(y, y_jax, 1e-5 if dtype == np.float32 else 1e-12)

    @pytest.mark.parametrize("n,offsets", [(12345, (-8, 0, 8)),
                                           (3000, (-24, -1, 0, 17)),
                                           (128 * 64, (-1, 0, 1))])
    def test_window_matches_jax(self, n, offsets):
        x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
        R = jds.il_rows(n, 8)
        pr = jds.il_window_halo(offsets)
        w_j = jds._il_window(jds.interleave_vec(jnp.asarray(x), R), pr)
        w = tds._il_window(tds.interleave_vec(torch.from_numpy(x), R), pr)
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))

    @pytest.mark.parametrize("n,tile_s", [(1, 8), (12345, 64), (128 * 64, 64),
                                          (128 * 64 + 1, 8)])
    def test_codec_round_trip_matches_jax(self, n, tile_s):
        x = np.random.default_rng(0).random(n).astype(np.float32)
        R = tds.il_rows(n, tile_s)
        assert R == jds.il_rows(n, tile_s)
        x_il = tds.interleave_vec(torch.from_numpy(x), R)
        np.testing.assert_array_equal(
            x_il.numpy(), np.asarray(jds.interleave_vec(jnp.asarray(x), R)))
        np.testing.assert_array_equal(tds.deinterleave_vec(x_il, n).numpy(), x)

    def test_error_messages_match_jax(self):
        offsets = tuple(range(-20, 21))
        vals_il = np.zeros((len(offsets), 8, 128), np.float32)
        x_il = np.zeros((8, 128), np.float32)
        for fn in (jds.dia_matvec_il, tds.dia_matvec_il):
            arg = (jnp.asarray if fn is jds.dia_matvec_il else torch.from_numpy)
            with pytest.raises(ValueError,
                               match="dia_matvec_il: bandwidth exceeds chunk size R"):
                fn(arg(vals_il), offsets, arg(x_il))
        vals_il = np.zeros((3, 64, 128), np.float32)
        w = np.zeros((64 + 2, 128), np.float32)
        msgs = []
        for fn, arg in ((jds.dia_matvec_il_window, jnp.asarray),
                        (tds.dia_matvec_il_window, torch.from_numpy)):
            with pytest.raises(ValueError) as err:
                fn(arg(vals_il), (-1, 0, 1), arg(w))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == ("dia_matvec_il_window: window has 66 "
                                      "sublanes, expected R + 2*pr = 80")


class TestDispatch:
    """The plain versions run only for CPU tensors; anything else goes to
    a kernel wrapper, which launches or raises."""

    def test_non_cpu_tensors_never_take_the_plain_path(self):
        vals = torch.empty((3, 1000), device="meta")
        x = torch.empty(1000, device="meta")
        with pytest.raises(ValueError, match="expected a CUDA device"):
            tds.dia_matvec(vals, (-1, 0, 1), x)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            tds.dia_matvec(vals.to(torch.complex64), (-1, 0, 1),
                           x.to(torch.complex64))
        R = tds.il_rows(1000, 8)
        with pytest.raises(ValueError, match="expected a CUDA device"):
            tds.dia_matvec_il(torch.empty((3, R, 128), device="meta"), (-1, 0, 1),
                              torch.empty((R, 128), device="meta"))
        assert _build._lib is None  # rejected before any build
        assert all(k.launches == 0 for k in tds.KERNELS)

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc is neither on PATH"):
            _build.find_nvcc()

    def test_failed_build_raises_and_leaves_no_files(self, monkeypatch, tmp_path):
        # an nvcc that writes the file it is asked for, then fails on one source
        nvcc = tmp_path / "nvcc"
        nvcc.write_text('#!/bin/sh\nprev=""\nfor a in "$@"; do\n'
                        '  [ "$prev" = "-o" ] && : > "$a"\n  prev="$a"\ndone\n'
                        'case "$*" in *qr_kernels.cu*) echo "qr_kernels.cu: error"; exit 1;; esac\n')
        nvcc.chmod(0o755)
        build_dir = tmp_path / "build"
        monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
        monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
        with pytest.raises(RuntimeError, match="qr_kernels.cu: error"):
            _build.build()
        assert os.listdir(build_dir) == []

    def test_library_name_tracks_the_sources(self):
        path = _build.library_path()
        assert path == _build.library_path()
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert [os.path.basename(s) for s in _build.sources()] == [
            "dia_spmv.cu", "eig_common.cuh", "gell_spmv.cu", "gell_window_spmv.cu",
            "hessenberg_blocked.cu", "hessenberg_cluster.cu", "qr_eig_blocked.cu",
            "qr_kernels.cu", "trisolve_vec.cu"]
        # the header enters through the sources that include it
        assert [os.path.basename(s) for s in _build.compiled_sources()] == [
            "dia_spmv.cu", "gell_spmv.cu", "gell_window_spmv.cu", "hessenberg_blocked.cu",
            "hessenberg_cluster.cu", "qr_eig_blocked.cu", "qr_kernels.cu", "trisolve_vec.cu"]

    def test_import_builds_nothing_and_imports_no_jax(self):
        # every module of the port, the Krylov and block solvers, the writer,
        # logging, timing and demo.py among them
        code = ("import importlib, pkgutil, sys\n"
                "import pcsc_eigenvalue_solver_project_tpu_torch as p\n"
                "from pcsc_eigenvalue_solver_project_tpu_torch.ops import _build\n"
                "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
                "for name in names:\n"
                "    importlib.import_module(name)\n"
                "for name in ('demo', 'solvers.arnoldi', 'solvers.lanczos', 'solvers.lobpcg',\n"
                "             'io.writer', 'utils.logging', 'utils.timing'):\n"
                "    assert p.__name__ + '.' + name in names, name\n"
                "assert 'jax' not in sys.modules, 'jax imported'\n"
                "assert 'pcsc_eigenvalue_solver_project_tpu' not in sys.modules, 'JAX package'\n"
                "assert _build._lib is None, 'kernel library loaded'\n"
                "print('ok')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"
