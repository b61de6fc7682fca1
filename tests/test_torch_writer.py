"""The text writer of the PyTorch port against the JAX package's, on the CPU
(the writer cases of tests/test_io.py and tests/test_native_io.py).

Both paths of the port's writer, the native one (``io/native.py``'s
``write_dense`` / ``write_sparse``) and the Python formatter (the native
writer switched off), write the same bytes as the JAX package's writer on
the same matrices, and every file reads back exactly through both of the
port's readers (native and Python).
"""

import os

import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu as J
from pcsc_eigenvalue_solver_project_tpu.io import native as j_native
from pcsc_eigenvalue_solver_project_tpu.models.generators import banded_random as j_banded
import pcsc_eigenvalue_solver_project_tpu_torch as T
from pcsc_eigenvalue_solver_project_tpu_torch.io import native as t_native
from pcsc_eigenvalue_solver_project_tpu_torch.io import reader as t_reader
from pcsc_eigenvalue_solver_project_tpu_torch.io import writer as t_writer
from pcsc_eigenvalue_solver_project_tpu_torch.models.generators import banded_random as t_banded

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

needs_writer = pytest.mark.skipif(not t_native.writer_available(),
                                  reason="native writer not built")


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Which of the port's writer paths runs."""
    if request.param == "native":
        if not t_native.writer_available():
            pytest.skip("native writer not built")
    else:
        monkeypatch.setattr(t_native, "writer_available", lambda: False)
    return request.param


def dense_pair(a):
    return J.DenseMatrix.from_array(a), T.DenseMatrix.from_array(a, device="cpu")


def sparse_pair(a, dtype):
    return (J.SparseCSR.from_dense(a, dtype=dtype),
            T.SparseCSR.from_dense(a, dtype=dtype, device="cpu"))


def write_both(tmp_path, pair):
    pj, pt = tmp_path / "jax.txt", tmp_path / "port.txt"
    J.write_matrix_to_file(str(pj), pair[0])
    T.write_matrix_to_file(str(pt), pair[1])
    return pj, pt


def read_both(p, dtype):
    """The file through the port's native and Python readers."""
    out = [t_reader.read_matrix_from_file(p, dtype, use_native=False, device="cpu")]
    if t_native.available():
        out.append(t_reader.read_matrix_from_file(p, dtype, device="cpu"))
    return [m.to_dense().numpy() for m in out]


class TestWriterRoundtrip:
    def test_dense_roundtrip(self, tmp_path, path):
        a = np.random.default_rng(3).random((4, 5))
        pj, pt = write_both(tmp_path, dense_pair(a))
        assert pt.read_bytes() == pj.read_bytes()
        for got in read_both(str(pt), np.float64):
            np.testing.assert_array_equal(got, a)

    def test_sparse_complex_roundtrip(self, tmp_path, path):
        rng = np.random.default_rng(4)
        a = (rng.random((6, 6)) + 1j * rng.random((6, 6))) * (rng.random((6, 6)) < 0.3)
        pj, pt = write_both(tmp_path, sparse_pair(a, np.complex128))
        assert pt.read_bytes() == pj.read_bytes()
        for got in read_both(str(pt), np.complex128):
            np.testing.assert_array_equal(got, a)

    def test_dense_complex_roundtrip_exact(self, tmp_path, path):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((17, 23)) + 1j * rng.standard_normal((17, 23))
        pj, pt = write_both(tmp_path, dense_pair(a))
        assert pt.read_bytes() == pj.read_bytes()
        for got in read_both(str(pt), np.complex128):
            np.testing.assert_array_equal(got, a)

    def test_sparse_roundtrip_exact(self, tmp_path, path):
        mj = j_banded(300, bandwidth=4, nnz_per_row=5, dtype=np.float64, seed=3)
        mt = t_banded(300, bandwidth=4, nnz_per_row=5, dtype=np.float64, seed=3, device="cpu")
        pj, pt = write_both(tmp_path, (mj, mt))
        assert pt.read_bytes() == pj.read_bytes()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(300))
        for kw in ({"use_native": False}, {}):
            r = t_reader.read_matrix_from_file(str(pt), np.float64, device="cpu", **kw)
            np.testing.assert_array_equal(r.matvec(x).numpy(), mt.matvec(x).numpy())

    @pytest.mark.parametrize("dtype", [np.float32, np.complex64])
    def test_single_precision_text(self, tmp_path, path, dtype):
        """float32/complex64 values print as the JAX writer prints them."""
        rng = np.random.default_rng(5)
        a = (rng.standard_normal((7, 3)) + (1j * rng.standard_normal((7, 3))
                                            if dtype == np.complex64 else 0)).astype(dtype)
        pj, pt = write_both(tmp_path, dense_pair(a))
        assert pt.read_bytes() == pj.read_bytes()
        pj, pt = write_both(tmp_path, sparse_pair(a * (np.abs(a) > 0.5), dtype))
        assert pt.read_bytes() == pj.read_bytes()

    def test_reference_data_files_roundtrip(self, tmp_path, path):
        for name in ("A", "B"):
            m = T.read_matrix_from_file(os.path.join(DATA, f"{name}.txt"), np.complex128,
                                        device="cpu")
            p = tmp_path / f"{name}.txt"
            T.write_matrix_to_file(str(p), m)
            for got in read_both(str(p), np.complex128):
                np.testing.assert_array_equal(got, m.to_dense().numpy())


class TestNativeWriter:
    def test_availability_matches_jax(self):
        assert t_native.writer_available() == j_native.writer_available()

    @pytest.mark.parametrize("found", ["absent", "half_written"])
    def test_library_is_built_aside_and_moved_into_place(self, tmp_path, monkeypatch, found):
        # a missing library, or one that does not load (being written in
        # place by another process), is built in a fresh directory and
        # renamed into place, which leaves nothing else behind
        so = tmp_path / "build" / "libfast_reader.so"
        if found == "half_written":
            so.parent.mkdir()
            so.write_bytes(b"\x7fELF\x02\x01\x01")
        monkeypatch.setattr(t_native, "_SO_PATH", str(so))
        lib = t_native._open_library()
        assert lib.eigsol_read_header and lib.eigsol_write_dense
        assert os.listdir(so.parent) == [so.name] and so.stat().st_size > 1000

    @needs_writer
    def test_native_output_matches_python_writer(self, tmp_path, monkeypatch):
        rng = np.random.default_rng(2)
        for m in (T.DenseMatrix.from_array(rng.standard_normal((6, 4)), device="cpu"),
                  T.SparseCSR.from_dense(rng.standard_normal((6, 6)) * (rng.random((6, 6)) < .4)
                                         + 1j * (rng.random((6, 6)) < .2), device="cpu")):
            p_native, p_py = tmp_path / "n.txt", tmp_path / "p.txt"
            T.write_matrix_to_file(p_native, m)
            with monkeypatch.context() as mp:
                mp.setattr(t_native, "writer_available", lambda: False)
                T.write_matrix_to_file(p_py, m)
            assert p_native.read_bytes() == p_py.read_bytes()

    @needs_writer
    def test_native_raises_oserror(self, tmp_path):
        with pytest.raises(OSError):
            t_native.write_dense(str(tmp_path / "no" / "such" / "dir.txt"), np.eye(2))

    def test_unsupported_type(self, tmp_path):
        data = torch.ones((1, 4), dtype=torch.float64)
        m = T.SparseDIA(data=data, offsets=(0,), shape=(4, 4))
        with pytest.raises(TypeError, match="unsupported matrix type SparseDIA"):
            T.write_matrix_to_file(str(tmp_path / "x.txt"), m)

    def test_bf16_dense_writes_its_float32_values(self, tmp_path):
        a = torch.tensor([[1.5, -2.25], [3.0, 0.1]], dtype=torch.bfloat16)
        p, q = tmp_path / "b.txt", tmp_path / "f.txt"
        t_writer.write_matrix_to_file(str(p), T.DenseMatrix(a))
        t_writer.write_matrix_to_file(str(q), T.DenseMatrix(a.to(torch.float32)))
        assert p.read_bytes() == q.read_bytes()
