"""ctypes bindings to the native C++ matrix parser and writer
(native/fast_reader.cpp).

The same library as the JAX package's ``io/native.py``:
``native/build/libfast_reader.so``, built with ``make -C native`` on first
use (``_open_library``). If the toolchain, the build or a symbol is missing, ``available()`` is
False and reader.py parses with its pure-Python tokenizer, which implements
the identical grammar and error messages; likewise ``writer_available()``
and writer.py's Python formatter, which writes the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from ..core.device import resolve_device
from ..core.dtypes import canonical_dtype, is_complex_dtype, numpy_dtype

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libfast_reader.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _open_library() -> ctypes.CDLL:
    """The library, loaded. Where it is absent, or does not load because
    another process is writing it in place (the JAX package's loader runs
    ``make`` on the same file), it is built in a fresh directory, loaded
    from there and moved into place with one rename: processes that start
    at once never load a half-written file of this loader's making."""
    if os.path.exists(_SO_PATH):
        try:
            return ctypes.CDLL(_SO_PATH)
        except OSError:
            pass
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    build = tempfile.mkdtemp(prefix=".build-", dir=os.path.dirname(_SO_PATH))
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={build}"], check=True,
                       capture_output=True, timeout=120)
        built = os.path.join(build, os.path.basename(_SO_PATH))
        lib = ctypes.CDLL(built)
        os.replace(built, _SO_PATH)
        return lib
    finally:
        shutil.rmtree(build, ignore_errors=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _open_library()
            lib.eigsol_read_header.restype = ctypes.c_int
            lib.eigsol_read_header.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.c_char_p, ctypes.c_int]
            lib.eigsol_read_dense.restype = ctypes.c_int
            lib.eigsol_read_dense.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.c_char_p, ctypes.c_int]
            lib.eigsol_read_sparse.restype = ctypes.c_int
            lib.eigsol_read_sparse.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
            # writer symbols (absent in a stale cached .so; the bindings
            # stay optional, as in the JAX package)
            try:
                lib.eigsol_write_dense.restype = ctypes.c_int
                lib.eigsol_write_dense.argtypes = [
                    ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.c_char_p, ctypes.c_int]
                lib.eigsol_write_sparse.restype = ctypes.c_int
                lib.eigsol_write_sparse.argtypes = [
                    ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.c_char_p, ctypes.c_int]
                lib._has_writer = True
            except AttributeError:
                lib._has_writer = False
            _lib = lib
        except (OSError, AttributeError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


_ERRLEN = 512


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def read_matrix_from_file(filename, dtype, device=None):
    """Native-parse a matrix file; raises ValueError with reference-parity
    messages on malformed input. Returns DenseMatrix or SparseCSR on
    ``device`` (default: the card)."""
    from ..matrix.dense import DenseMatrix
    from ..matrix.sparse import SparseCSR

    lib = _load()
    if lib is None:
        raise ImportError("native reader unavailable")
    dtype = canonical_dtype(dtype)
    device = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    cx = is_complex_dtype(dtype)
    path = os.fspath(filename).encode()
    err = ctypes.create_string_buffer(_ERRLEN)
    storage = ctypes.c_int()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    nnz = ctypes.c_long()
    if lib.eigsol_read_header(path, ctypes.byref(storage), ctypes.byref(rows),
                              ctypes.byref(cols), ctypes.byref(nnz), err, _ERRLEN):
        raise ValueError(err.value.decode())

    if storage.value == 0:
        total = rows.value * cols.value
        re = np.empty(total, np.float64)
        im = np.empty(total, np.float64) if cx else np.empty(0, np.float64)
        if lib.eigsol_read_dense(path, int(cx), rows.value, cols.value,
                                 _dp(re), _dp(im), err, _ERRLEN):
            raise ValueError(err.value.decode())
        arr = (re + 1j * im) if cx else re
        return DenseMatrix.from_array(
            arr.reshape(rows.value, cols.value).astype(np_dtype), dtype=dtype,
            device=device)

    rr = np.empty(nnz.value, np.int64)
    cc = np.empty(nnz.value, np.int64)
    re = np.empty(nnz.value, np.float64)
    im = np.empty(nnz.value, np.float64) if cx else np.empty(0, np.float64)
    if lib.eigsol_read_sparse(path, int(cx), rows.value, cols.value, nnz.value,
                              _lp(rr), _lp(cc), _dp(re), _dp(im), err, _ERRLEN):
        raise ValueError(err.value.decode())
    vals = (re + 1j * im) if cx else re
    return SparseCSR.from_coo(rr, cc, vals.astype(np_dtype),
                              (rows.value, cols.value), dtype=dtype,
                              sum_duplicates=False, device=device)



def writer_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_has_writer", False)


_NULL_DP = ctypes.POINTER(ctypes.c_double)()


def write_dense(filename, array: np.ndarray) -> None:
    """Native dense write (reference grammar) of a host array; raises
    OSError on failure."""
    lib = _load()
    if lib is None or not getattr(lib, "_has_writer", False):
        raise ImportError("native writer unavailable")
    a = np.ascontiguousarray(array)
    cx = np.iscomplexobj(a)
    re = np.ascontiguousarray(a.real if cx else a, np.float64)
    im = np.ascontiguousarray(a.imag, np.float64) if cx else None
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.eigsol_write_dense(
        os.fspath(filename).encode(), a.shape[0], a.shape[1], _dp(re),
        _dp(im) if cx else _NULL_DP, err, _ERRLEN)
    if rc:
        raise OSError(err.value.decode())


def write_sparse(filename, shape, rows: np.ndarray, cols: np.ndarray,
                 data: np.ndarray) -> None:
    """Native sparse (COO triplet) write of host arrays; raises OSError on
    failure."""
    lib = _load()
    if lib is None or not getattr(lib, "_has_writer", False):
        raise ImportError("native writer unavailable")
    cx = np.iscomplexobj(data)
    rr = np.ascontiguousarray(rows, np.int64)
    cc = np.ascontiguousarray(cols, np.int64)
    re = np.ascontiguousarray(data.real if cx else data, np.float64)
    im = np.ascontiguousarray(data.imag, np.float64) if cx else None
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.eigsol_write_sparse(
        os.fspath(filename).encode(), shape[0], shape[1], len(re), _lp(rr),
        _lp(cc), _dp(re), _dp(im) if cx else _NULL_DP, err, _ERRLEN)
    if rc:
        raise OSError(err.value.decode())
