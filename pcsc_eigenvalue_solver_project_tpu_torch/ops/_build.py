"""Build and load the port's CUDA kernels at first use.

The sources are ``csrc/*.cu``. They are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ctypes. Nothing happens at import: the first CUDA launch calls
``load()``. The library's file name carries a hash of the sources and the
flags, so an edited source is never served by a stale library. Builds go to
``_build/`` inside the package (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libeigsol_kernels_{h.hexdigest()[:16]}.so")


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError("CUDA kernels cannot be built: nvcc is neither on PATH "
                       f"nor at {candidate}")


def build() -> str:
    """Compile the sources unless a library for them exists; return its path.

    Raises ``RuntimeError`` carrying nvcc's output if the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # dtype, device, vals, x, offsets, k, n, y, stream
            lib.dia_rowmajor_spmv.argtypes = [i32, i32, ptr, ptr, ptr, i32, i64, ptr, ptr]
            lib.dia_rowmajor_spmv.restype = i32
            # dtype, device, vals_il, w, offsets, k, pr, R*128, y, stream
            lib.dia_il_window_spmv.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i64, ptr, ptr]
            lib.dia_il_window_spmv.restype = i32
            lib.dia_cuda_error_string.argtypes = [i32]
            lib.dia_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
