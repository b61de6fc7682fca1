"""Build and load the port's CUDA kernels at first use.

The sources are ``csrc/*.cu`` and the headers they include,
``csrc/*.cuh``. Each ``.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes. Nothing
happens at import: the first CUDA launch calls ``load()``. The library's file
name carries a hash of the sources and the flags, so an edited source is
never served by a stale library. Builds go to ``_build/`` inside the package
(listed in ``.gitignore``).
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
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def sources() -> list:
    """Every file the library is built from: the ``.cu`` files and headers."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def compiled_sources() -> list:
    """The ``.cu`` files, one nvcc each; headers enter through them."""
    return [path for path in sources() if path.endswith(".cu")]


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


def _run_all(cmds: list) -> None:
    """Run the commands at once; raise with the output of the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile the sources unless a library for them exists; return its path.

    Raises ``RuntimeError`` carrying nvcc's output if the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in compiled_sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(compiled_sources(), objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.so", *objects]])
        os.replace(f"{tmp}.so", path)  # atomic: concurrent builders never see half a file
    finally:
        for leftover in (*objects, f"{tmp}.so"):
            if os.path.exists(leftover):
                os.remove(leftover)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_double)
            # dtype, device, vals, x, offsets, k, n, y, stream
            lib.dia_rowmajor_spmv.argtypes = [i32, i32, ptr, ptr, ptr, i32, i64, ptr, ptr]
            lib.dia_rowmajor_spmv.restype = i32
            # dtype, device, vals_il, w, offsets, k, pr, R*128, y, stream
            lib.dia_il_window_spmv.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i64, ptr, ptr]
            lib.dia_il_window_spmv.restype = i32
            # dtype, device, vals_p, x_p, offsets, k, pr, m, x plane stride, window, y, stream
            lib.dia_planes_spmv.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i64, i64, i32,
                                            ptr, ptr]
            lib.dia_planes_spmv.restype = i32
            # dtype, device, vals, x, offsets, k, omin, omax, pr, len, x_len, x strides
            # (vector, position), y strides, nvec, window, staged, smem, y, stream
            lib.dia_block_spmm.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64,
                                           i64, i64, i64, i64, i32, i32, i32, i64, ptr, ptr]
            lib.dia_block_spmm.restype = i32
            # dtype, device, a, h, q, slabs, n, cluster, h_smem, q_smem, smem, stream
            lib.qr_hessenberg.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64,
                                          ptr]
            lib.qr_hessenberg.restype = i32
            # dtype, device, cluster, smem, clusters (host int out)
            lib.hessenberg_cluster_capacity.argtypes = [i32, i32, i32, i64, ptr]
            lib.hessenberg_cluster_capacity.restype = i32
            # device, cluster, iterations, stream
            lib.cluster_barrier_probe.argtypes = [i32, i32, i32, ptr]
            lib.cluster_barrier_probe.restype = i32
            # dtype, device, a, r, q, scratch, n, kmax, nb, launches (host), stream
            lib.qr_householder.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i64, i64, i32, ptr, ptr]
            lib.qr_householder.restype = i32
            # dtype, device, h_in, h, q, rot, eig, state, n, max_sweeps, tol, stream
            lib.qr_eig_givens.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32,
                                          f64, ptr]
            lib.qr_eig_givens.restype = i32
            # dtype, device, h_in, h, r, q, scratch, state, n, max_it, tol, chunk, stream
            lib.qr_parity_sweeps.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32,
                                             f64, i32, ptr]
            lib.qr_parity_sweeps.restype = i32
            # dtype, device, a, h, q, scratch, n, nb, launches (host), stream
            lib.hessenberg_blocked.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i64, i32, ptr, ptr]
            lib.hessenberg_blocked.restype = i32
            # n, nb
            lib.hessenberg_blocked_scratch.argtypes = [i64, i32]
            lib.hessenberg_blocked_scratch.restype = i64
            # dtype, device, t, y, racc, counts, n, eps, stream
            lib.trisolve_eigenvectors.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i64, f64, ptr]
            lib.trisolve_eigenvectors.restype = i32
            lib.trisolve_block_rows.argtypes = [i32]  # dtype
            lib.trisolve_block_rows.restype = i32
            lib.trisolve_scratch.argtypes = [i32, i64]  # dtype, n
            lib.trisolve_scratch.restype = i64
            # dtype, device, h, q, ubuf, side, flags, eig, state, mu, shifts, n_shifts, n,
            # max_sweeps, tol, bs, grid (0: the default), launches (host), stream
            lib.qr_eig_blocked_sweeps.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                                  ptr, ptr, i32, i64, i32, f64, i32, i32, ptr,
                                                  ptr]
            lib.qr_eig_blocked_sweeps.restype = i32
            # dtype, device, bs, (blocks, SMs) (host int[2] out)
            lib.qr_eig_blocked_capacity.argtypes = [i32, i32, i32, ptr]
            lib.qr_eig_blocked_capacity.restype = i32
            # the pack's launch arguments (a struct), x, x plane stride, y, stream
            lib.gell_csr_spmv.argtypes = [ptr, ptr, i64, ptr, ptr]
            lib.gell_csr_spmv.restype = i32
            lib.gell_window_spmv.argtypes = [ptr, ptr, i64, ptr, ptr]
            lib.gell_window_spmv.restype = i32
            # device, cluster, clusters (host int out)
            lib.gell_window_capacity.argtypes = [i32, i32, ptr]
            lib.gell_window_capacity.restype = i32
            lib.dia_cuda_error_string.argtypes = [i32]
            lib.dia_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
