"""B11's share of its roofline: the least time of one Hessenberg reduction
of an n x n matrix over B11's device time a solve, in percent.

Least work of one reduction without Q: 10/3 n^3 operations (Householder
reduction, LAPACK's xGEHRD count), the matrix read once and H written once,
``2 n^2 * itemsize`` bytes; the operations bound it. B11 is the column
kernels and split-K products of ``csrc/hessenberg_blocked.cu`` with
``eig_common.cuh``'s GEMM kernels, which nothing else launches on the
dense eigenvalue path below ``AED_MIN_N``."""

from eigbench.layer_metrics import peaks

KERNELS = ("col_update_kernel", "col_reflect_kernel", "col_finish_kernel", "zero_below_kernel",
           "gemm_op_kernel", "gemm_slices_kernel", "sum_slices_kernel", "eye_kernel")


def is_b11(name: str) -> bool:
    return name.startswith(KERNELS)


def least_s(n: int, dtype: str) -> float:
    return peaks.bound_s(2 * n * n * peaks.ITEMSIZE[dtype], 10 / 3 * n ** 3, dtype)


def read(run):
    t = run.trace
    if t is None or not run.completed or not t.count(is_b11):
        return None
    cfg = run.config
    return 100.0 * least_s(cfg["n"], cfg["dtype"]) / (t.device_s(is_b11) / run.completed)
