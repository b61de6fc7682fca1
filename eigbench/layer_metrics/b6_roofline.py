"""B6's share of its roofline: the least time of one general sparse SpMV on
this operator over B6's device time a call, in percent.

Least bytes of one call: each stored entry's int32 column and float32
value read once, the int32 row pointer once, x read once and y written
once, ``stored_entries (4 + 4) + (n + 1) 4 + 2 n 4``; the 2 operations an
entry are far below the memory bound. The count is the operator's, whatever
kernel computes the product. B6 is its kernels by name, either route
(``csrc/gell_spmv.cu``, ``csrc/gell_window_spmv.cu``); each call launches
exactly one of them, so the trace counts the calls."""

from eigbench.layer_metrics import peaks

KERNELS = ("gell_real_kernel", "gell_complex_kernel", "gell_window_kernel")


def is_b6(name: str) -> bool:
    return name.startswith(KERNELS)


def least_s(cfg: dict) -> float:
    n, nnz = 2 ** cfg["scale"], cfg["stored_entries"]
    return peaks.bound_s(nnz * (4 + 4) + (n + 1) * 4 + 2 * n * 4, 2 * nnz, cfg["dtype"])


def read(run):
    t = run.trace
    calls = t.count(is_b6) if t is not None else 0
    if not calls:
        return None
    return 100.0 * least_s(run.config) / (t.device_s(is_b6) / calls)
