"""B1's share of its roofline: the least time of one banded SpMV on this
operator over B1's device time a call, in percent.

Least bytes of one call: the k stored diagonals of n values each read once,
x read once, y written once, ``(k n + 2 n) * itemsize``; the 2 k n
operations are far below the memory bound. The count is the operator's,
whatever kernel computes the product. B1 is ``dia_il_window_kernel``
(``csrc/dia_spmv.cu``)."""

from eigbench.builders import stencil27
from eigbench.layer_metrics import peaks

KERNEL = "dia_il_window_kernel"


def is_b1(name: str) -> bool:
    return name.startswith(KERNEL)


def least_s(cfg: dict) -> float:
    n, k = stencil27.size(cfg), len(stencil27.offsets(cfg["grid"]))
    item = peaks.ITEMSIZE[cfg["dtype"]]
    return peaks.bound_s((k * n + 2 * n) * item, 2 * k * n, cfg["dtype"])


def read(run):
    t = run.trace
    calls = t.count(is_b1) if t is not None else 0
    if not calls:
        return None
    return 100.0 * least_s(run.config) / (t.device_s(is_b1) / calls)
