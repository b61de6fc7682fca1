"""B13's share of its roofline: the least time of the solve's shifted
sweeps over B13's device time (``sweeps_kernel``, ``csrc/qr_eig_blocked.cu``),
in percent.

A sweep on an active window of h rows reads and writes the window's upper
Hessenberg part once, h^2 / 2 complex entries each way (the real matrix is
swept in its complex dtype), and does ~20 h^2 operations, a fifth of what
the memory bound allows: bytes bound it. Deflation shrinks the window from
n to 0 over the solve, about evenly (a few sweeps an eigenvalue), so the
mean h^2 is n^2 / 3 and a solve's least bytes are ``sweeps * n^2 / 3 *
itemsize`` with ``sweeps`` the result's count. The count follows the
sweeps: fewer sweeps lower it, so this share measures the sweeps' speed,
and ``qr_sweeps`` their number."""

from eigbench.layer_metrics import peaks

KERNEL = "sweeps_kernel"


def is_b13(name: str) -> bool:
    return name.startswith(KERNEL)


def least_s(n: int, sweeps: float, dtype: str) -> float:
    h2 = n * n / 3
    return peaks.bound_s(sweeps * h2 * peaks.complex_itemsize(dtype), sweeps * 20 * h2, dtype)


def read(run):
    t = run.trace
    if t is None or not run.iterations or not t.count(is_b13):
        return None
    cfg = run.config
    least = sum(least_s(cfg["n"], s, cfg["dtype"]) for s in run.iterations)
    return 100.0 * least / t.device_s(is_b13)
