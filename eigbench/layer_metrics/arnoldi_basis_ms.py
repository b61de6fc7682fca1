"""The device time around B1 in the Arnoldi projection: milliseconds a solve
in every device operation of the program other than B1 (the SpMV) and B8
(``qr_eig_kernel``, the m x m projection's sweeps). That is the modified
Gram-Schmidt dot products, updates and norms (``solvers/arnoldi.py``) and
the haloed window that ``ops/dia_spmv.py`` (``_il_window``) builds for each
B1 call: the layer "Krylov basis and B1 window". The benchmark's own draw
of the start vectors is not counted (``trace.py``)."""

from eigbench.layer_metrics.b1_roofline import is_b1

B8 = "qr_eig_kernel"


def read(run):
    t = run.trace
    if t is None or not t.kernels or not run.completed:
        return None
    return 1e3 * t.device_s(lambda name: not (is_b1(name) or name.startswith(B8))) / run.completed
