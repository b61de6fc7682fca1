"""The device time around B6 in the Arnoldi projection on the graph:
milliseconds a solve in every device operation of the program other than
B6 (the SpMV) and B8 (``qr_eig_kernel``, the m x m projection's sweeps).
That is the modified Gram-Schmidt dot products, updates and norms
(``solvers/arnoldi.py``) on vectors of 2^26 rows: the layer "Krylov basis
at 2^26 rows". The benchmark's own draw of the start vectors is not counted
(``trace.py``)."""

from eigbench.layer_metrics.arnoldi_basis_ms import B8
from eigbench.layer_metrics.b6_roofline import is_b6


def read(run):
    t = run.trace
    if t is None or not t.kernels or not run.completed:
        return None
    return 1e3 * t.device_s(lambda name: not (is_b6(name) or name.startswith(B8))) / run.completed
