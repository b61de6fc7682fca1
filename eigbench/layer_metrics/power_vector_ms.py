"""The device time around B1 in the power loop: milliseconds an iteration
in every device operation of the program other than B1, over the traced
solves' iterations as the results count them. That is the loop's norm,
division, dot product and masked updates (``solvers/power.py``,
``utils/loops.py``) and the haloed window that ``ops/dia_spmv.py``
(``_il_window``) builds for each B1 call, its zero fill and copies: the
layer "power loop and B1 window". A change that folds the window into B1
lowers this and shows in ``b1_roofline`` as well. The benchmark's own draw
of the start vectors is not counted (``trace.py``)."""

from eigbench.layer_metrics.b1_roofline import is_b1


def read(run):
    t = run.trace
    iterations = sum(run.iterations)
    if t is None or not t.kernels or not iterations:
        return None
    return 1e3 * t.device_s(lambda name: not is_b1(name)) / iterations
