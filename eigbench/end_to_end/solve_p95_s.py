"""The tail of one solve: the 95th percentile of every solve's own
wall-clock in the window (NumPy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.solve_times, 95)) if run.solve_times else None
