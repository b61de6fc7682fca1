"""The device's idle share of the traced window: 100 less the union of its
events' spans over the window's wall-clock, in percent."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
