"""Time to a solution: the window's wall-clock over the solves completed in
it. The window runs from the first solve's start to the last one's end; no
solve starts after ``--seconds``, except to finish a pass over a pool."""


def read(run):
    return run.window_s / run.completed if run.completed else None
