"""Host time in the program's calls not blocked on the card, ms a solve:
the outermost spans of the program's record (each the entry span of a
public solver, ``eigsol.power_method`` and the like) less the outermost
spans inside them in which the host waits for the device (``eigsol.read``,
``eigsol.write``, ``eigsol.qr.sweeps``), over the harness's traced solves.
That is Python, PyTorch's dispatch and the kernels' launches; the
profiler's own host work inflates it."""

from eigbench.layer_metrics import program_record


def read(run):
    record = program_record.read()
    solves = program_record.solves(record[0]) if record is not None else []
    if not solves or not run.completed:
        return None
    ns = sum((e - s) - sum(we - ws for ws, we in waits) for _, s, e, waits in solves)
    return ns / 1e6 / run.completed
