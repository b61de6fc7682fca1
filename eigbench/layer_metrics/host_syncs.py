"""The program's blocking transfers between host and device a solve: the
record's counters ``host_reads`` and ``host_writes`` over the harness's
traced solves. ``host_reads`` counts each read of
``utils/timing.py::host_read`` (the power loop's ``(k, done)`` once a
block, the QR driver's and Arnoldi's sweep count and ``hi``) and each read
of B13's (or B10's) launcher, which blocks on the card after every
cooperative launch to read the sweeps' state; ``host_writes`` each copy of
a host value to the device through ``host_write`` (the loops' flags and
tolerance, Arnoldi's breakdown index, a QR result's sweep count and flag),
which waits for the work queued before it. On the card these are the
solve's blocking runtime calls, one each."""

from eigbench.layer_metrics import program_record


def read(run):
    record = program_record.read()
    if record is None or not run.completed:
        return None
    counters = record[1]
    return (counters.get("host_reads", 0) + counters.get("host_writes", 0)) / run.completed
