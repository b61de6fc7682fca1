"""The QR driver's sweeps a solve: the mean of ``QRResult.iterations`` over
the traced solves."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
