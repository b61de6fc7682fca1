"""The device's idle time while the host is in the program's calls, ms a
solve: each outermost span of the program's record (a public solver's
entry span) less its overlap with the union of the device's events in the
traced window (the program's and the benchmark's), over the harness's
traced solves. ``device_idle_pct`` less this is idle the harness owns (drawing
inputs, reading back, its loop).

The spans' clock (``time.time_ns``) is kineto's host clock, but kineto can
place a profile's device events up to milliseconds off its host events (on
the H100, 0.03 to 1.56 ms early in test profiles). The solve spans are
moved onto the device's clock by the blocking reads (``offset``)."""

import bisect

from eigbench import trace as tracing
from eigbench.layer_metrics import program_record

READ = "eigsol.read"
COPY = "Memcpy DtoH"
REACH_NS = 10_000_000  # the largest offset looked for


def overlap(busy, s, e) -> int:
    """Nanoseconds of ``[s, e)`` covered by the sorted, disjoint ``busy``."""
    i = max(bisect.bisect_right(busy, [s, float("inf")]) - 1, 0)
    covered = 0
    for b0, b1 in busy[i:]:
        if b0 >= e:
            break
        covered += max(0, min(b1, e) - max(b0, s))
    return covered


def offset(spans, kernels) -> int:
    """Device time less host time in this profile. Each read's
    device-to-host copy ends inside the read's span, so the offset is the
    shift that puts a copy's end inside the most read spans; of the shifts
    that do, the one that puts a copy's end at a read's end (the least)."""
    ends = sorted(e for name, _, e in kernels if name.startswith(COPY))
    reads = [(s.start_ns, s.end_ns) for s in spans if s.name == READ and s.end_ns]
    if not ends or not reads:
        return 0

    def held(shift):
        return sum(1 for s, e in reads
                   if bisect.bisect_left(ends, s + shift) < bisect.bisect_right(ends, e + shift))

    shifts = {c - e for _, e in reads
              for c in ends[bisect.bisect_left(ends, e - REACH_NS):
                            bisect.bisect_right(ends, e + REACH_NS)]}
    return max(shifts, key=lambda d: (held(d), -d), default=0)


def read(run):
    t = run.trace
    record = program_record.read()
    if t is None or not t.kernels or record is None or not run.completed:
        return None
    solves = program_record.solves(record[0])
    if not solves:
        return None
    d = offset(record[0], t.kernels)
    busy = tracing.union((s, e) for _, s, e in t.kernels + t.benchmark)
    ns = sum((e - s) - overlap(busy, s + d, e + d) for _, s, e, _ in solves)
    return ns / 1e6 / run.completed
