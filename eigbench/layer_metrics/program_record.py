"""The program's own spans and counters (the port's ``utils/timing.py``),
which it keeps while a profile is on: the traced window's solves, since
the warm-up and the check run with the profiler off. A program without
that record gives None, and so do the metrics that read it."""

from __future__ import annotations


def read():
    """``(spans, counters)`` of the program's record, or None where the
    program keeps none or it is empty."""
    try:
        from pcsc_eigenvalue_solver_project_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "spans") or not hasattr(timing, "counters"):
        return None
    spans = timing.spans()
    return (spans, timing.counters()) if spans else None


def solves(spans) -> list:
    """For each outermost, closed span (a public solver's entry span: one
    a solve of the harness), ``(index, start_ns, end_ns, waits)``: its index
    in ``spans`` and ``waits`` the ``(start_ns, end_ns)`` of the outermost
    spans inside it in which the host blocks on the device."""
    out, index = [], {}
    for i, s in enumerate(spans):
        if s.parent is None and s.end_ns:
            index[i] = len(out)
            out.append((i, s.start_ns, s.end_ns, []))
    waiting = set()  # spans that are, or lie inside, a wait span
    for i, s in enumerate(spans):
        if s.parent in waiting:
            waiting.add(i)
        elif s.wait:
            waiting.add(i)
            if s.solve in index and s.end_ns:
                out[index[s.solve]][3].append((s.start_ns, s.end_ns))
    return out
