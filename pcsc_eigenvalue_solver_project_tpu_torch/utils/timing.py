"""Profiling and timing utilities (the port of the JAX package's
``utils/timing.py``).

- ``readback``: synchronise the tensor's device and pull one scalar to the
  host, so a timed call has finished when the clock stops.
- ``timed`` / ``marginal_loop_time``: wall-clock helpers on ``readback``;
  the marginal cost between two loop lengths takes the fixed cost of a
  call out of a per-iteration number.
- ``trace``: a ``torch.profiler`` trace of a code region, written as a
  Chrome trace; ``annotate``: a named region inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def readback(x) -> float:
    """Force completion: synchronise ``x``'s device, then pull one scalar
    to the host."""
    x = torch.as_tensor(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(torch.real(x.reshape(-1)[:1]).sum())


def timed(fn, *args, reps: int = 5, warmup: int = 2):
    """Min wall-clock seconds of ``fn(*args)`` with readback sync."""
    for _ in range(warmup):
        readback(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        readback(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def marginal_loop_time(run, args=(), lo: int = 100, hi: int = 1100,
                       reps: int = 3) -> float:
    """Marginal seconds/iteration of ``run(*args, iters)``: the difference
    of two loop lengths, which cancels the fixed cost of a call."""
    readback(run(*args, lo))
    readback(run(*args, hi))
    t_lo, t_hi = [], []
    for _ in range(reps):
        t0 = time.perf_counter(); readback(run(*args, lo)); t_lo.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); readback(run(*args, hi)); t_hi.append(time.perf_counter() - t0)
    return max((min(t_hi) - min(t_lo)) / (hi - lo), 1e-12)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace (host and, where there is a card, device
    activity) around a code region, written to ``log_dir/trace.json``
    (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a profiler trace."""
    with torch.profiler.record_function(name):
        yield
