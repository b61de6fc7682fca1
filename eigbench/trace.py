"""The traced run's profile, reduced to what the per-layer metrics read.

The profile is torch.profiler's (CUPTI on the card) over the traced window,
which the harness marks with the span ``eigbench.window``. Device events are
read from kineto's own list, which keeps cooperative launches (B13) that
``prof.events()`` can miss. The device's busy time is the union of its
events' spans inside the window (kernels that overlap count once); the idle
gaps are the rest of the window, each named by what the host was doing at
its middle: the benchmark's span around it and the innermost host
operation.

Device work that the benchmark itself asks for inside the window (drawing
a solve's inputs, under the span ``eigbench.inputs``) is the device's, and
counts in its busy time, but is no layer's of the program: an event whose
launch (the CUDA runtime call with the same correlation id) lies inside
that span is kept apart from the events the per-layer metrics read."""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

WINDOW_SPAN = "eigbench.window"
INPUTS_SPAN = "eigbench.inputs"
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernelEx, ...
SPAN_PREFIX = "eigbench."
TOP = 10


@dataclasses.dataclass
class Trace:
    """Device events inside the traced window, ``(name, start_ns, end_ns)``:
    the program's (``kernels``) and those launched from the benchmark's
    input span (``benchmark``); the window's length and the device's busy
    time, over both, in seconds."""

    kernels: list
    window_s: float
    busy_s: float
    breakdown: dict
    benchmark: list = dataclasses.field(default_factory=list)

    def device_s(self, match=None) -> float:
        """Device seconds of the program's events whose name ``match``
        accepts (all when None), each event counted whole."""
        return sum(e - s for name, s, e in self.kernels
                   if match is None or match(name)) / 1e9

    def count(self, match) -> int:
        return sum(1 for name, _, _ in self.kernels if match(name))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: ``void (anonymous namespace)::k<float>(float*)`` is ``k<float>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    head, sep, tail = name.split("(", 1)[0].partition("<")
    return (head.rsplit("::", 1)[-1] + sep + tail).strip()[:160]


def union(spans):
    """The disjoint union of ``(start, end)`` spans, sorted."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def host_activity(cpu_events, points):
    """For each time in ``points`` (sorted), the name of what the host
    thread was doing then: ``<outermost benchmark span>/<innermost event>``,
    from properly nested ``(start, end, name)`` events of one thread."""
    names = []
    stack = []
    events = sorted(cpu_events, key=lambda ev: (ev[0], -ev[1]))
    starts = [ev[0] for ev in events]
    nxt = 0
    for t in points:
        stop = bisect.bisect_right(starts, t)
        for ev in events[nxt:stop]:
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
        nxt = max(nxt, stop)
        while stack and stack[-1][1] <= t:
            stack.pop()
        live = [ev for ev in stack if ev[0] <= t < ev[1]]
        outer = next((ev[2] for ev in live
                      if ev[2].startswith(SPAN_PREFIX) and ev[2] != WINDOW_SPAN), "harness")
        inner = live[-1][2] if live and live[-1][2] != WINDOW_SPAN else "python"
        names.append(f"{outer}/{inner}")
    return names


def inside(spans, t) -> bool:
    """Whether time ``t`` lies in one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def reduce(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a ``Trace``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    window = next((ev for ev in events
                   if ev.name() == WINDOW_SPAN and ev.device_type() != cuda), None)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN} span")
    w0, w1 = window.start_ns(), window.end_ns()
    thread = window.start_thread_id()
    host = [ev for ev in events if ev.device_type() != cuda]
    inputs = sorted((ev.start_ns(), ev.end_ns()) for ev in host
                    if ev.name() == INPUTS_SPAN and ev.start_thread_id() == thread)
    launched = {ev.correlation_id(): ev.start_ns() for ev in host
                if RUNTIME_CALL.match(ev.name()) and ev.start_thread_id() == thread}
    kernels, benchmark, cpu = [], [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or ev.name().startswith(SPAN_PREFIX):
                continue  # the benchmark's spans, mirrored on the device's timeline
            s, e = max(s, w0), min(e, w1)
            if e > s:
                launch = launched.get(ev.correlation_id())
                ours = launch is not None and inside(inputs, launch)
                (benchmark if ours else kernels).append((short_name(ev.name()), s, e))
        elif ev.start_thread_id() == thread and e > w0 and s < w1:
            cpu.append((s, e, ev.name()))
    busy = union((s, e) for _, s, e in kernels + benchmark)
    busy_ns = sum(e - s for s, e in busy)
    gaps, edge = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    by_op = defaultdict(float)
    for name, s, e in kernels + benchmark:
        by_op[name] += (e - s) / 1e9
    by_host = defaultdict(float)
    gaps.sort(key=lambda g: (g[0] + g[1]) / 2)
    for (s, e), name in zip(gaps, host_activity(cpu, [(s + e) / 2 for s, e in gaps])):
        by_host[name] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(kernels=kernels, window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                 breakdown={"device_ops": top(by_op), "idle_gaps": top(by_host)},
                 benchmark=benchmark)
