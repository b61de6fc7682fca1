"""Profiling utilities, and the port's own spans and counters.

- ``readback``: synchronise the tensor's device and pull one scalar to the
  host, so a timed call has finished when the clock stops.
- ``trace``: a ``torch.profiler`` trace of a code region, written as a
  Chrome trace (open it in Perfetto).
- ``annotate(name, wait=False)``: the program's span. While a
  ``torch.profiler`` profile is on it opens a profiler range ``name`` (the
  fast C++ range where the installed PyTorch has one, ~1.7 µs against ~14 µs
  for ``record_function`` on a CPU), so the span lies on the profile's host
  timeline beside the device's kernels, and adds one entry to the record
  (``spans()``); while none is on it costs one check.
  ``wait=True`` marks a span in which the host blocks on the device.
- ``count(name, k)``: a counter of the record (``counters()``), kept only
  while a profile is on; ``host_read``: a device-to-host read under the span
  ``eigsol.read``, counted in ``host_reads``; ``host_write``: a host value's
  copy to the device under ``eigsol.write``, counted in ``host_writes``. On
  a card each blocks the host until the device's stream has run dry.

The record holds, for each span in the order they opened, ``Span(name,
start_ns, end_ns, parent, solve, wait)``: times on ``time.time_ns``'s clock
(Unix nanoseconds, as kineto's), ``parent`` the index of the span around it
(None for an outermost one) and ``solve`` the index of its outermost span:
every public solver (the package's, the distributed ones and the
checkpointed power runs) opens the outermost span of its call, so ``solve``
says which solve a span belongs to. The spans are named ``eigsol.*``:

- ``eigsol.<function>``: the entries (``@spanned``), e.g.
  ``eigsol.power_method``, ``eigsol.arnoldi_eigenvalues``,
  ``eigsol.qr_eigenvalues``;
- ``eigsol.read``, ``eigsol.write`` (wait): every ``host_read`` and
  ``host_write``;
- ``eigsol.<loop>.block``: one pass of ``utils/loops.py::run_masked``, the
  read of ``(k, done)`` and the block of iterations it lets run, named by its
  caller (``eigsol.power.block`` for the power loops);
- ``eigsol.arnoldi.spmv``, ``eigsol.arnoldi.orthogonalize``: the two parts of
  an Arnoldi step; ``eigsol.arnoldi.projection``: the m x m solve and its reads;
- ``eigsol.qr.hessenberg``: the Hessenberg reduction (B7 or B11);
  ``eigsol.qr.sweeps`` (wait): one call of B13's or B10's launcher, which
  reads the state after each cooperative launch; ``eigsol.qr.aed_round``: an
  AED round and its sweeps.

Counters: ``host_reads`` (``host_read`` calls, and B13's / B10's reads of
their state, one a cooperative launch), ``host_writes`` (``host_write``
calls), ``gell_split_rows`` and ``gell_split_blocks`` (the long rows and
their chunk blocks of each B6 launch that splits its long rows,
``ops/gell_spmv.py``). A run clears the record with ``reset()``; it keeps at most
``MAX_SPANS`` spans and counts the rest in the counter ``dropped_spans``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 20

_enabled = torch.autograd._profiler_enabled  # True while a torch.profiler profile is on
_OFF = contextlib.nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    solve: int
    wait: bool


class _Record:
    """The spans and counters of the profiled region. Entries are lists
    while open, so that a span's slot (and index) is taken when it opens."""

    def __init__(self):
        self.entries = []
        self.counts = {}
        self.stack = []  # indices of the open spans, None for a dropped one


_RECORD = _Record()


class _Annotation:
    __slots__ = ("name", "wait", "rf", "index")

    def __init__(self, name: str, wait: bool):
        self.name, self.wait = name, wait

    def __enter__(self):
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        rec = _RECORD
        if len(rec.entries) >= MAX_SPANS:
            rec.counts["dropped_spans"] = rec.counts.get("dropped_spans", 0) + 1
            self.index = None
        else:
            self.index = index = len(rec.entries)
            parent = rec.stack[-1] if rec.stack else None
            solve = rec.entries[parent][4] if parent is not None else index
            rec.entries.append([self.name, time.time_ns(), 0, parent, solve, self.wait])
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = _RECORD
        if rec.stack:  # else ``reset()`` ran inside the span
            rec.stack.pop()
            if self.index is not None:
                rec.entries[self.index][2] = end
        self.rf.__exit__(*exc)
        return False


def annotate(name: str, wait: bool = False):
    """The program's span ``name`` around a region (see the module's
    docstring); a shared null context while no profile is on."""
    if not _enabled():
        return _OFF
    return _Annotation(name, wait)


def spanned(fn):
    """Decorator for a public solver: each call runs inside the span
    ``eigsol.<its name>`` (the function's ``span``)."""
    name = f"eigsol.{fn.__name__}"

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)
    call.span = name
    return call


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the record's counter ``name`` while a profile is on."""
    if _enabled():
        _RECORD.counts[name] = _RECORD.counts.get(name, 0) + k


def host_read(t):
    """``t.tolist()``: one blocking read from ``t``'s device, under the span
    ``eigsol.read`` and counted in ``host_reads``; a value that is no tensor
    is on the host already and comes back as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    with annotate("eigsol.read", wait=True):
        count("host_reads")
        return t.tolist()


def host_write(value, device, dtype=None) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``: a host value's
    copy to ``device``, under the span ``eigsol.write`` and counted in
    ``host_writes``. To a card the copy waits for the work queued before it."""
    with annotate("eigsol.write", wait=True):
        count("host_writes")
        return torch.tensor(value, dtype=dtype, device=device)


def spans() -> list:
    """The record's spans, ``Span`` tuples in the order they opened (a span
    still open has ``end_ns`` 0)."""
    return [Span(*e) for e in _RECORD.entries]


def counters() -> dict:
    return dict(_RECORD.counts)


def reset() -> None:
    """Clear the record's spans and counters."""
    _RECORD.entries.clear()
    _RECORD.counts.clear()
    _RECORD.stack.clear()


def readback(x) -> float:
    """Force completion: synchronise ``x``'s device, then pull one scalar
    to the host."""
    x = torch.as_tensor(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(torch.real(x.reshape(-1)[:1]).sum())


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace (host and, where there is a card, device
    activity) around a code region, written to ``log_dir/trace.json``
    (open it in Perfetto or chrome://tracing). The ``eigsol.*`` spans of the
    calls inside it are on its timeline, and in ``spans()`` and
    ``counters()`` afterwards: the record is cleared as the region starts."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
