"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the numbers of the result line.

Everything that belongs to one configuration, mix, cell or metric is found
by name under this folder:

- ``configs/<config>.json``: the sizes, and the ``builder`` that makes them;
- ``builders/<builder>.py``: the program's operators, made on the device;
- ``mixes/<mix>.json``: the solver call, its options and its kind of
  input, read by the one generator, ``traffic.py``;
- ``inputs/<kind>.py``: what a solve of that kind gets besides the
  operator, as keyword arguments of the call;
- ``cells/<config>.<mix>.json``: the check's sample, its limits and the
  control's precision, and how many solves the traced run profiles;
- ``reference/<builder>.py`` and ``reference/<reference>.py``: the plain
  operator and solver the program is judged against;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: the readers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import sys
import time
import traceback

from eigbench import traffic
from eigbench.plugins import load_plugin

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    spec: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name=name, chips=workload["chips"],
                config=load_json(os.path.join(root, entry["file"])),
                mix=load_json(os.path.join(HERE, "mixes", f"{workload['traffic']}.json")),
                spec=load_json(os.path.join(HERE, "cells", f"{name}.json")),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take it."""

    config: dict
    setup_s: float
    window_s: float
    solve_times: list
    attempted: int
    failed: int
    iterations: list
    peak_bytes: int
    device: dict
    trace: object = None
    checks: dict = dataclasses.field(default_factory=dict)
    correct: bool = False
    reference_s: float = 0.0
    setup_phases: dict = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> int:
        return len(self.solve_times)


def options(port, spec: dict, n: int):
    """The mix's options object; ``{"per_row": c}`` stands for ``c * n``."""
    fields = {k: (v["per_row"] * n if isinstance(v, dict) else v)
              for k, v in spec.items() if k != "class"}
    return getattr(port, spec["class"])(**fields)


def solver(mix: dict, n: int):
    """``solve(operator, inputs)``: the mix's call into the program's public
    API, with a solve's own keyword arguments ``inputs``."""
    import pcsc_eigenvalue_solver_project_tpu_torch as port
    opts = options(port, mix["options"], n)

    def solve(op, inputs):
        return getattr(port, mix["call"])(op, **mix["kwargs"], opts=opts, **inputs)

    return solve


def fingerprint(answer: dict) -> str:
    """A digest of an answer's values, so that equal answers are judged once."""
    import torch
    h = hashlib.sha1()
    for key in sorted(answer):
        value = answer[key]
        h.update(key.encode())
        if hasattr(value, "detach"):  # widened losslessly: numpy has no bfloat16
            wide = torch.complex128 if value.is_complex() else torch.float64
            h.update(value.detach().to("cpu", wide).numpy().tobytes())
        else:
            h.update(repr(value).encode())
    return h.hexdigest()


def judge(cell: Cell, seed: int, answers: list, device, precision: str = "float64") -> dict:
    """The widest of each compared number over ``answers``, a list of
    ``(solve index, operator index, program answer)``, against the
    reference computed in ``precision``."""
    import torch
    cfg, mix = cell.config, cell.mix
    builder = load_plugin("builders", cfg["builder"])
    ref = load_plugin("reference", mix["reference"])
    operator = load_plugin("reference", cfg["builder"])
    n = builder.size(cfg)
    dtype = getattr(torch, cfg["dtype"])
    fresh = traffic.input_kind(mix).FRESH
    wants, judged, widest = {}, {}, {}
    for index, op_index, got in answers:
        _, inputs = traffic.solve_inputs(mix, seed, index, n, dtype, device)
        key = (op_index, index if fresh else None)
        if key not in wants:
            raw = builder.raw(cfg, traffic.operator_seed(mix, seed), op_index, device)
            wants[key] = ref.solve(lambda v, raw=raw: operator.apply(v, cfg, raw), raw, inputs,
                                   mix, n, precision)
        seen = (key, fingerprint(got))
        if seen not in judged:
            judged[seen] = ref.gaps(got, wants[key])
        for name, value in judged[seen].items():
            widest[name] = max(widest.get(name, value), value)
    return widest


def number(value):
    """A value for the JSON line: non-finite numbers become null."""
    return value if isinstance(value, int) or math.isfinite(value) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             phases: dict | None = None) -> Run:
    """Set up, warm up, measure for ``seconds`` (a pool in whole passes;
    the traced run stops earlier, after the cell's ``trace_solves``), then
    check a sample of the window's answers against the reference. ``t0`` is
    the process's start on ``time.perf_counter``'s clock, and ``phases``
    the seconds since then at which the caller's own steps ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from eigbench import trace as tracing
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg, mix, spec = cell.config, cell.mix, cell.spec
    builder = load_plugin("builders", cfg["builder"])
    n = builder.size(cfg)
    dtype = getattr(torch, cfg["dtype"])
    phases = dict(phases or {})
    phases["start"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with record_function("eigbench.setup"):
        ops = builder.operators(cfg, traffic.operator_seed(mix, seed), mix["pool"], dev)
        solve = solver(mix, n)
        sync()
        phases["operators"] = time.perf_counter() - t0
        op_index, inputs = traffic.solve_inputs(mix, seed, traffic.WARM_UP, n, dtype, dev)
        solve(ops[op_index], inputs)  # builds and loads the kernels, warms this shape
        del inputs
        sync()
    setup_s = time.perf_counter() - t0
    phases["warm_up"] = setup_s

    keep = traffic.Reservoir(spec["sample"], seed)
    times, iterations, failed, result = [], [], 0, None
    limit = spec["trace_solves"] if trace else None
    # A pool is solved in whole passes, so that every run does the same work.
    cycle = 1 if traffic.input_kind(mix).FRESH else mix["pool"]
    prof = None
    if trace:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.start()
    with record_function(tracing.WINDOW_SPAN):
        start = end = time.perf_counter()
        index = 0
        while (end - start < seconds or index % cycle) and (limit is None or index < limit):
            began = time.perf_counter()
            try:
                with record_function("eigbench.solve"):
                    with record_function(tracing.INPUTS_SPAN):
                        op_index, inputs = traffic.solve_inputs(mix, seed, index, n, dtype, dev)
                    result = solve(ops[op_index], inputs)
                with record_function("eigbench.readback"):
                    sync()
            except (RuntimeError, ValueError):
                traceback.print_exc()
                failed = 1
                break
            end = time.perf_counter()
            times.append(end - began)
            iterations.append(result.iterations)
            keep.offer(index, (op_index, result))
            index += 1
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(config=cfg, setup_s=setup_s, window_s=end - start, solve_times=times,
              attempted=index + failed, failed=failed,
              iterations=[int(v) for v in iterations], peak_bytes=int(peak),
              setup_phases=phases,
              device={"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)})
    if prof is not None:
        began = time.perf_counter()
        run.trace = tracing.reduce(prof)
        del prof
        print(f"eigbench: profile reduced in {time.perf_counter() - began:.1f} s; "
              f"{len(run.trace.kernels)} device events of the program, "
              f"{len(run.trace.benchmark)} of the benchmark's inputs", file=sys.stderr)
    ref = load_plugin("reference", mix["reference"])
    answers = [(index, op_index, ref.answer(result)) for index, (op_index, result) in keep.items()]
    del ops, solve, keep, result, iterations
    inputs = None
    if cuda:
        torch.cuda.empty_cache()
    began = time.perf_counter()
    widest = judge(cell, seed, answers, dev) if answers else {}
    run.reference_s = time.perf_counter() - began
    limits = spec["limits"]
    run.checks = {name: {"value": number(widest.get(name, math.inf)), "limit": limits[name]}
                  for name in limits}
    run.correct = (failed == 0 and bool(answers)
                   and all(widest.get(name, math.inf) <= lim for name, lim in limits.items()))
    return run


def metrics(cell: Cell, run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones,
    leaving out those whose reader finds nothing."""
    kind, listed = ("layer_metrics", cell.per_layer) if trace else ("end_to_end", cell.end_to_end)
    out = {}
    for metric in listed:
        value = load_plugin(kind, metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result_line(cell: Cell, run: Run, trace: bool) -> dict:
    """The last line of a run's standard output; ``checks`` comes last."""
    device = dict(run.device)
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics(cell, run, trace), "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown
    line["checks"] = run.checks
    return line


def check_lines(run: Run) -> list:
    """Each compared number beside its limit, for the end of standard error."""
    return [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in run.checks.items()]
