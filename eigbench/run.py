"""Run one benchmark cell once, on the card.

    python3 eigbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``. With ``--trace 0`` the run prints the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profile of the
window. The last line of standard output is one JSON object; each number
the check compared is printed beside its limit as the last lines of
standard error and under ``checks`` in that line. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
in this process, the run exits with a code other than 0 and prints no
result.
"""

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock: its age from
    ``/proc`` taken off the clock, or the top of this file where there is
    no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return T_TOP
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, time.perf_counter() - T_TOP)


def main(argv=None) -> int:
    t0 = process_start()
    phases = {"python": T_TOP - t0}
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import numpy
    import torch
    phases["torch"] = time.perf_counter() - t0

    from eigbench import guard, harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("eigbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"eigbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    phases["cuda"] = time.perf_counter() - t0
    trace = bool(args.trace)
    run = harness.run_cell(cell, args.seed, args.seconds, trace, "cuda", t0, phases)
    line = harness.result_line(cell, run, trace)
    found = guard.forbidden(list(sys.modules))
    if found:
        print(f"eigbench: this process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    phases = ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
    print(f"eigbench: {run.completed} solves in {run.window_s:.3f} s, set-up "
          f"{run.setup_s:.3f} s (s since the start, at: {phases}), reference "
          f"{run.reference_s:.1f} s", file=sys.stderr)
    if run.solve_times:
        marks = (50, 90, 95, 99, 100)
        tail = numpy.percentile(run.solve_times, marks)
        print("eigbench: solve s at percentiles " + ", ".join(
            f"{m} {t:.6f}" for m, t in zip(marks, tail)), file=sys.stderr)
    for text in harness.check_lines(run):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
