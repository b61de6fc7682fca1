"""The control of a cell's check: the plain reference put in the program's
place and computed in the precision next below the configuration's (the
cell's ``control``), judged as a run judges the program. It has to come
out as not correct; the benchmark's own runs never run it.

    python3 eigbench/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

For each seed it judges the answers of as many solves as a run's sample
holds (the first solves' inputs; every pool operator once), prints each
compared number beside its limit, and one JSON line per seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell, seed: int, device) -> dict:
    """The widest compared numbers of the control's answers for ``seed``."""
    import torch

    from eigbench import harness, traffic
    cfg, mix = cell.config, cell.mix
    builder = harness.load_plugin("builders", cfg["builder"])
    ref = harness.load_plugin("reference", mix["reference"])
    operator = harness.load_plugin("reference", cfg["builder"])
    n = builder.size(cfg)
    dtype = getattr(torch, cfg["dtype"])
    count = cell.spec["sample"] if traffic.input_kind(mix).FRESH else mix["pool"]
    answers = []
    for index in range(count):
        op_index, inputs = traffic.solve_inputs(mix, seed, index, n, dtype, device)
        raw = builder.raw(cfg, traffic.operator_seed(mix, seed), op_index, device)
        got = ref.solve(lambda v: operator.apply(v, cfg, raw), raw, inputs, mix, n,
                        cell.spec["control"])
        answers.append((index, op_index, {k: (torch.as_tensor(v) if k == "eigenvalues" else v)
                                          for k, v in got.items()}))
    return harness.judge(cell, seed, answers, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from eigbench import harness
    cell = harness.load_cell(args.workload)
    limits = cell.spec["limits"]
    for seed in args.seeds:
        widest = control_numbers(cell, seed, args.device)
        fails = [k for k, lim in limits.items() if not widest.get(k, float("inf")) <= lim]
        for name, lim in limits.items():
            print(f"control {args.workload} seed {seed} {name}: {widest.get(name)} (limit {lim})",
                  file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision":
                          cell.spec["control"], "numbers": widest, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
