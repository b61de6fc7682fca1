"""The result line, the no-JAX check and the layout of BENCHMARK.json."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from eigbench import guard, harness
from eigbench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "pcsc_eigenvalue_solver_project_tpu_torch"


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    cell, run = tiny.run("hpcg27-256.power", trace=trace)
    line = harness.result_line(cell, run, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == keys
    assert json.loads(json.dumps(line)) == line
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["correct"] is True
    assert set(line["checks"]) == set(cell.spec["limits"])


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax.numpy", "jaxtyping", f"{PORT}.ops.dia_spmv", "pcsc_eigenvalue_solver_project_tpu",
             "flax.linen", "jaxlib", "numpy", "pcsc_eigenvalue_solver_project_tpu_tools"]
    assert guard.forbidden(names) == ["flax", "jax", "jaxlib", "pcsc_eigenvalue_solver_project_tpu"]
    assert guard.forbidden([PORT, "torch"]) == []


def imported_top_levels(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax_and_references_import_no_port():
    for folder, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(folder, f)
                tops = set(imported_top_levels(path))
                assert not guard.forbidden(tops), path
                if os.path.basename(folder) == "reference":
                    assert PORT not in tops, path


def test_benchmark_json_names_files_for_every_entry():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["name"] == f"{w['config']}.{w['traffic']}"
        cell = harness.load_cell(w["name"])
        assert harness.load_plugin("builders", cell.config["builder"])
        assert harness.load_plugin("reference", cell.mix["reference"])
        assert harness.load_plugin("reference", cell.config["builder"])
        assert cell.end_to_end and cell.per_layer
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
    for kind, metrics in (("end_to_end", bench["end_to_end"]), ("layer_metrics", bench["per_layer"])):
        for m in metrics:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert set(m.get("workloads", cells)) <= cells
            assert callable(harness.load_plugin(kind, m["name"]).read)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] == "solve_s" for m in bench["per_layer"])


def test_run_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the exit without one")
    out = subprocess.run([sys.executable, "eigbench/run.py", "--workload", "hpcg27-256.power",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
