"""The Graph 500 cell cut to SCALE 10 (1,024 vertices, ~21k stored entries)
on the CPU, through the same harness, builder, reference and program entry
point as on the card: a sound run is correct, the bfloat16 control and each
planted fault are not. The generator gives a simple symmetric graph, the
same for a ``graph_seed``, whose degrees follow a NumPy transcription of the
specification's ``kronecker_generator.m``. One short run of the full cell
on the card (marked ``cuda``) closes the file."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import pcsc_eigenvalue_solver_project_tpu_torch.matrix.gell as gell_matrix
from eigbench import control, harness, traffic
from eigbench.builders import graph500 as builder
from eigbench.layer_metrics import b6_roofline, graph_basis_ms
from eigbench.reference import graph500 as reference
from eigbench.tests.test_eigbench_faults import alter, half_rows

NAME = "graph500-s26.arnoldi"
SCALE = 10


def cell(scale: int = SCALE) -> harness.Cell:
    c = harness.load_cell(NAME)
    c.config["scale"] = scale
    return c


def run(seed: int = 2**31 + 11):
    return harness.run_cell(cell(), seed, 0.3, False, "cpu", 0.0)


@pytest.mark.parametrize("seed", [12345, 2**31 + 11])
def test_sound_run_is_correct(seed):
    r = run(seed)
    assert r.completed > 0 and r.failed == 0
    assert r.correct is True, r.checks


def test_control_is_not_correct():
    c = cell()
    for seed in (3, 4, 2**32 + 5):
        widest = control.control_numbers(c, seed, "cpu")
        assert any(not widest[k] <= lim for k, lim in c.spec["limits"].items()), (seed, widest)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    matvec = gell_matrix.gell_matvec
    if fault == "state_unchanged":
        monkeypatch.setattr(gell_matrix, "gell_matvec", lambda pack, x: x.clone())
    elif fault == "half_left_out":
        monkeypatch.setattr(gell_matrix, "gell_matvec", lambda pack, x: half_rows(matvec(pack, x)))
    else:
        alter(monkeypatch, "arnoldi_eigenvalues", "eigenvalues")
    r = run()
    assert r.completed > 0
    assert r.correct is False, r.checks


def test_reference_is_the_programs_operator():
    cfg = cell().config
    op = builder.operators(cfg, 0, 1, "cpu")[0]
    raw = builder.raw(cfg, 0, 0, "cpu")
    x = torch.rand(2 ** SCALE, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want = reference.apply(x, cfg, raw)
    got = op.matvec(x.float()).double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    assert op.nnz == raw[0].numel() and op.pack.values.dtype == torch.float32
    # the pack sorted the scrambled list it was given
    assert bool((raw[0][1:] < raw[0][:-1]).any())


@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_reference_agrees_with_the_program(seed):
    c = cell()
    n = builder.size(c.config)
    op = builder.operators(c.config, seed, 1, "cpu")[0]
    solve = harness.solver(c.mix, n)
    ref = harness.load_plugin("reference", c.mix["reference"])
    answers = []
    for index in range(3):
        op_index, inputs = traffic.solve_inputs(c.mix, seed, index, n, torch.float32, "cpu")
        answers.append((index, op_index, ref.answer(solve(op, inputs))))
    widest = harness.judge(c, seed, answers, "cpu")
    assert widest["ritz_gap"] <= c.spec["limits"]["ritz_gap"], widest


def test_generator_gives_a_simple_symmetric_graph():
    cfg = cell().config
    n = builder.size(cfg)
    row, col = builder.coo(cfg, "cpu")
    assert row.dtype == col.dtype == torch.int32
    key = row.long() * n + col.long()
    assert key.unique().numel() == key.numel()                 # no repeated entry
    assert not bool((row == col).any())                        # no self-loop
    mirror = col.long() * n + row.long()
    assert torch.equal(key.sort().values, mirror.sort().values)  # symmetric
    again = builder.coo(cfg, "cpu")
    assert torch.equal(row, again[0]) and torch.equal(col, again[1])
    other = builder.coo(dict(cfg, graph_seed=cfg["graph_seed"] + 1), "cpu")
    assert not torch.equal(key.sort().values, (other[0].long() * n + other[1].long()).sort().values)


def numpy_kronecker(scale, edgefactor, abc, rng):
    """``kronecker_generator.m`` line by line, 0-based: the edge list (2, M)."""
    n, m = 2 ** scale, edgefactor * 2 ** scale
    a, b, c = abc
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    ij = np.zeros((2, m), np.int64)
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > (c_norm * ii_bit + a_norm * ~ii_bit)
        ij += (1 << ib) * np.stack([ii_bit, jj_bit])
    ij = rng.permutation(n)[ij]
    return ij[:, rng.permutation(m)]


def simple_degrees(u, v, n):
    keep = u != v
    pairs = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    return np.bincount(np.concatenate([pairs // n, pairs % n]), minlength=n)


def test_degrees_follow_the_specifications_generator():
    # at SCALE 12 the top degrees of three NumPy draws lie within 4% of the
    # generator's here (705-728 and 1316 against 705-745 and 1306-1319): a factor
    # 1.1 on each of the top ten, 1% on the entries, 0.02 on the isolated share
    cfg = cell(12).config
    n = builder.size(cfg)
    row, _ = builder.coo(cfg, "cpu")
    got = np.bincount(row.numpy(), minlength=n)
    want = simple_degrees(*numpy_kronecker(12, cfg["edgefactor"], cfg["abc"],
                                           np.random.default_rng(0)), n)
    top_got, top_want = np.sort(got)[-10:], np.sort(want)[-10:]
    assert np.all(top_got <= 1.1 * top_want) and np.all(top_want <= 1.1 * top_got), (top_got,
                                                                                     top_want)
    assert abs(got.sum() / want.sum() - 1) < 0.01
    assert abs((got == 0).mean() - (want == 0).mean()) < 0.02


def test_stored_entries_are_checked_at_scale_26():
    cfg = cell().config
    builder.check_entries(cfg, 123)  # another scale: not checked
    builder.check_entries(dict(cfg, scale=26), cfg["stored_entries"])
    with pytest.raises(RuntimeError, match="stored entries"):
        builder.check_entries(dict(cfg, scale=26), cfg["stored_entries"] + 1)
    assert cfg["stored_entries"] < 2 ** 31 - 1


class FakeTrace:
    def __init__(self, kernels):
        self.kernels = kernels

    def device_s(self, match=None):
        return sum(e - s for name, s, e in self.kernels if match is None or match(name)) / 1e9

    def count(self, match):
        return sum(1 for name, _, _ in self.kernels if match(name))


class FakeRun:
    def __init__(self, config, trace, completed):
        self.config, self.trace, self.completed = config, trace, completed


def test_layer_readers():
    cfg = harness.load_cell(NAME).config
    ms = 1_000_000
    kernels = [("gell_real_kernel<float, float, 32>", 0, 20 * ms),
               ("gell_real_kernel<float, float, 32>", 30 * ms, 50 * ms),
               ("qr_eig_kernel<float2>", 60 * ms, 61 * ms),
               ("dot_kernel<float>", 70 * ms, 75 * ms)]
    r = FakeRun(cfg, FakeTrace(kernels), completed=1)
    least = b6_roofline.least_s(cfg)
    assert b6_roofline.read(r) == pytest.approx(100 * least / 0.020)  # two calls, 40 ms
    assert graph_basis_ms.read(r) == pytest.approx(5.0)
    no_b6 = FakeRun(cfg, FakeTrace(kernels[2:]), completed=1)
    assert b6_roofline.read(no_b6) is None
    assert b6_roofline.read(FakeRun(cfg, None, completed=1)) is None


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "eigbench/run.py", "--workload", NAME, "--seed",
                          "2147483677", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
